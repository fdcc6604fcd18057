"""The dry run (``repro_torch.launch.dryrun``) and ``collective_bytes``
against ``repro``, on the CPU.

* Argument bytes: every registry cell on both production meshes cut into
  rank 0's fake blocks equals, byte for byte, the reference's
  ``NamedSharding.shard_shape`` bytes over the cell's arguments (the
  reference in a subprocess with 512 placeholder devices, no compile); the
  skip and bonus statuses agree.
* Collective bytes: the port's sharded PBME TC step on a fake 8-rank world
  as a (2, 4) mesh, counted at the dispatcher, against XLA's compiled HLO
  of ``lower_tc_step`` on the 8 CPU devices of ``conftest.py``, per kind, for
  the three schedules.
* The kernel wrappers on fake CUDA tensors: shapes and dtypes, no launch, no
  build; MoE group sizes under fake tensors; the depth extrapolation of a
  prefill against a full trace; the CLI on a fake 256-rank world.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils._pytree import tree_leaves

from repro.core.distributed import lower_tc_step as ref_lower_tc_step
from repro.distributed.compat import make_mesh as ref_make_mesh
from repro.distributed.hlo import collective_bytes as ref_collective_bytes
from repro_torch.configs import registry
from repro_torch.core.distributed import lower_tc_step
from repro_torch.distributed import (
    all_gather, collective_bytes, gather, make_mesh, mesh_context, ppermute, psum,
    psum_scatter, Sharding,
)
from repro_torch.kernels import _build, bitmm as kb, gather_sum as kg
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import layers

ROOT = Path(__file__).resolve().parents[1]
TC_N = 1000                     # padded to 1024 on a (2, 4) mesh


def _fresh_world(size: int):
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun.fake_world(size)


@pytest.fixture
def world8():
    """Rank 0 of a fake world of 8 as a (2, 4) (data, model) mesh."""
    _fresh_world(8)
    try:
        yield make_mesh((2, 4), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


# -- argument bytes ------------------------------------------------------------------

_REF_BYTES = """
import json, math
import jax
from repro.configs import registry
from repro.launch.mesh import make_production_mesh
out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in registry.all_cells():
        cell = registry.build_cell(arch, shape, mesh)
        total = sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
                    for x, sh in zip(jax.tree.leaves(cell.args),
                                     jax.tree.leaves(cell.in_shardings)))
        out[f"{name}|{arch}|{shape}"] = [total, bool(cell.skip), cell.bonus]
print(json.dumps(out))
"""


def _status(skip, bonus) -> str:
    return "skip" if skip and not bonus else ("bonus" if skip else "run")


def test_argument_bytes_match_reference_shard_shapes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    ref = subprocess.run([sys.executable, "-c", _REF_BYTES], capture_output=True, text=True,
                         env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = json.loads(ref.stdout.splitlines()[-1])
    got = {}
    for name, multi in (("single", False), ("multi", True)):
        _fresh_world(512 if multi else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            for arch, shape in registry.all_cells():
                cell = registry.build_cell(arch, shape, mesh)
                blocks = dryrun.fake_blocks(cell.args, cell.in_shardings, FakeTensorMode(),
                                            torch.device("cpu"))
                got[f"{name}|{arch}|{shape}"] = [dryrun.storage_bytes(blocks),
                                                 bool(cell.skip), cell.bonus]
        finally:
            dist.destroy_process_group()
    assert len(got) == len(want) == 80
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}
    assert {k: _status(*v[1:]) for k, v in got.items()} == \
        {k: _status(*v[1:]) for k, v in want.items()}


# -- collective bytes -----------------------------------------------------------------

#: the port's one difference from XLA's count: the termination count is
#: summed as int64 (``core.distributed._count``: n² bits overflow int32 past
#: n = 46341, and gloo has no unsigned sum), the reference's ``psum`` as s32
PORT_MINUS_XLA = {"all-reduce": 4, "total": 4}


@pytest.mark.parametrize("schedule", ["allgather", "rows1d", "psum"])
def test_tc_step_collective_bytes_match_xla(schedule, world8):
    ref_mesh = ref_make_mesh((2, 4), ("data", "model"))
    want = ref_collective_bytes(ref_lower_tc_step(ref_mesh, TC_N, schedule=schedule)
                                .compile().as_text())
    step, args = lower_tc_step(world8, TC_N, schedule=schedule)
    assert all(is_fake(a) for a in args)
    with args[0].fake_mode, collective_bytes() as got:
        step(*args)
    assert set(got) == set(want)
    assert {k: got[k] - want[k] for k in got} == {
        k: PORT_MINUS_XLA.get(k, 0) for k in got}


def test_collective_bytes_counts_every_call_site(world8):
    """Real CPU tensors on the fake world: each collective by its output bytes."""
    model = world8.get_group("model")
    x = torch.ones(6, 5)
    with collective_bytes() as out:
        psum(x, model)                                        # all-reduce 120
        all_gather(x, model, dim=1)                           # all-gather 480
        psum_scatter(torch.ones(8, 5), model)                 # reduce-scatter 40
        ppermute(x, model, [(0, 1), (1, 2), (2, 3), (3, 0)])  # receive 120
        gather({"w": x}, {"w": Sharding(world8, (None, "data"))})   # all-gather 240
        dist.all_to_all_single(torch.empty(8), torch.ones(8), group=model)   # 32
    assert dict(out) == {"all-reduce": 120, "all-gather": 720, "reduce-scatter": 40,
                         "collective-permute": 120, "all-to-all": 32, "total": 1032}
    with collective_bytes() as none:
        dist.send(torch.ones(3), 4)
    assert dict(none) == {}


# -- the kernel wrappers on fake tensors ------------------------------------------------


def test_kernel_wrappers_on_fake_cuda_tensors(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a shapes-only call built a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    before = {k: (k.launches, k.fake_calls) for k in (kb.bitmm, kb.bitmm_fused_delta,
                                                     kg.gather_sum)}
    with FakeTensorMode():
        a = torch.empty((300, 20), dtype=torch.int32, device="cuda")
        b = torch.empty((640, 9), dtype=torch.int32, device="cuda")
        m = torch.empty((300, 9), dtype=torch.int32, device="cuda")
        c = kb.bitmm(a, b)
        d, m2 = kb.bitmm_fused_delta(a, b, m)
        idx = torch.empty((512, 7), dtype=torch.int32, device="cuda")
        table = torch.empty((1000, 64), dtype=torch.bfloat16, device="cuda")
        bags = kg.gather_sum(idx, table)
        live = dryrun.StepTally([a, b])
        with live:
            kept = kb.bitmm(a, b)
    for out, shape, dtype in ((c, (300, 9), torch.int32), (d, (300, 9), torch.int32),
                              (m2, (300, 9), torch.int32), (bags, (512, 64), torch.bfloat16)):
        assert is_fake(out) and out.device.type == "cuda"
        assert tuple(out.shape) == shape and out.dtype == dtype
    # the kernel's scratch beside its output, freed on return
    assert live.live - live.peak + kb.workspace_bytes(300, 20, 9) == 0
    assert live.live == 4 * (a.numel() + b.numel() + kept.numel())
    for k, (launches, calls) in before.items():
        assert k.launches == launches
        assert k.fake_calls == calls + (2 if k is kb.bitmm else 1)
    assert kb._lib.cache_info().currsize == 0 and kg._lib.cache_info().currsize == 0
    # a real CPU tensor still takes the plain version
    cpu = kb.bitmm(torch.zeros((4, 1), dtype=torch.int32), torch.zeros((32, 1), dtype=torch.int32))
    assert not is_fake(cpu) and kb.bitmm.fake_calls == before[kb.bitmm][1] + 2


# -- MoE group sizes -------------------------------------------------------------------


@pytest.mark.parametrize("rows,groups", [(64, 8), (70, 8), (5, 8), (4096 * 8, 40)])
def test_moe_group_sizes_under_fake_tensors_split_t_times_k(rows, groups):
    with FakeTensorMode():
        counts = torch.empty(groups + 1, dtype=torch.int64)
    sizes = layers._host_sizes(counts, rows, groups)
    assert len(sizes) == groups and sum(sizes) == rows
    assert max(sizes) - min(sizes) <= 1
    real = torch.tensor([3, 0, 5, 9])
    assert layers._host_sizes(real, 17, 3) == [3, 0, 5]


def _smoke(monkeypatch):
    """The registry's LM cells at SMOKE widths, four layers, short sequences,
    the chunked attention on small blocks (4 x 2 block pairs)."""
    import dataclasses

    orig = registry.arch_config
    monkeypatch.setattr(registry, "arch_config", lambda a, smoke=False: (
        dataclasses.replace(orig(a, True), n_layers=orig(a, True).n_dense_prefix + 4)
        if a in registry.LM_ARCHS else orig(a, smoke)))
    for shape, step in (("prefill_32k", "prefill"), ("train_4k", "train"),
                        ("decode_32k", "decode")):
        monkeypatch.setitem(registry._LM_SHAPE_DEFS, shape, dict(seq=128, batch=4, step=step))
    monkeypatch.setattr(layers, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(layers._sdpa_chunked, "__defaults__", (32, 64))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "granite-moe-1b-a400m"])
def test_moe_group_sizes_sum_to_t_times_k_in_a_traced_step(arch, world8, monkeypatch):
    """Every grouped product of a traced train step gets T·k rows (the
    expert-parallel form's local experts included)."""
    _smoke(monkeypatch)
    seen = []
    real = layers._grouped_matmul
    monkeypatch.setattr(layers, "_grouped_matmul",
                        lambda xs, w, sizes: seen.append((xs.shape[0], sizes)) or real(xs, w, sizes))
    rec = dryrun.run_cell(arch, "train_4k", world8, "2x4")
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = registry.arch_config(arch)
    assert seen
    # a data block of 4/2 sequences of 128 tokens, top-k choices each
    assert all(rows == sum(sizes) == 2 * 128 * cfg.top_k for rows, sizes in seen)
    assert all(len(sizes) == cfg.n_experts // 4 for _, sizes in seen)


# -- depth extrapolation and the decode cell ----------------------------------------------


@pytest.mark.parametrize("arch", list(registry.LM_ARCHS))
def test_prefill_extrapolated_in_depth_equals_a_full_trace(arch, world8, monkeypatch):
    _smoke(monkeypatch)
    rec = dryrun.run_cell(arch, "prefill_32k", world8, "2x4")
    assert rec["status"] == "ok" and rec["depths_traced"] == [2, 3], rec.get("traceback")
    cell = registry.build_cell(arch, "prefill_32k", world8)
    fake = FakeTensorMode()
    full = dryrun.trace(cell.fn, dryrun.fake_blocks(cell.args, cell.in_shardings, fake,
                                                    torch.device("cpu")), fake, world8)
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                "flops", "collectives"):
        assert rec[key] == full[key], key


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_cell_keeps_batch_blocks_at_dp_above_one(shape, world8, monkeypatch):
    """The decode cell gathers the cache's sequence blocks only: its batch
    blocks stay with this rank's tokens."""
    _smoke(monkeypatch)
    monkeypatch.setitem(registry._LM_SHAPE_DEFS, "long_500k",
                        dict(seq=512, batch=1, step="decode"))
    cell = registry.build_cell("qwen2-7b", shape, world8)
    fake = FakeTensorMode()
    blocks = dryrun.fake_blocks(cell.args, cell.in_shardings, fake, torch.device("cpu"))
    with fake:
        logits, cache = cell.fn(*blocks)
    cfg = registry.arch_config("qwen2-7b")
    assert tuple(logits.shape) == (blocks[2].shape[0], cfg.vocab)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in blocks[1].items()}


# -- the CLI ---------------------------------------------------------------------------


def test_cli_traces_cells_on_a_fake_world_and_resumes(tmp_path):
    out = tmp_path / "dryrun.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
             "--device", "cpu", "--out", str(out), *args],
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout

    first = cli("--arch", "gcn-cora", "--shape", "full_graph_sm")
    second = cli("--arch", "two-tower-retrieval", "--shape", "serve_p99")
    assert "[dryrun] single-pod-16x16 gcn-cora × full_graph_sm ..." in first
    assert "[dryrun] done: 2 ok, 0 skip, 0 FAIL" in second
    recs = json.loads(out.read_text())
    assert set(recs) == {"single-pod-16x16|gcn-cora|full_graph_sm",
                         "single-pod-16x16|two-tower-retrieval|serve_p99"}
    for rec in recs.values():
        assert rec["status"] == "ok" and rec["devices"] == 256
        assert rec["argument_size_in_bytes"] > 0 and rec["temp_size_in_bytes"] >= 0
        assert rec["collectives"]["total"] == sum(
            v for k, v in rec["collectives"].items() if k != "total") > 0
        assert rec["flops"] > 0 and rec["model_flops"] > 0
    gcn = recs["single-pod-16x16|gcn-cora|full_graph_sm"]
    assert gcn["step"] == "train" and gcn["kernel_calls"] == {}
    # resumed: both cells done, nothing traced again
    again = cli("--shape", "serve_p99")
    assert "two-tower-retrieval × serve_p99" not in again
    assert "datalog-tc-pbme × g80k ..." in again
    assert "[dryrun] done: 3 ok, 0 skip, 0 FAIL" in again
    tc = json.loads(out.read_text())["single-pod-16x16|datalog-tc-pbme|g80k"]
    assert tc["status"] == "ok" and tc["model_flops"] == 2.0 * 81920 ** 3 / 32
    assert set(tc["collectives"]) == {"all-gather", "all-reduce", "total"}


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="runs on CUDA by default"):
        dryrun.main(["--mesh", "single", "--arch", "gcn-cora", "--shape", "full_graph_sm",
                     "--out", str(tmp_path / "x.json")])
    assert not dist.is_initialized()
