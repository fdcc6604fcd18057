"""The port on the card: CUDA kernels against their plain versions, the
engine on CUDA against the engine on the CPU bit for bit, and the two-tower
model and the transformer LMs on CUDA against the same models on the CPU.

Imports neither JAX nor ``repro``, so it runs on a machine that has only
PyTorch with CUDA::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips itself where ``torch.cuda.is_available()`` is false.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import registry as lm_registry
from repro_torch.configs.datalog_workloads import ALL
from repro_torch.core import Engine, EngineConfig
from repro_torch.data.graphs import random_graph
from repro_torch.configs.two_tower_retrieval import SMOKE
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.kernels import bitmm as kb
from repro_torch.kernels import bitpack as kp
from repro_torch.kernels import dense_agg as kd
from repro_torch.kernels import gather_sum as kg
from repro_torch.kernels.ref import (
    bitmm_fused_delta_plain, bitmm_plain, dense_agg_update_plain, edges_to_bitmatrix_plain,
    gather_sum_plain, pack_bits,
)
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import TwoTower
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance, PlanCache
from repro_torch.train.serve import generate

pytestmark = pytest.mark.cuda

# the kernel's tiles are 128 rows x 256 columns x 1024-bit K stages: these
# shapes are multiples of none of them, or one more than a multiple
SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97), (1, 1, 1), (300, 1000, 4100),
          (129, 257, 8193)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape):
    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    for density in (0.0, 0.02, 0.3, 1.0):
        a = pack_bits(torch.rand((m, k), generator=gen, device=cuda) < density)
        b = pack_bits(torch.rand((k, n), generator=gen, device=cuda) < density)
        cur = pack_bits(torch.rand((m, n), generator=gen, device=cuda) < 0.05)
        before = (kb.bitmm.launches, kb.bitmm_fused_delta.launches)
        assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
        for got, want in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
            assert torch.equal(got, want)
        assert (kb.bitmm.launches, kb.bitmm_fused_delta.launches) == (
            before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()


def _both_match_plain(a, b, cur):
    assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
    for got, want in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
        assert torch.equal(got, want)


def _mixed_density(cuda):
    """Row blocks whose 1024-bit K stages are empty, sparse and dense side by
    side, so one launch skips, walks and runs the MMA; row block 2, with no
    MMA stage, goes to the light walk kernel."""
    rows, k = 300, 4 * 1024 + 40
    density = torch.zeros((rows, k), device=cuda)
    density[:, 1024:2048] = 2e-4                  # stage 1: a few bits, walked
    density[:, 2048:3072] = 0.5                   # stage 2: dense, MMA
    density[128:256, 3072:] = 0.02                # stages 3-4 of row block 1 only
    density[256:, :] = 0.0                        # row block 2: empty
    density[256:, 4095] = 1.0                     # but for one column
    return density


def _list_full_density(cuda):
    """20 stages of about 480 set bits each per 128-row block: each is walked
    (fewer than 512) until the row block's list of 8192 entries is full after
    17, and the stages that no longer fit run on the MMA."""
    return torch.full((300, 20 * 1024), 480 / (128 * 1024), device=cuda)


@pytest.mark.parametrize("density", [_mixed_density, _list_full_density],
                         ids=["mixed", "list_full"])
def test_skip_walk_and_mma_stages_in_one_launch(cuda, density):
    gen = torch.Generator(device=cuda).manual_seed(7)
    dens = density(cuda)
    rows, k, n = dens.shape[0], dens.shape[1], 700
    a = pack_bits(torch.rand((rows, k), generator=gen, device=cuda) < dens)
    b = pack_bits(torch.rand((k, n), generator=gen, device=cuda) < 0.05)
    cur = pack_bits(torch.rand((rows, n), generator=gen, device=cuda) < 0.05)
    _both_match_plain(a, b, cur)
    torch.cuda.synchronize()


def test_bitmm_on_a_second_device(cuda):
    """The MMA kernel's shared-memory limit is set per device: after launches
    on cuda:0, launches on cuda:1 must run and agree too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        gen = torch.Generator(device=dev).manual_seed(3)
        a = pack_bits(torch.rand((300, 2100), generator=gen, device=dev) < 0.5)
        b = pack_bits(torch.rand((2100, 700), generator=gen, device=dev) < 0.05)
        cur = pack_bits(torch.rand((300, 700), generator=gen, device=dev) < 0.05)
        _both_match_plain(a, b, cur)
        torch.cuda.synchronize(dev)


def test_bit_31_of_every_word(cuda):
    """Only bit 31 of each word set in A, B and M: the sign bit of int32."""
    rows, k, n = 200, 33 * 32, 300
    a = torch.full((rows, k // 32), -(2**31), dtype=torch.int32, device=cuda)
    b = torch.full((k, (n + 31) // 32), -(2**31), dtype=torch.int32, device=cuda)
    cur = torch.full((rows, b.shape[1]), -(2**31), dtype=torch.int32, device=cuda)
    cur[::2] = 0
    _both_match_plain(a, b, cur)
    assert bool((kb.bitmm(a, b) == -(2**31)).all())
    torch.cuda.synchronize()


# the serving increments' shapes: M frontier rows against an n x n matrix
# (a partial 128-row block, fewer rows than one block, one row), and the
# sandwich product's K = k (off the 32-bit word and the 1024-bit stage)
SERVE_N = 3000


@pytest.mark.parametrize("m_rows", [1, 7, 128, 129, 1000])
def test_bitmm_at_frontier_rows(cuda, m_rows):
    gen = torch.Generator(device=cuda).manual_seed(m_rows)
    b = pack_bits(torch.rand((SERVE_N, SERVE_N), generator=gen, device=cuda) < 0.001)
    for density in (0.0005, 0.02, 0.5):
        a = pack_bits(torch.rand((m_rows, SERVE_N), generator=gen, device=cuda) < density)
        assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("k_rows", [1, 31, 33, 1024, SERVE_N])
def test_bitmm_at_sandwich_depths(cuda, k_rows):
    gen = torch.Generator(device=cuda).manual_seed(k_rows)
    for a_density, b_density in ((0.001, 0.3), (0.5, 0.02)):
        a = pack_bits(torch.rand((SERVE_N, k_rows), generator=gen, device=cuda) < a_density)
        b = pack_bits(torch.rand((k_rows, SERVE_N), generator=gen, device=cuda) < b_density)
        assert torch.equal(kb.bitmm(a, b), bitmm_plain(a, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["tc", "sg"])
def test_apply_txn_on_cuda_matches_cpu(cuda, name):
    """One insert through the PBME increments on the card equals the same
    transaction on the CPU: stats, epochs and every relation."""
    edges = random_graph(400, 900, seed=3)
    base, held = np.concatenate([edges[:100], edges[109:]]), edges[100:109]
    insts = {
        dev: MaterializedInstance(ALL[name].program, {"arc": base}, EngineConfig(),
                                  cache=PlanCache(), device=dev)
        for dev in ("cuda", "cpu")
    }
    launches = kb.bitmm.launches
    stats = {dev: inst.apply_txn([("insert", "arc", held)]) for dev, inst in insts.items()}
    assert kb.bitmm.launches > launches
    got, want = stats["cuda"], stats["cpu"]
    assert got.modes == want.modes == {0: "bitmatrix"}
    assert (got.iterations, got.derived, got.epoch) == (want.iterations, want.derived, want.epoch)
    for rel in (name, "arc"):
        np.testing.assert_array_equal(insts["cuda"].relation(rel), insts["cpu"].relation(rel))
    assert insts["cuda"].query(name, src=5).tolist() == insts["cpu"].query(name, src=5).tolist()


def test_on_demand_tc_query_on_cuda_matches_the_full_selection(cuda):
    """``on_demand=True`` point queries on the card: the magic-set slice runs
    on the base's device and equals the selection over the full fixpoint,
    before and after a write to the base makes the slice stale."""
    edges = random_graph(400, 900, seed=5)
    inst = MaterializedInstance(ALL["tc"].program, {"arc": edges[:-9]}, EngineConfig(),
                                cache=PlanCache(), device=cuda)
    srv = DatalogServer(inst)

    def check(src):
        rid = srv.submit_query("tc", src=src, on_demand=True)
        got = srv.run()[rid]
        full = inst.relation("tc")
        np.testing.assert_array_equal(got, full[full[:, 0] == src])

    for src in (int(edges[0, 0]), int(edges[1, 0]), 7):
        check(src)
    srv.submit_txn([("insert", "arc", edges[-9:])])
    srv.run()
    check(int(edges[0, 0]))
    m = srv.metrics()
    assert (m["datalog_demand_misses_total"], m["datalog_demand_fallbacks_total"]) == (2, 0)
    (dinst,) = [e["instance"] for e in srv._demand_instances.values()]
    assert dinst.device.type == "cuda"


@pytest.mark.parametrize("name", ["tc", "sg", "cspa", "sssp"])
def test_engine_on_cuda_matches_cpu(cuda, name):
    edges = random_graph(60, 200, seed=4, weights=name == "sssp")
    edb = {"arc": edges}
    if name == "sssp":
        edb["id"] = np.array([[int(edges[0, 0])]], np.int32)
    if name == "cspa":
        edb = {"assign": edges[:120], "dereference": edges[120:]}
    outs = [Engine(EngineConfig(), device=d).run(ALL[name].program, edb) for d in (cuda, "cpu")]
    assert outs[0].keys() == outs[1].keys()
    for rel in outs[0]:
        np.testing.assert_array_equal(outs[0][rel], outs[1][rel])


# (B, K, N, D): test_gather_sum_sweep's shapes, then D off the 16-byte vector
# width (the scalar path), a bag longer than a warp, and whole tiles of 128 bags
GATHER_SHAPES = [(8, 3, 20, 128), (16, 7, 50, 256), (4, 1, 5, 384), (9, 5, 30, 99),
                 (5, 40, 64, 36), (70_000, 8, 1000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gather_sum_matches_plain(cuda, dtype, shape):
    b, k, n, d = shape
    rng = np.random.default_rng(b + k)
    idx = torch.as_tensor(rng.integers(-1, n, size=(b, k)).astype(np.int32), device=cuda)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=cuda).to(dtype)
    before = kg.gather_sum.launches
    got = kg.gather_sum(idx, x)
    assert kg.gather_sum.launches == before + 1
    want = gather_sum_plain(idx, x)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gather_sum_unaligned_rows_and_out_of_range_ids(cuda, dtype):
    """x starting one element past a 16-byte boundary takes the scalar path;
    a bag holding an id ≥ N is NaN and reads no row."""
    rng = np.random.default_rng(0)
    flat = torch.as_tensor(rng.standard_normal(1 + 40 * 64).astype(np.float32), device=cuda)
    x = flat.to(dtype)[1:].view(40, 64)
    idx = torch.as_tensor(rng.integers(-1, 40, size=(12, 6)).astype(np.int32), device=cuda)
    idx[3, 2] = 40
    idx[7, 0] = 2**31 - 1
    got, want = kg.gather_sum(idx, x), gather_sum_plain(idx, x)
    assert got[[3, 7]].isnan().all() and not got[[0, 1, 2, 4, 5, 6]].isnan().any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, equal_nan=True)


def _repeat_heavy(kind, rng):
    """(idx, n, d) of ids that repeat rows within the kernel's tiles."""
    if kind == "one_id":                     # one row everywhere; D off the vector: plain stage
        idx = np.full((3001, 8), 7, dtype=np.int32)
        idx[::5, 3] = -1
        return idx, 50, 99
    if kind == "nan_among_repeats":          # a bag with an id past the table among repeats
        idx = np.full((3001, 8), 7, dtype=np.int32)
        idx[17, 2] = 50
        return idx, 50, 256
    if kind == "over_stage":                 # whole tiles of 128 bags drawing from 200 rows:
        # more repeated rows than the stage's 32, rows wider than it (column slices)
        return rng.integers(0, 200, size=(40_001, 8)).astype(np.int32), 300, 1024
    # a Zipf(1) batch folded as the two-tower model folds its fields, 3 x 40,002 + 1
    # bags: no multiple of a tile
    p = 1.0 / np.arange(1, 5001)
    idx = rng.choice(5000, size=(120_007, 8), p=p / p.sum()).astype(np.int32)
    idx[rng.random(idx.shape) < 0.1] = -1
    return idx, 5000, 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["one_id", "nan_among_repeats", "over_stage", "zipf_ragged"])
def test_gather_sum_repeat_heavy_matches_plain(cuda, dtype, kind):
    """Rows that repeat within a tile are summed from the shared-memory stage."""
    rng = np.random.default_rng(1)
    idx_np, n, d = _repeat_heavy(kind, rng)
    idx = torch.as_tensor(idx_np, device=cuda)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=cuda).to(dtype)
    before = kg.gather_sum.launches
    got = kg.gather_sum(idx, x)
    assert kg.gather_sum.launches == before + 1
    want = gather_sum_plain(idx, x)
    assert torch.equal(got.isnan().all(dim=1), (idx >= n).any(dim=1))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, equal_nan=True)
    torch.cuda.synchronize()


def test_two_tower_on_cuda_matches_cpu(cuda):
    model = TwoTower(SMOKE, torch.Generator().manual_seed(1), device="cpu")
    gpu = TwoTower(SMOKE, device=cuda)
    gpu.load_state_dict(model.state_dict())
    stream = RecsysStream(SMOKE.user_vocab, SMOKE.item_vocab, SMOKE.user_fields,
                          SMOKE.item_fields, SMOKE.field_hots, SMOKE.n_dense_feat, batch=64)
    batch = stream.batch(0)
    cpu_b = {k: torch.as_tensor(v) for k, v in batch.items()}
    gpu_b = {k: v.to(cuda) for k, v in cpu_b.items()}
    before = kg.gather_sum.launches
    got = gpu.serve_scores(gpu_b)
    assert kg.gather_sum.launches == before + 2          # one per table, every field at once
    torch.testing.assert_close(got.cpu(), model.serve_scores(cpu_b), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# durability on the card
# --------------------------------------------------------------------------


def _same_relations(a, b, rels):
    for rel in rels:
        np.testing.assert_array_equal(a.relation(rel), b.relation(rel), err_msg=rel)


def test_checkpoint_waits_for_the_writer_stream(cuda, tmp_path, monkeypatch):
    """A checkpoint pinned while the writer's stream is still busy with the
    epoch it pinned copies that epoch, not the buffers half-written.

    The wrapped transaction leaves its tables and closure matrix filled with
    -7 on the writer's stream, sleeps, then restores them, all after the
    host has published: only a checkpoint that waits on the epoch's ready
    event reads the right words."""
    from repro_torch.core.relation import TupleRelation
    from repro_torch.persist import DurabilityConfig, DurabilityManager, latest_valid_snapshot

    edges = random_graph(300, 700, seed=5)
    base, held = edges[:-40], edges[-40:]
    gpu = MaterializedInstance(ALL["tc"].program, {"arc": base}, cache=PlanCache(), device=cuda)
    cpu = MaterializedInstance(ALL["tc"].program, {"arc": base}, cache=PlanCache(), device="cpu")
    mgr = DurabilityManager(DurabilityConfig(str(tmp_path), checkpoint_every_epochs=0,
                                             checkpoint_wal_bytes=0))
    mgr.checkpoint(gpu)                                   # the baseline
    real = gpu._transactional

    def busy(stats, apply_fn):
        def fn(txn):
            out = apply_fn(txn)
            bufs = [h.rows for h in txn.store.values() if isinstance(h, TupleRelation)]
            bufs += [st.m for st in txn.bm.values()]
            saved = [t.clone() for t in bufs]
            for t in bufs:
                t.fill_(-7)
            torch.cuda._sleep(500_000_000)                # about a quarter second
            for t, s in zip(bufs, saved):
                t.copy_(s)
            return out
        return real(stats, fn)

    monkeypatch.setattr(gpu, "_transactional", busy)
    gpu.apply_txn([("insert", "arc", held)])             # returns while the card sleeps
    path = mgr.checkpoint(gpu)
    cpu.apply_txn([("insert", "arc", held)])
    snap = latest_valid_snapshot(str(tmp_path), device="cpu")
    assert snap.path == path and snap.epoch == gpu.epoch == 1
    for rel in ("arc", "tc"):
        np.testing.assert_array_equal(snap.handles[rel].to_numpy(), cpu.relation(rel))
    assert torch.equal(snap.bitmatrix[0]["m"], cpu._bm[0].m)
    mgr.close()


def test_restore_on_the_card_feeds_bitmm_from_uint32_files(cuda, tmp_path):
    """A root written on the CPU (packed words in uint32 files, bit 31 set)
    restores on the card; the WAL tail's insert runs ``bitmm`` and its
    delete ``bitmm_fused_delta`` on those matrices, bit for bit the CPU's."""
    from repro_torch.persist import list_snapshots
    from repro_torch.serve_datalog import DatalogServer

    edges = random_graph(90, 260, seed=6)
    live = MaterializedInstance(ALL["tc"].program, {"arc": edges[:-12]}, cache=PlanCache(),
                                device="cpu")
    srv = DatalogServer(live, durability=str(tmp_path))
    for ops in ([("insert", "arc", edges[-12:-6])], [("delete", "arc", edges[:6])]):
        srv.submit_txn(ops)
        srv.run()
    srv.close()
    words = np.load(f"{list_snapshots(str(tmp_path))[-1]}/bm.0.m.npy")
    assert words.dtype == np.uint32 and (words >> 31).any()
    before = (kb.bitmm.launches, kb.bitmm_fused_delta.launches)
    got = MaterializedInstance.restore(str(tmp_path), cache=PlanCache())
    assert got.device.type == "cuda"
    assert kb.bitmm.launches > before[0] and kb.bitmm_fused_delta.launches > before[1]
    want = MaterializedInstance.restore(str(tmp_path), cache=PlanCache(), device="cpu")
    assert got.restore_stats == want.restore_stats
    _same_relations(got, want, ("arc", "tc"))
    _same_relations(got, live, ("arc", "tc"))
    assert torch.equal(got._bm[0].m.cpu(), want._bm[0].m)
    more = [("insert", "arc", edges[-6:])]
    assert got.apply_txn(more).modes == want.apply_txn(more).modes == {0: "bitmatrix"}
    _same_relations(got, want, ("arc", "tc"))


def test_engine_checkpoints_resume_on_the_card(cuda, tmp_path):
    edges = random_graph(200, 400, seed=7)
    prog = ALL["tc"].program
    cfg = EngineConfig(backend="tuple", checkpoint_every=3, checkpoint_dir=str(tmp_path))
    want = Engine(EngineConfig(backend="tuple"), device="cpu").run(prog, {"arc": edges})
    got = Engine(cfg, device=cuda).run(prog, {"arc": edges})
    np.testing.assert_array_equal(got["tc"], want["tc"])
    resumed = Engine(EngineConfig(backend="tuple")).run(prog, {"arc": edges},
                                                      resume_from=str(tmp_path))
    np.testing.assert_array_equal(resumed["tc"], want["tc"])


def test_chunked_host_copy_matches_cpu(cuda, monkeypatch):
    """Tables copied to the host through the pinned buffer in steps (sizes
    off the step, one exactly on it) equal a plain ``.cpu()``."""
    from repro_torch.core import relation

    monkeypatch.setattr(relation, "HOST_COPY_CHUNK_BYTES", 4096)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for rows in (1, 511, 512, 513, 5000):
        t = torch.randint(-2**31, 2**31 - 1, (rows, 2), generator=gen, device=cuda,
                          dtype=torch.int32)
        got = relation.to_host(t)
        assert got.dtype == np.int32 and got.shape == (rows, 2)
        np.testing.assert_array_equal(got, t.cpu().numpy())


# --------------------------------------------------------------------------
# the distributed layer and training on the card: one NCCL rank
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (1, 1) mesh over an NCCL group of world size 1 (NCCL refuses two
    ranks on one card), joined through a ``file://`` store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("schedule", ["allgather", "rows1d", "psum"])
def test_sharded_tc_on_the_card_matches_tc_fixpoint(nccl_mesh, schedule):
    from repro_torch.core.bitmatrix import edges_to_bitmatrix, tc_fixpoint
    from repro_torch.core.distributed import assemble_bitmatrix, tc_fixpoint_sharded

    n = 700
    edges = random_graph(n, 2000, seed=11)
    want, want_iters = tc_fixpoint(edges_to_bitmatrix(torch.as_tensor(edges, device="cuda"),
                                                      n), n)
    before = kb.bitmm.launches
    m, n_pad, iters = tc_fixpoint_sharded(edges, n, nccl_mesh, schedule=schedule)
    full = assemble_bitmatrix(m, nccl_mesh, ("data",), None if schedule == "rows1d" else "model")
    assert m.is_cuda and n_pad == 768 and iters == want_iters
    assert torch.equal(full[:n, :want.shape[1]], want) and not full[n:].any()
    assert kb.bitmm.launches - before == (0 if schedule == "psum" else iters)


def _smoke_state(device):
    """A fresh SMOKE train state (the same draw on every call) on ``device``."""
    from repro_torch.models.recsys import two_tower as tt
    from repro_torch.train import init_train_state

    params = tt.init_params(SMOKE, torch.Generator().manual_seed(2), device="cpu")
    return init_train_state(_tree_to(params, device)), tt


def _tree_to(tree, device):
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def _smoke_batch(step, device, accum=1):
    b = RecsysStream(SMOKE.user_vocab, SMOKE.item_vocab, SMOKE.user_fields, SMOKE.item_fields,
                     SMOKE.field_hots, SMOKE.n_dense_feat, batch=16).batch(step)
    return {k: torch.as_tensor(v.reshape((accum, -1) + v.shape[1:]) if accum > 1 else v,
                               device=device) for k, v in b.items()}


def test_gradients_and_update_on_the_card_match_cpu(cuda):
    """The loss's gradients on the card equal the CPU's within 1e-5 of each
    leaf's largest entry, and AdamW given the same gradients updates alike."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.optim import adamw_update
    from repro_torch.train.step import value_and_grad

    (cpu_state, tt), (gpu_state, _) = _smoke_state("cpu"), _smoke_state(cuda)
    loss, grads = value_and_grad(tt.loss, cpu_state.params, _smoke_batch(0, "cpu"), SMOKE)
    before = kg.gather_sum.launches
    gpu_loss, gpu_grads = value_and_grad(tt.loss, gpu_state.params, _smoke_batch(0, cuda),
                                         SMOKE)
    assert kg.gather_sum.launches == before          # training bags are torch ops
    torch.testing.assert_close(gpu_loss.cpu(), loss, atol=0, rtol=1e-5)
    for a, b in zip(tree_leaves(gpu_grads), tree_leaves(grads)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5 * float(b.abs().max()), rtol=0)
    params, _, gnorm = adamw_update(cpu_state.params, grads, cpu_state.opt, 1e-2)
    gpu_params, _, gpu_gnorm = adamw_update(gpu_state.params, _tree_to(grads, cuda),
                                            gpu_state.opt, 1e-2)
    torch.testing.assert_close(gpu_gnorm.cpu(), gnorm, atol=0, rtol=1e-6)
    for a, b in zip(tree_leaves(gpu_params), tree_leaves(params)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)


# moves the weights by about 1e-2 a step (the CPU parity tests' schedule)
TRAIN_SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)


def _paired_steps(monkeypatch, card_step, accum=1, compressed=False):
    """Three steps at SMOKE and ``TRAIN_SCHEDULE``: ``card_step`` on the
    card and ``make_train_step`` on the CPU, from the same params.  The
    card's step is handed the CPU's gradients in place of its own, which
    are held against them (1e-5 of each leaf's largest entry): Adam moves a
    weight by about lr · sign(g), so a gradient entry that cancels to
    float32 noise could otherwise take another sign on the card.  With
    ``compressed`` the CPU's gradients take the int8 rounding with error
    feedback, which is ``compressed_psum`` over one rank.  Returns the
    card's and the CPU's final states and the per-step metrics."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.optim import compress_state_init, dequantize_int8, quantize_int8
    from repro_torch.train import make_train_step
    from repro_torch.train import step as train_step_mod

    real = train_step_mod.value_and_grad
    (host, tt), (card, _) = _smoke_state("cpu"), _smoke_state("cuda")
    host_err, card_err = compress_state_init(host.params), compress_state_init(card.params)
    fed = []

    def round_int8(g, e):
        e.add_(g)
        d = dequantize_int8(*quantize_int8(e))
        e.sub_(d)
        return d

    def on_cpu(*args, **kwargs):
        loss, g = real(*args, **kwargs)
        fed.append((loss, _tree_to(g, "cpu")))
        return loss, (tree_map(round_int8, g, host_err) if compressed else g)

    def on_card(*args, **kwargs):
        loss, g = real(*args, **kwargs)
        want_loss, want = fed.pop(0)
        torch.testing.assert_close(loss.cpu(), want_loss, atol=0, rtol=1e-5)
        for a, b in zip(tree_leaves(g), tree_leaves(want)):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5 * float(b.abs().max()), rtol=0)
        return want_loss.cuda(), _tree_to(want, "cuda")

    cpu_step = make_train_step(tt.loss, SMOKE, accum=accum, **TRAIN_SCHEDULE)
    metrics = []
    for i in range(3):
        monkeypatch.setattr(train_step_mod, "value_and_grad", on_cpu)
        host, want = cpu_step(host, _smoke_batch(i, "cpu", accum))
        monkeypatch.setattr(train_step_mod, "value_and_grad", on_card)
        if compressed:
            card, card_err, got = card_step(card, card_err, _smoke_batch(i, "cuda"))
        else:
            card, got = card_step(card, _smoke_batch(i, "cuda", accum))
        metrics.append((got, want))
    monkeypatch.undo()
    assert not fed
    return card, host, metrics


def _assert_card_state_matches(card, host):
    """Params within 1e-6, moments within 1e-6 of each leaf's largest entry,
    counts equal, and the params moved by at least 1e-3 from the start."""
    from torch.utils._pytree import tree_leaves

    start, _ = _smoke_state("cpu")
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(host.params), tree_leaves(start.params)))
    assert moved >= 1e-3
    for a, b in zip(tree_leaves(card.params), tree_leaves(host.params)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)
    for k in ("mu", "nu"):
        for a, b in zip(tree_leaves(card.opt[k]), tree_leaves(host.opt[k])):
            torch.testing.assert_close(a.cpu(), b, atol=1e-6 * float(b.abs().max()), rtol=0)
    assert int(card.opt["count"]) == int(host.opt["count"]) == 3
    assert int(card.step) == int(host.step) == 3


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_the_card_matches_cpu(cuda, monkeypatch, accum):
    """Three steps at a learning rate of 1e-2, the card's step fed the CPU's
    gradients (its own checked against them): the states agree."""
    from repro_torch.train import make_train_step

    _, tt = _smoke_state("cpu")
    before = kg.gather_sum.launches
    card, host, metrics = _paired_steps(
        monkeypatch, make_train_step(tt.loss, SMOKE, accum=accum, **TRAIN_SCHEDULE), accum)
    assert kg.gather_sum.launches == before
    for got, want in metrics:
        assert got["loss"].is_cuda
        for k in ("loss", "gnorm", "lr"):
            torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-9, rtol=1e-6)
    _assert_card_state_matches(card, host)


def test_loss_sharded_at_world_one_is_the_loss(nccl_mesh):
    from torch.utils._pytree import tree_leaves

    from repro_torch.train.step import value_and_grad

    state, tt = _smoke_state("cuda")
    params = state.params
    batch = _smoke_batch(0, "cuda")
    loss, grads = value_and_grad(tt.loss, params, batch, SMOKE)
    for scatter in (False, True):
        got, got_grads = value_and_grad(tt.loss_sharded, params, batch, SMOKE, mesh=nccl_mesh,
                                        scatter=scatter)
        torch.testing.assert_close(got, loss, atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(got_grads), tree_leaves(grads)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_compressed_dp_step_on_the_card_tracks_the_plain_step(nccl_mesh, monkeypatch):
    """The compressed DP step over one NCCL rank, at a learning rate of 1e-2
    and fed the CPU's gradients, equals the plain step on the CPU given the
    same gradients int8-rounded with error feedback."""
    from repro_torch.train import make_compressed_dp_step

    _, tt = _smoke_state("cpu")
    card, host, metrics = _paired_steps(
        monkeypatch, make_compressed_dp_step(tt.loss, SMOKE, nccl_mesh, "data",
                                             **TRAIN_SCHEDULE), compressed=True)
    for got, want in metrics:
        for k in ("loss", "gnorm"):
            torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-9, rtol=1e-6)
    _assert_card_state_matches(card, host)


# -- the transformer LMs: SMOKE weights drawn on the CPU, on both devices ------------

LM_TOL, LM_BF16_TOL = 1e-4, 2e-2      # of each output's largest |value|


def _lm_runs(params, cfg, toks):
    """forward's logits, prefill's plus decode's logits, the cache and the
    greedy tokens, all on the host."""
    t = torch.as_tensor(toks, device=params["embed"].device)
    full, _ = tf.forward(params, t, cfg)
    logits, cache = tf.prefill(params, t[:, :4], cfg, toks.shape[1])
    steps = [logits]
    for pos in range(4, toks.shape[1]):
        logits, cache = tf.decode_step(params, cache, t[:, pos], pos, cfg)
        steps.append(logits)
    greedy = generate(params, toks[:, :4], cfg, steps=8, temperature=0.0)
    return (full.cpu(), torch.stack(steps, 1).cpu(), {k: v.cpu() for k, v in cache.items()},
            greedy.cpu())


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("arch", list(lm_registry.LM_ARCHS))
def test_lm_on_the_card_matches_cpu(cuda, arch):
    cfg = lm_registry.arch_config(arch, smoke=True)
    host = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    h_full, h_steps, h_cache, h_tok = _lm_runs(host, cfg, toks)
    c_full, c_steps, c_cache, c_tok = _lm_runs(tree_map(lambda t: t.to(cuda), host), cfg, toks)
    assert _rel(c_full, h_full) <= LM_TOL and _rel(c_steps, h_steps) <= LM_TOL
    for key in h_cache:
        assert _rel(c_cache[key], h_cache[key]) <= LM_TOL, key
    assert torch.equal(c_tok, h_tok)
    assert _rel(c_steps, c_full[:, 3:]) <= LM_TOL       # decode against forward


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b"], ids=["gqa", "mla"])
def test_lm_bfloat16_on_the_card_matches_cpu(cuda, arch):
    cfg = dataclasses.replace(lm_registry.arch_config(arch, smoke=True), dtype="bfloat16",
                              param_dtype="bfloat16")
    host = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    h_full, h_steps, _, _ = _lm_runs(host, cfg, toks)
    c_full, c_steps, _, _ = _lm_runs(tree_map(lambda t: t.to(cuda), host), cfg, toks)
    assert c_full.dtype == torch.bfloat16
    assert _rel(c_full, h_full) <= LM_BF16_TOL and _rel(c_steps, h_steps) <= LM_BF16_TOL


def test_launch_serve_runs_on_the_card_by_default(cuda):
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b", "--smoke",
         "--requests", "3", "--max-new", "5"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert got["device"] == torch.cuda.get_device_name(0) and got["generated_tokens"] == 15


# -- training after serving: LM training, the GNNs and the sampler ------------------


def _grads(loss_fn, params, batch, cfg, **kwargs):
    from repro_torch.train.step import value_and_grad

    return value_and_grad(loss_fn, params, batch, cfg, **kwargs)


@pytest.mark.parametrize("arch", list(lm_registry.LM_ARCHS))
def test_lm_training_gradients_on_the_card_match_cpu(cuda, arch):
    """``lm_loss(remat=True)``'s gradients on the card equal the CPU's within
    1e-5 of each leaf's largest entry: the MoE group sizes read on the host,
    the per-segment products and the recompute, under autograd on CUDA."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.data.tokens import TokenStream

    cfg = lm_registry.arch_config(arch, smoke=True)
    host = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = TokenStream(cfg.vocab, 2, 16).batch(0)
    (want_loss, want), (loss, got) = (
        _grads(tf.lm_loss, p, {k: torch.as_tensor(v, device=d) for k, v in batch.items()},
               cfg, remat=True)
        for p, d in ((host, "cpu"), (tree_map(lambda t: t.to(cuda), host), cuda)))
    assert loss.is_cuda and _rel(loss.cpu(), want_loss) <= 1e-5
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert _rel(a.cpu(), b) <= 1e-5


def _gnn_batch(arch, cfg, device):
    """A ring-lattice graph with 11 padded (-1) edges; molecules for schnet."""
    from repro_torch.data.graphs import batched_molecules, grid_mesh_graph
    from repro_torch.models.gnn import GraphBatch

    rng = np.random.default_rng(0)
    pos = gids = edge_feat = None
    if arch == "schnet":
        feats, s, r, gids, pos = batched_molecules(4, 8, 16, cfg.d_in)
        labels = rng.standard_normal((4, cfg.d_out)).astype(np.float32)
    else:
        s, r = grid_mesh_graph(60, 240)
        feats = rng.standard_normal((60, cfg.d_in)).astype(np.float32)
        labels = (rng.integers(0, cfg.d_out, 60).astype(np.int32) if cfg.task == "node_class"
                  else rng.standard_normal((60, cfg.d_out)).astype(np.float32))
        if cfg.d_edge:
            edge_feat = rng.standard_normal((251, cfg.d_edge)).astype(np.float32)
        if arch == "graphcast":
            pos = rng.standard_normal((60, 3)).astype(np.float32)
    s, r = (np.concatenate([a, np.full(11, -1, np.int32)]) for a in (s, r))
    return GraphBatch(*(None if a is None else torch.as_tensor(a, device=device)
                        for a in (feats, s, r, edge_feat, pos, gids, labels)))


@pytest.mark.parametrize("arch", ["gcn-cora", "meshgraphnet", "schnet", "graphcast"])
def test_gnn_gradients_on_the_card_match_cpu(cuda, arch):
    from torch.utils._pytree import tree_leaves

    from repro_torch.models.gnn import MODELS

    cfg = lm_registry.arch_config(arch, smoke=True)
    model = MODELS[cfg.arch]
    host = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    (want_loss, want), (loss, got) = (
        _grads(model.loss, p, _gnn_batch(arch, cfg, d), cfg)
        for p, d in ((host, "cpu"), (tree_map(lambda t: t.to(cuda), host), cuda)))
    assert loss.is_cuda and _rel(loss.cpu(), want_loss) <= 1e-5
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert _rel(a.cpu(), b) <= 1e-5


def test_sampler_on_the_card_matches_cpu(cuda):
    """Given the card's draws, the blocks on the card equal the CPU's bit for
    bit, and every sampled slot is an in-neighbor of its frontier node."""
    from repro_torch.data.graphs import grid_mesh_graph
    from repro_torch.relational.sampler import NeighborSampler, build_csr

    s, r = grid_mesh_graph(500, 2600, seed=1)
    row_ptr, col = build_csr(s, r, 500)
    card = NeighborSampler(row_ptr, col, (5, 3), device=cuda)
    host = NeighborSampler(row_ptr, col, (5, 3), device="cpu")
    gen = torch.Generator(device=cuda).manual_seed(0)
    frontier = torch.arange(0, 500, 7, dtype=torch.int32)
    for fanout in (5, 3):
        u = card.draws(gen, frontier.shape[0], fanout)
        got = card.sample_layer(frontier.to(cuda), fanout, u)
        want = host.sample_layer(frontier, fanout, u.cpu())
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)
        edges = set(zip(s.tolist(), r.tolist()))
        assert all((a, frontier[i // fanout].item()) in edges
                   for i, a in enumerate(want.src.tolist()))
        frontier = torch.where(want.mask, want.src, 0)


def test_launch_train_runs_on_the_card_by_default(cuda, tmp_path):
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-moe-1b-a400m",
         "--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert got["restarts"] == 0 and got["steps"] == 2 and np.isfinite(got["final_loss"])


# -- the sharded forms on one NCCL rank --------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"])
def test_ep_moe_on_the_card_matches_dense(nccl_mesh, arch):
    """At tp = 1 the expert-parallel form routes as the dense dispatch: the
    forward's logits and aux, and the sharded step's loss and gradients
    under ``mesh_context``, within 1e-5 of the plain ones (SMOKE, float32)."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed import gather, mesh_context, param_sharding, place
    from repro_torch.models.transformer import layers as tl
    from repro_torch.train.step import ep_local, sharded_value_and_grad, value_and_grad

    cfg = lm_registry.arch_config(arch, smoke=True)
    dev = torch.device("cuda")
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in TokenStream(cfg.vocab, 2, 16).batch(0).items()}
    calls = []
    ep = tl._moe_apply_ep

    def counted(*args):
        calls.append(1)
        return ep(*args)

    tl._moe_apply_ep = counted
    try:
        with torch.no_grad():
            want, want_aux = tf.forward(params, batch["tokens"], cfg)
            with mesh_context(nccl_mesh, ("data",)):
                got, got_aux = tf.forward(params, batch["tokens"], cfg)
        assert calls and _rel(got.cpu(), want.cpu()) <= 1e-5
        assert _rel(got_aux.cpu(), want_aux.cpu()) <= 1e-5
        sh = param_sharding(params, nccl_mesh)
        want_loss, want_g = value_and_grad(tf.lm_loss, params, batch, cfg, remat=True)
        with mesh_context(nccl_mesh, ("data",)):
            loss, grads = sharded_value_and_grad(tf.lm_loss, place(params, sh), batch, cfg,
                                                 nccl_mesh, sh, ep_local, remat=True)
    finally:
        tl._moe_apply_ep = ep
    assert _rel(loss.cpu(), want_loss.cpu()) <= 1e-5
    for a, b in zip(tree_leaves(gather(grads, sh)), tree_leaves(want_g)):
        assert _rel(a.cpu(), b.cpu()) <= 1e-5


def test_halo_gcn_on_one_shard_on_the_card_matches_gcn_loss(nccl_mesh):
    """``loss_halo`` on a ring of one (senders offset by ``halo``) over a
    ring lattice equals ``gcn.loss``, value and gradients, within 1e-5."""
    from repro_torch.data.graphs import grid_mesh_graph
    from repro_torch.models.gnn import GraphBatch, gcn
    from repro_torch.train.step import value_and_grad

    halo, n, k = 8, 300, 4
    dev = torch.device("cuda")
    cfg = lm_registry.arch_config("gcn-cora", smoke=True)
    s, r = (torch.as_tensor(a, device=dev) for a in grid_mesh_graph(n, k * n))
    pad = torch.full((13,), -1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    labels = torch.randint(-1, cfg.d_out, (n,), generator=gen, device=dev, dtype=torch.int32)
    plain = GraphBatch(feats, torch.cat([s, pad]), torch.cat([r, pad]), None, None, None, labels)
    local = plain._replace(senders=torch.cat([s + halo, pad]))
    params = gcn.init_params(cfg, gen, device=dev)
    want, want_g = value_and_grad(gcn.loss, params, plain, cfg)
    got, got_g = value_and_grad(gcn.loss_halo, params, local, cfg, mesh=nccl_mesh, halo=halo)
    assert got.is_cuda and _rel(got.cpu(), want.cpu()) <= 1e-5
    for key in params:
        assert _rel(got_g[key].cpu(), want_g[key].cpu()) <= 1e-5


def test_cells_build_on_the_card_mesh_without_allocating(nccl_mesh):
    """Every cell on the (1, 1) NCCL mesh: meta arguments, nothing allocated
    on the card; the smallest GNN cell's step runs and equals the plain step."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.distributed import place
    from repro_torch.models.gnn import GraphBatch, gcn
    from repro_torch.train import init_train_state, make_train_step

    before = torch.cuda.memory_allocated()
    cells = {key: lm_registry.build_cell(*key, nccl_mesh) for key in lm_registry.all_cells()}
    assert torch.cuda.memory_allocated() == before
    assert len(cells) == len(lm_registry.all_cells())
    assert all(x.device.type == "meta" for c in cells.values() for x in tree_leaves(c.args)
               if x is not None)
    cell = cells["gcn-cora", "full_graph_sm"]
    state_sds, g_sds = cell.args
    cfg = dataclasses.replace(lm_registry.arch_config("gcn-cora"),
                              d_in=g_sds.node_feat.shape[1])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, e = g_sds.node_feat.shape[0], g_sds.senders.shape[0]
    snd = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
    g = GraphBatch(torch.randn((n, cfg.d_in), generator=gen, device=dev), snd,
                   torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32),
                   None, None, None,
                   torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev,
                                 dtype=torch.int32))
    params = gcn.init_params(cfg, gen, device=dev)
    sharded = place(init_train_state(tree_map(torch.clone, params)), cell.in_shardings[0])
    plain = init_train_state(tree_map(torch.clone, params))
    sharded, got = cell.fn(sharded, place(g, cell.in_shardings[1]))
    plain, want = make_train_step(gcn.loss, cfg)(plain, g)
    assert _rel(got["loss"].cpu(), want["loss"].cpu()) <= 1e-5
    for key in params:
        assert _rel(sharded.params[key].cpu(), plain.params[key].cpu()) <= 1e-5


# -- the tracer on the card ----------------------------------------------------

def test_device_span_reads_the_kernel_time_without_waiting(cuda):
    from repro_torch.obs.trace import Tracer

    torch.cuda._sleep(1000)                       # loads the kernel
    torch.cuda.synchronize()
    tr = Tracer()
    before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tr.enable()
    try:
        before.record()
        with tr.device_span("sleep", "t", device=cuda):
            torch.cuda._sleep(100_000_000)
        after.record()
    finally:
        tr.disable()
    (sp,) = tr.spans()
    after.synchronize()
    outer_ns = before.elapsed_time(after) * 1e6
    assert 0.95 * outer_ns <= sp.device_ns <= outer_ns
    assert sp.dur_ns < sp.device_ns / 10          # the host never waited
    assert sp.syncs == 0


def test_host_syncs_are_counted_per_span(cuda):
    from repro_torch.obs.trace import Tracer

    x = torch.arange(1, 11, device=cuda)
    torch.cuda.synchronize()
    tr = Tracer()
    tr.enable()
    try:
        with tr.span("reads"):
            for i in range(5):
                x[i].item()
            with tr.span("more"):
                int(x.sum())
                x.cpu()
                torch.nonzero(x)
        with tr.span("explicit"):
            torch.cuda.synchronize()
            tr.count_sync()
        with tr.span("queued"):
            y = x * 2
            del y
    finally:
        tr.disable()
    assert {s.name: s.syncs for s in tr.spans()} == {
        "reads": 8, "more": 3, "explicit": 1, "queued": 0}
    assert torch.cuda.get_sync_debug_mode() == 0


def test_a_span_holds_its_kernels_on_the_device_trace(cuda):
    """The profiler's device intervals, mapped onto ``perf_counter_ns`` by
    ``bench.harness.profile``, of kernels launched and waited for inside a
    span lie within the span's host interval."""
    import time

    from bench.harness.profile import DeviceTrace
    from repro_torch.obs.trace import Tracer

    x = torch.rand(1 << 24, device=cuda)
    torch.cuda.synchronize()
    tr = Tracer()
    tr.enable()
    try:
        with DeviceTrace() as dt:
            with tr.device_span("work", "t", device=cuda):
                time.sleep(0.01)
                torch.cuda._sleep(20_000_000)
                (x * 2).sum().item()
                time.sleep(0.01)
    finally:
        tr.disable()
    (sp,) = tr.spans()
    events = dt.device_events()
    assert len(events) >= 3
    for start, end, name in events:
        assert sp.start_ns < start <= end < sp.start_ns + sp.dur_ns, name
    assert sp.syncs == 1


def test_edb_upload_dedups_on_the_card(cuda, monkeypatch):
    """``TupleRelation.from_numpy`` on the card equals the same call on the
    CPU for a G10K edge list with 10 % duplicate rows shuffled in, without
    NumPy's ``unique``; ``edb.dedup`` carries its device time and the rows it
    dropped, and the upload waits on the host at most twice."""
    from repro_torch.core.relation import TupleRelation
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.obs.trace import TRACER

    edges = gnp_graph(10_000, 0.001, seed=0).astype(np.int32)
    rng = np.random.default_rng(0)
    dups = edges[rng.choice(len(edges), len(edges) // 10, replace=False)]
    data = rng.permutation(np.concatenate([edges, dups]))
    host = TupleRelation.from_numpy("arc", data, 10_000, "cpu")
    TupleRelation.from_numpy("arc", data, 10_000, cuda)        # loads the kernels
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("np.unique called during the upload")

    monkeypatch.setattr(np, "unique", refuse)
    TRACER.enable()
    try:
        card = TupleRelation.from_numpy("arc", data, 10_000, cuda)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = {s.name: s for s in TRACER.spans()}
    TRACER.clear()
    monkeypatch.undo()
    assert (card.count, card.capacity) == (host.count, host.capacity) == (
        len(edges), 1 << 17)
    assert torch.equal(card.rows.cpu(), host.rows)
    upload, dedup = spans["edb.upload"], spans["edb.dedup"]
    assert dedup.parent_id == upload.span_id
    assert dedup.device_ns is not None and dedup.device_ns > 0
    assert dedup.args == {"dropped": len(dups)}
    assert upload.args == {"rel": "arc", "rows_in": len(data), "rows": len(edges)}
    assert upload.syncs <= 2


@pytest.mark.parametrize("plan", ["sg", "tc"])
def test_pbme_fixpoint_waits_on_the_host_once_a_round(cuda, plan):
    """``pbme.fixpoint`` on the card waits on the host once a round, for the
    termination test's popcount, whichever plan: its ``syncs`` equal its
    ``iterations``.  SG's transpose and identity mask wait for nothing."""
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.obs.trace import TRACER

    arc = gnp_graph(2000, 0.002, seed=0).astype(np.int32)
    Engine(EngineConfig(backend="bitmatrix"), device=cuda).run(
        ALL[plan].program, {"arc": arc}, return_numpy=False)       # loads the kernels
    torch.cuda.synchronize()
    engine = Engine(EngineConfig(backend="bitmatrix"), device=cuda)
    TRACER.enable()
    try:
        engine.run(ALL[plan].program, {"arc": arc}, return_numpy=False)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = TRACER.spans()
    TRACER.clear()
    (fixpoint,) = [s for s in spans if s.name == "pbme.fixpoint"]
    iterations = engine.stats.total_iterations()
    assert fixpoint.args["plan"] == plan and fixpoint.args["iterations"] == iterations >= 3
    assert fixpoint.syncs == iterations and fixpoint.device_ns > 0
    inner = [s for s in spans if s.name in ("pbme.transpose", "pbme.mask")]
    assert len(inner) == (2 if plan == "sg" else 0)
    assert all(s.syncs == 0 and s.device_ns > 0 for s in inner)


#: ``engine.run``'s host syncs for CC on ``rmat_graph(12)`` on the card: 51 on
#: an H100 80GB HBM3 while the MIN table's update read four counts a round (its
#: present and improved keys, the round's Δ, its candidates), the same with and
#: without the ``agg.propagate``, ``join``, ``membership`` and ``agg.groupby``
#: spans; the update on ``csrc/dense_agg.cu`` reads them in one copy, so each
#: of the 6 rounds waits 3 times less
CC_RMAT12_SYNCS = 33


def test_cc_spans_on_the_card_add_no_host_wait(cuda):
    """CC on ``rmat_graph(12)`` on the card, traced: ``cc2`` equals the CPU's,
    the tuple path's and the MIN table's spans carry device time, the
    membership test waits for nothing, and ``engine.run`` waits on the host as
    often as it did before those spans existed."""
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.obs.trace import TRACER

    arc = rmat_graph(12).astype(np.int32)
    program = ALL["cc"].program
    Engine(EngineConfig(), device=cuda).run(program, {"arc": arc}, return_numpy=False)
    torch.cuda.synchronize()
    engine = Engine(EngineConfig(), device=cuda)
    TRACER.enable()
    try:
        engine.run(program, {"arc": arc}, return_numpy=False)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = TRACER.spans()
    TRACER.clear()
    cc2 = engine.take_store()["cc2"]
    want = Engine(EngineConfig(), device="cpu").run(program, {"arc": arc})["cc2"]
    np.testing.assert_array_equal(cc2.rows[: cc2.count].cpu().numpy(), want)
    (run,) = [s for s in spans if s.name == "engine.run"]
    assert run.syncs == CC_RMAT12_SYNCS
    for name in ("agg.propagate", "join", "membership", "agg.groupby"):
        mine = [s for s in spans if s.name == name]
        assert mine and all(s.device_ns > 0 for s in mine), name
    assert all(s.syncs == 0 for s in spans if s.name == "membership")


# --------------------------------------------------------------------------
# the dense MIN/MAX table's update (csrc/dense_agg.cu)
# --------------------------------------------------------------------------

#: (n, slots, valid slots, how they lie, buffers): small tables, RMAT-1M's base
#: round (10,173,110 sorted keys, 6,604,106 tail pads of 2^24 slots) and a round
#: where half the valid slots share one key
AGG_CASES = {
    "tail_pads": (50, 256, 90, "tail", 1),
    "middle_invalid": (1000, 4096, None, "random", 1),
    "clamp": (1000, 4096, None, "wide", 1),
    "two_buffers": (5000, 1 << 14, 9000, "tail", 2),
    "rmat1m_base": (1 << 20, 1 << 24, 10_173_110, "sorted", 1),
    "half_one_key": (1 << 20, 1 << 22, 3_000_000, "hub", 1),
}


def _agg_round(cuda, n, slots, total, how, buffers, op, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    absent = kd.SENTINEL if op == "MIN" else -kd.SENTINEL
    values = torch.randint(-2**20, 2**20, (n,), generator=gen, device=cuda, dtype=torch.int32)
    values[torch.rand(n, generator=gen, device=cuda) < 0.5] = absent
    bufs = []
    for b in range(buffers):
        lo, hi = (-n, 2 * n) if how == "wide" else (0, n)
        keys = torch.randint(lo, hi, (slots,), generator=gen, device=cuda, dtype=torch.int32)
        vals = torch.randint(-2**20, 2**20, (slots,), generator=gen, device=cuda,
                             dtype=torch.int32)
        if how in ("random", "wide"):
            valid = torch.rand(slots, generator=gen, device=cuda) < 0.5
        else:
            valid = torch.arange(slots, device=cuda) < total - b * (total // 3)
        if how == "sorted":                      # cc3(x, MIN(x)) :- arc(x, _)
            keys = torch.sort(keys).values
            vals = keys.clone()
        if how == "hub":
            keys[valid & (torch.rand(slots, generator=gen, device=cuda) < 0.5)] = 12345
        bufs.append((keys, vals, valid))
    return values, bufs


@pytest.mark.parametrize("case", list(AGG_CASES))
@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_dense_agg_kernel_matches_plain(cuda, op, case):
    """The update on the card equals the plain version on the card bit for
    bit: the table, Δ, the candidates and both counts; one launch a round,
    the old table untouched, and at least one atomic for each improved key,
    at most one a candidate."""
    values, bufs = _agg_round(cuda, *AGG_CASES[case], op, seed=len(case))
    before = values.clone()
    launches = kd.dense_agg_update.launches
    got = kd.dense_agg_update(values, op, bufs)
    want = dense_agg_update_plain(values, op, bufs)
    assert kd.dense_agg_update.launches == launches + 1
    assert torch.equal(got.values, want[0]) and torch.equal(got.delta, want[1])
    assert (got.candidates, got.count, got.delta_count) == want[2:]
    assert got.delta_count <= got.atomics <= got.candidates
    assert torch.equal(values, before)
    torch.cuda.synchronize()


def test_dense_agg_update_waits_once(cuda):
    """A round of two buffers through ``DenseAggRelation.update_round`` makes
    one host sync and one launch; a round with no buffers makes neither."""
    from repro_torch.core.relation import DenseAggRelation
    from repro_torch.obs.trace import TRACER

    values, bufs = _agg_round(cuda, *AGG_CASES["two_buffers"], "MIN", seed=3)
    handle = DenseAggRelation("t", values.shape[0], "MIN", values,
                              torch.zeros_like(values, dtype=torch.bool))
    handle.update_round(bufs)                                       # loads the kernels
    torch.cuda.synchronize()
    launches = kd.dense_agg_update.launches
    TRACER.enable()
    try:
        with TRACER.span("round") as full:
            new, candidates, atomics = handle.update_round(bufs)
        with TRACER.span("round") as empty:
            quiet, none, no_atomics = new.update_round([])
    finally:
        TRACER.disable()
        TRACER.clear()
    assert (full.syncs, empty.syncs) == (1, 0)
    assert kd.dense_agg_update.launches == launches + 1
    assert candidates == sum(int(b[2].sum()) for b in bufs) and atomics > 0
    assert (none, no_atomics, quiet.delta_count, quiet.count) == (0, 0, 0, new.count)
    assert not bool(quiet.delta.any()) and quiet.values is new.values


def test_cc_on_the_card_matches_plain_min_label(cuda):
    """CC on ``rmat_graph(16)`` on the card: ``cc2`` equals the plain label
    propagation, the rounds and candidates are its own, every round's update
    is one launch, and each ``agg.propagate`` carries the atomics it issued."""
    from plain_min_label import min_label
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.obs.trace import TRACER

    arc = rmat_graph(16).astype(np.int32)
    want, rounds, candidates = min_label(arc, 1 << 16, device=cuda)
    engine = Engine(EngineConfig(), device=cuda)
    launches = kd.dense_agg_update.launches
    TRACER.enable()
    try:
        out = engine.run(ALL["cc"].program, {"arc": arc})
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = TRACER.spans()
    TRACER.clear()
    assert np.array_equal(out["cc2"], want)
    assert engine.stats.total_iterations() == rounds + 4
    props = sorted((s for s in spans if s.name == "agg.propagate"),
                   key=lambda s: s.args["iteration"])
    assert [s.args["candidates"] for s in props] == candidates
    assert kd.dense_agg_update.launches == launches + len(props)
    assert all(s.args["improved"] <= s.args["atomics"] <= s.args["candidates"] for s in props)


#: ``engine.run``'s host syncs for Andersen on ``andersen_facts(3)`` on the card:
#: 209 on an H100 80GB HBM3 over its 9 iterations, traced, with the
#: ``uie.dedup``, ``dsd`` and ``idb.merge`` spans in place and without them
ANDERSEN_D3_SYNCS = 209


def test_andersen_on_the_card_matches_plain_points_to(cuda):
    """Andersen on ``andersen_facts(3)`` on the card, traced: ``pointsTo``
    equals the plain points-to analysis, the iteration count and each
    round's derivations and new facts are its own, the tuple path's round
    spans carry device time, and ``engine.run`` waits on the host as often
    as it did before those spans existed."""
    from plain_points_to import derivations, new_facts, points_to
    from repro_torch.data.program_facts import andersen_facts
    from repro_torch.obs.trace import TRACER

    edb, n = andersen_facts(3)
    program = ALL["andersen"].program
    Engine(EngineConfig(), device=cuda).run(program, edb, return_numpy=False)
    torch.cuda.synchronize()
    engine = Engine(EngineConfig(), device=cuda)
    TRACER.enable()
    try:
        engine.run(program, edb, return_numpy=False)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = TRACER.spans()
    TRACER.clear()
    table = engine.take_store()["pointsTo"]
    want, rounds = points_to(edb, n, device=cuda)
    np.testing.assert_array_equal(table.rows[: table.count].cpu().numpy(), want)
    assert engine.stats.total_iterations() == rounds + 2
    (run,) = [s for s in spans if s.name == "engine.run"]
    assert run.syncs == ANDERSEN_D3_SYNCS
    derived, added = derivations(edb, n, device=cuda), new_facts(edb, n, device=cuda)
    assert all(derived) and len(derived) == rounds + 2
    dedups = [s for s in spans if s.name == "uie.dedup"]
    assert [s.args["candidates"] for s in dedups] == derived
    assert [s.args["delta"] for s in spans if s.name == "dsd"] == added
    for name in ("uie.dedup", "dsd", "idb.merge"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == rounds + 2 and all(s.device_ns is not None for s in mine), name
    assert all(s.device_ns > 0 for s in spans if s.name in ("uie.dedup", "dsd"))


# --------------------------------------------------------------------------
# the row <-> bit-matrix conversions (csrc/bitpack.cu)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n, density", [(1, 0.0), (1, 1.0), (31, 0.3), (32, 1.0), (33, 0.5),
                                        (100, 0.02), (1000, 0.001), (3000, 0.3)])
def test_bitpack_kernels_match_plain(cuda, n, density):
    """Both conversions on the card equal their plain versions on the CPU:
    the matrix from shuffled edges with repeats and pairs outside the matrix
    (skipped on both devices), and the table's rows, count, capacity and
    SENTINEL tail; bits past column n are ignored."""
    rng = np.random.default_rng(n)
    dense = rng.random((n, n)) < density
    dense[:, 31::32] |= rng.random((n, len(range(31, n, 32)))) < 0.5     # sign bits
    inside = np.argwhere(dense).astype(np.int32)
    outside = np.array([[n, 0], [0, n], [-1, 0], [0, -1]], np.int32)
    edges = np.concatenate([inside, inside[: len(inside) // 3], outside])
    edges = torch.as_tensor(edges[rng.permutation(len(edges))])
    want_m = edges_to_bitmatrix_plain(torch.as_tensor(inside), n)
    assert torch.equal(kp.edges_to_bitmatrix(edges, n), want_m)          # the CPU path
    before = kp.edges_to_bitmatrix.launches
    got_m = kp.edges_to_bitmatrix(edges.to(cuda), n)
    assert kp.edges_to_bitmatrix.launches - before == 1
    assert torch.equal(got_m.cpu(), want_m)
    junk = got_m.clone()
    if n % 32:
        junk[:, -1] |= -(1 << (n % 32))                     # every bit at columns >= n
    for capacity_min in (128, 1 << 20):
        want_rows, want_count = kp.bitmatrix_to_table(want_m, n, capacity_min)
        assert want_count == int(dense.sum())
        before = kp.bitmatrix_to_table.launches
        for packed in (got_m, junk):
            rows, count = kp.bitmatrix_to_table(packed, n, capacity_min)
            assert count == want_count and torch.equal(rows.cpu(), want_rows)
        assert kp.bitmatrix_to_table.launches - before == 2
    torch.cuda.synchronize()


def test_bitpack_kernels_at_the_g10k_closure(cuda):
    """G10K's arc from shuffled edges with repeats, its 10^8-pair closure as a
    table, and that table packed again (the serving layer's re-pack) on the
    card equal the plain versions; pairs outside the matrix are skipped."""
    from repro_torch.core.bitmatrix import tc_fixpoint
    from repro_torch.data.graphs import gnp_graph

    n = 10_000
    edges = gnp_graph(n, 0.001, seed=0).astype(np.int32)
    rng = np.random.default_rng(0)
    edges = np.concatenate([edges, edges[rng.choice(len(edges), len(edges) // 10)]])
    edges = torch.as_tensor(edges[rng.permutation(len(edges))])
    arc = kp.edges_to_bitmatrix(edges.to(cuda), n)
    assert torch.equal(arc.cpu(), edges_to_bitmatrix_plain(edges, n))
    m, _ = tc_fixpoint(arc, n)
    rows, count = kp.bitmatrix_to_table(m, n)
    want_rows, want_count = kp.bitmatrix_to_table(m.cpu(), n)
    assert count == want_count > 9 * 10**7 and rows.shape == want_rows.shape == (1 << 27, 2)
    assert torch.equal(rows.cpu(), want_rows)
    del want_rows
    outside = torch.tensor([[n, 0], [0, n], [-1, 5], [5, -1]], dtype=torch.int32, device=cuda)
    assert torch.equal(kp.edges_to_bitmatrix(torch.cat([outside, rows[:count]]), n), m)
    torch.cuda.synchronize()


def test_to_rows_allocates_only_the_table(cuda):
    """The matrix -> table conversion of a full 10^4 x 10^4 matrix grows the
    allocator's peak by the 2^27-row table and the row counts, under 1.2 GB
    (the dense unpack and ``torch.nonzero`` took 2.4 GB)."""
    from repro_torch.relational.sort import SENTINEL

    n = 10_000
    full = torch.full((n, (n + 31) // 32), -1, dtype=torch.int32, device=cuda)
    kp.bitmatrix_to_table(full[:8], n)                              # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rows, count = kp.bitmatrix_to_table(full, n)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 1.2e9
    assert count == n * n and rows.shape == (1 << 27, 2)
    picks = rows[torch.tensor([0, 1, n, count - 1, count, (1 << 27) - 1], device=cuda)]
    assert picks.tolist() == [[0, 0], [0, 1], [1, 0], [n - 1, n - 1], [SENTINEL] * 2,
                              [SENTINEL] * 2]


@pytest.mark.parametrize("plan", ["tc", "sg"])
def test_pbme_conversions_launch_once_an_evaluation(cuda, plan):
    """A G10K evaluation on the card packs its arc with one launch and turns
    its fixpoint into rows with one: ``pbme.build`` waits on the host for
    nothing and ``pbme.to_rows`` once, for the count."""
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.obs.trace import TRACER

    arc = gnp_graph(10_000, 0.001, seed=0).astype(np.int32)
    Engine(EngineConfig(backend="bitmatrix"), device=cuda).run(
        ALL[plan].program, {"arc": arc}, return_numpy=False)       # loads the kernels
    torch.cuda.synchronize()
    before = kp.edges_to_bitmatrix.launches, kp.bitmatrix_to_table.launches
    TRACER.enable()
    try:
        Engine(EngineConfig(backend="bitmatrix"), device=cuda).run(
            ALL[plan].program, {"arc": arc}, return_numpy=False)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = {s.name: s for s in TRACER.spans()}
    TRACER.clear()
    assert (kp.edges_to_bitmatrix.launches - before[0],
            kp.bitmatrix_to_table.launches - before[1]) == (1, 1)
    build, to_rows = spans["pbme.build"], spans["pbme.to_rows"]
    assert build.args == {"n": 10_000, "rows": len(arc)} and build.syncs == 0
    assert to_rows.syncs == 1 and to_rows.args["rows"] > 9 * 10**7


def test_delete_and_reinsert_on_cuda_match_cpu(cuda):
    """A delete (the full recompute, whose matrices stay resident) and the
    re-insert (the PBME increment) on the card equal the same transactions on
    the CPU: the IDB's rows, count and capacity, and the resident matrices."""
    edges = random_graph(400, 900, seed=7)
    held = edges[::50]
    insts = {
        dev: MaterializedInstance(ALL["tc"].program, {"arc": edges}, EngineConfig(),
                                  cache=PlanCache(), device=dev)
        for dev in ("cuda", "cpu")
    }
    before = kp.edges_to_bitmatrix.launches, kp.bitmatrix_to_table.launches
    for op, mode in (("delete", "full"), ("insert", "bitmatrix")):
        stats = {dev: inst.apply_txn([(op, "arc", held)]) for dev, inst in insts.items()}
        torch.cuda.synchronize()
        assert stats["cuda"].modes == stats["cpu"].modes == {0: mode}
        got, want = (insts[d].vstore.latest().handles["tc"] for d in ("cuda", "cpu"))
        assert (got.count, got.capacity) == (want.count, want.capacity)
        assert torch.equal(got.rows.cpu(), want.rows)
        for key in ("arc", "m"):
            assert torch.equal(getattr(insts["cuda"]._bm[0], key).cpu(),
                               getattr(insts["cpu"]._bm[0], key))
    assert kp.edges_to_bitmatrix.launches > before[0]
    assert kp.bitmatrix_to_table.launches > before[1]


def test_a_g10k_delete_diffs_the_resident_words(cuda, monkeypatch):
    """G10K and the serve cell's held-out rows (1 % of arc, the draw of
    ``bench/harness/inputs.py``): the delete's recompute diffs the resident
    stratum's packed words with one sync, never runs ``set_difference``, and
    grows the card's memory by under 64 MB over the two tables while it
    diffs.  The CPU (scipy) finds one strongly connected component of 9,999
    nodes and one source, before and after the delete, so the closure is
    9,999 × 10,000 facts and the delete and the re-insert change none: both
    leave the CPU's closure words and the table as it was."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from repro_torch.core import bitmatrix
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.obs.trace import TRACER
    from repro_torch.serve_datalog import instance

    n = 10_000
    arc = gnp_graph(n, 0.001, seed=0).astype(np.int32)
    pick = np.sort(np.random.default_rng([0, 1]).choice(len(arc), round(len(arc) * 0.01),
                                                          replace=False))
    held = arc[pick]
    scc = []
    for edges in (arc, np.delete(arc, pick, axis=0)):
        g = csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
        _, label = connected_components(g, directed=True, connection="strong")
        sizes = np.bincount(label)
        assert sorted(sizes) == [1, n - 1] and (np.bincount(edges[:, 0], minlength=n) > 0).all()
        scc.append(label == sizes.argmax())
    assert (scc[0] == scc[1]).all()
    in_scc = torch.from_numpy(scc[0])
    want = pack_bits(in_scc[None, :]).expand(n, -1)        # every node reaches the component

    inst = MaterializedInstance(ALL["tc"].program, {"arc": arc}, EngineConfig(),
                                cache=PlanCache(), device=cuda)
    base, base_arc = inst.store["tc"], inst._bm[0].arc
    assert base.count == (n - 1) * n and torch.equal(inst._bm[0].m.cpu(), want)

    def refuse(*args, **kwargs):
        raise AssertionError("set_difference ran for the resident stratum")

    growth = []
    diff = bitmatrix.PackedStratum.diff

    def measured(self, old, domain, capacity_min):
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = diff(self, old, domain, capacity_min)
        growth.append(torch.cuda.max_memory_allocated() - start)
        return out

    monkeypatch.setattr(instance, "set_difference", refuse)
    monkeypatch.setattr(bitmatrix.PackedStratum, "diff", measured)
    TRACER.enable()
    try:
        st = inst.apply_txn([("delete", "arc", held)])
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    (span,) = [s for s in TRACER.spans() if s.name == "recompute.diff"]
    TRACER.clear()
    assert st.modes == {0: "full"} and (st.removed, st.retracted, st.derived) == (len(held), 0, 0)
    assert span.args == {"pred": "tc", "packed": True, "added": 0, "removed": 0}
    assert span.syncs <= 1
    assert len(growth) == 1 and growth[0] < 64 << 20
    st = inst.apply_txn([("insert", "arc", held)])
    torch.cuda.synchronize()
    assert st.modes == {0: "bitmatrix"} and (st.inserted, st.derived) == (len(held), 0)
    got = inst.store["tc"]
    assert (got.count, got.capacity) == (base.count, base.capacity)
    assert torch.equal(got.rows, base.rows)
    assert torch.equal(inst._bm[0].m.cpu(), want) and torch.equal(inst._bm[0].arc, base_arc)


def test_a_g10k_delete_that_cuts_the_closure_diffs_its_words_as_its_tables(cuda):
    """A 1 % delete that takes facts from a G10K closure (``chip_smoke.py``'s
    ``serve_tc_pbme_delete`` instance): the resident stratum's word diff gives
    the rows, count and capacity that ``_diff`` gives from the two tables,
    and the published table is a fresh evaluation's."""
    from repro_torch.data.graphs import gnp_graph

    arc = gnp_graph(10_000, 0.001, seed=1).astype(np.int32)
    k = len(arc) // 100
    inst = MaterializedInstance(ALL["tc"].program, {"arc": arc}, EngineConfig(),
                                cache=PlanCache(), device=cuda)
    old_bm, old_table = inst._bm[0], inst.store["tc"]
    st = inst.apply_txn([("delete", "arc", arc[-k:])])
    assert st.modes == {0: "full"} and st.retracted > 0
    table = inst.store["tc"]
    (added, removed) = inst._bm[0].diff(old_bm, inst.domain, inst.engine.config.capacity_min)
    (fresh, gone) = inst._diff(old_table, table, inst.domain)
    assert added is None and fresh is None
    assert removed[1] == gone.count == st.retracted and torch.equal(removed[0], gone.rows)
    engine = Engine(EngineConfig(), device=cuda)
    engine.run(ALL["tc"].program, {"arc": arc[:-k]}, return_numpy=False)
    want = engine.take_store()["tc"]
    assert (table.count, table.capacity) == (want.count, want.capacity)
    assert torch.equal(table.rows, want.rows)
