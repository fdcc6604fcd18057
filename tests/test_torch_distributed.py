"""The distributed layer on gloo: the port's sharded paths against ``repro``'s.

One module fixture makes the inputs with numpy from seeds, then runs, side
by side, 8 gloo ranks of the port as a (4, 2) ``("data", "model")`` mesh
(``tests/torch_dist_worker.py``, joined through a ``file://`` store in the
fixture's temporary directory, never a fixed port) and one JAX process with
8 virtual devices on the same mesh (``tests/torch_dist_reference.py``).

Tolerances: sharded TC bit for bit with equal iterations; ``sharded_bags``,
``loss_sharded``'s value and gradients 1e-5 (float32 sums in another order);
compressed DP 1e-4 on params after 3 steps against the reference (int8
rounding of gradients that differ in the last bits can move a level), and
below 1e-3 from the port's own uncompressed step on the same objective.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import adj_of, tc_oracle
from repro.core.distributed import padded_n as ref_padded_n
from repro.data.recsys_stream import RecsysStream
from repro_torch.core.distributed import SCHEDULES, padded_n
from repro_torch.distributed import make_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TC_N, TC_SEEDS = 60, (0, 1, 2)
CFG = dict(user_vocab=64, item_vocab=32, embed_dim=8, tower_dims=[16, 8], user_fields=2,
           item_fields=2, field_hots=3, n_dense_feat=4)
MLP_KEYS = ["w0", "b0", "w1", "b1"]
DP_STEPS = 3
DP_SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
TOL = 1e-5


def make_inputs(work: Path) -> None:
    data = {}
    for seed in TC_SEEDS:          # seed 0: tests/test_distributed.py's graph
        rng = np.random.default_rng(seed)
        data[f"tc_edges_{seed}"] = np.unique(
            rng.integers(0, TC_N, size=(150, 2)), axis=0).astype(np.int32)
    rng = np.random.default_rng(1)
    d = CFG["embed_dim"]
    data["p/user_table"] = (rng.standard_normal((CFG["user_vocab"], d)) * 0.01).astype(np.float32)
    data["p/item_table"] = (rng.standard_normal((CFG["item_vocab"], d)) * 0.01).astype(np.float32)
    for name, d_in in (("user_mlp", CFG["user_fields"] * d + CFG["n_dense_feat"]),
                       ("item_mlp", CFG["item_fields"] * d)):
        dims = [d_in] + CFG["tower_dims"]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            data[f"p/{name}/w{i}"] = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
            data[f"p/{name}/b{i}"] = (rng.standard_normal(b) * 0.1).astype(np.float32)
    data["bag_ids"] = rng.integers(-1, CFG["user_vocab"], size=(8, 2, 3)).astype(np.int32)
    stream = RecsysStream(CFG["user_vocab"], CFG["item_vocab"], CFG["user_fields"],
                          CFG["item_fields"], CFG["field_hots"], CFG["n_dense_feat"],
                          batch=16, seed=0)
    for prefix, step in [("loss", 100)] + [(f"dp/{i}", i) for i in range(DP_STEPS)]:
        for k, v in stream.batch(step).items():
            data[f"{prefix}/{k}"] = v
    np.savez(work / "inputs.npz", **data)
    (work / "inputs.json").write_text(json.dumps(dict(
        cfg=CFG, mlp_keys=MLP_KEYS, tc_n=TC_N, tc_seeds=list(TC_SEEDS), dp_steps=DP_STEPS,
        dp_schedule=DP_SCHEDULE)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    make_inputs(work)
    src = str(ROOT / "src")
    ref_env = {**os.environ, "PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    rank_env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests/torch_dist_reference.py"),
                               str(work)], env=ref_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, str(ROOT / "tests/torch_dist_worker.py"),
                                str(r), str(WORLD), str(work / "store"), str(work)],
                               env=rank_env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ref = dict(np.load(work / "reference.npz"))
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, ranks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _grad_keys(ref, variant):
    return sorted(k for k in ref if k.startswith(f"loss/{variant}/grad/"))


def _block(arr, ranks_coord, key, rows_over):
    """This rank's rows of a global array: over ``model`` for a table's vocab
    block, over ``data`` (then ``model``) for a batch's rows."""
    data_i, model_j = (int(c) for c in ranks_coord)
    if rows_over == "model":
        n = arr.shape[0] // 2
        return arr[model_j * n:(model_j + 1) * n]
    if rows_over == "data":
        n = arr.shape[0] // 4
        return arr[data_i * n:(data_i + 1) * n]
    n = arr.shape[0] // 8
    return arr[(data_i * 2 + model_j) * n:(data_i * 2 + model_j + 1) * n]


@pytest.mark.parametrize("n,rows,cols", [(60, 4, 2), (10_000, 1, 1), (1000, 8, 1),
                                         (129, 1, 4), (5000, 2, 8)])
def test_padded_n_matches_reference(n, rows, cols):
    assert padded_n(n, rows, cols) == ref_padded_n(n, rows, cols)


def test_make_mesh_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() builds on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")


def test_ranks_hold_the_mesh(runs):
    _, ranks = runs
    coords = sorted(tuple(int(c) for c in r["coord"]) for r in ranks)
    assert coords == [(i, j) for i in range(4) for j in range(2)]
    assert [tuple(r["coord"]) for r in ranks] == [(r // 2, r % 2) for r in range(WORLD)]


@pytest.mark.parametrize("seed", TC_SEEDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_tc_matches_reference(runs, schedule, seed):
    ref, ranks = runs
    want = ref[f"tc/{schedule}/{seed}/m"]
    n_pad = padded_n(TC_N, 4, 2)
    assert want.shape == (n_pad, n_pad // 32)
    for r in ranks:
        got = r[f"tc/{schedule}/{seed}/m"]
        assert got.dtype == np.int32
        assert np.array_equal(got.view(np.uint32), want)
        assert int(r[f"tc/{schedule}/{seed}/iters"]) == int(ref[f"tc/{schedule}/{seed}/iters"])
        blocks = {"rows1d": (n_pad // 4, n_pad // 32)}
        assert tuple(r[f"tc/{schedule}/{seed}/block"]) == blocks.get(
            schedule, (n_pad // 4, n_pad // 64))
    # and the closure itself
    edges = np.unique(np.random.default_rng(seed).integers(0, TC_N, size=(150, 2)), axis=0)
    dense = np.unpackbits(want.view(np.uint8), bitorder="little").reshape(n_pad, n_pad)
    assert np.array_equal(dense[:TC_N, :TC_N], tc_oracle(adj_of(edges, TC_N)))
    assert not dense[TC_N:].any() and not dense[:, TC_N:].any()


def test_sharded_tc_collective_bytes(runs):
    """Per rank and iteration, from the blocks' sizes: Δ's full rows
    (128 rows × 16 words) gathered, New's column block (128 × 256 float32
    counts) reduce-scattered, and the int64 count summed."""
    _, ranks = runs
    for r in ranks:
        assert int(r["tc/allgather/bytes/all_gather"]) == 128 * 16 * 4
        assert int(r["tc/psum/bytes/reduce_scatter"]) == 128 * 256 * 4
        assert not any(k.startswith("tc/rows1d/bytes/") and not k.endswith("all_reduce")
                       for k in r)
        for sched in SCHEDULES:
            assert int(r[f"tc/{sched}/bytes/all_reduce"]) == 8


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["psum", "scatter"])
def test_sharded_bags_match_reference(runs, variant, wire):
    """Bags summed over ``model`` in float32, or with a bfloat16 payload
    (``wire_dtype``): then within one bfloat16 step (2**-8) of the largest
    bag entry, as two bfloat16 partials summed in another order may round
    apart."""
    ref, ranks = runs
    key = f"bags/{variant}" + ("_bf16" if wire == "bfloat16" else "")
    want = ref[key]
    assert want.shape == (8, 2, CFG["embed_dim"]) and want.dtype == np.float32
    tol = TOL if wire == "float32" else 2.0 ** -8 * float(np.abs(want).max())
    for r in ranks:
        rows = "data" if variant == "psum" else "data+model"
        np.testing.assert_allclose(r[key], _block(want, r["coord"], None, rows), atol=tol,
                                   rtol=0 if wire == "bfloat16" else TOL)


def test_reference_sharded_gradient_equals_its_unsharded_one(runs):
    """The reference's ``shard_map`` runs with ``check_vma=False``; its psum
    transpose does not scale the cotangent: the sharded gradients equal the
    unsharded ones, so the port's collectives take the unscaled transposes."""
    ref, _ = runs
    for variant in ("psum", "scatter"):
        _close(ref[f"loss/{variant}/value"], ref["loss/unsharded/value"])
        for key in _grad_keys(ref, variant):
            want = ref[key.replace(variant, "unsharded", 1)]
            np.testing.assert_allclose(ref[key], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", ["psum", "scatter"])
def test_loss_sharded_value_and_gradients_match_reference(runs, variant):
    ref, ranks = runs
    keys = _grad_keys(ref, variant)
    assert len(keys) == 2 + 2 * len(MLP_KEYS)
    for r in ranks:
        _close(r[f"loss/{variant}/value"], ref[f"loss/{variant}/value"])
        assert sorted(k for k in r if k.startswith(f"loss/{variant}/grad/")) == keys
        for key in keys:
            want = ref[key]
            if key.endswith("_table"):
                want = _block(want, r["coord"], key, "model")
            _close(r[key], want)


def test_serve_scores_on_the_mesh_match_reference(runs):
    """``serve_scores(..., mesh=)``: the global batch's scores on every rank,
    within 1e-4 (tower outputs ÷ the temperature 0.05)."""
    ref, ranks = runs
    assert ref["serve"].shape == (16,)
    np.testing.assert_allclose(ref["serve"], ref["serve/unsharded"], atol=1e-4, rtol=1e-4)
    for r in ranks:
        np.testing.assert_allclose(r["serve"], ref["serve"], atol=1e-4, rtol=1e-4)


def test_compressed_dp_matches_reference(runs):
    ref, ranks = runs
    keys = sorted(k for k in ref if k.startswith("dp/params/"))
    assert len(keys) == 2 + 2 * len(MLP_KEYS)
    for r in ranks:
        for i in range(DP_STEPS):
            _close(r[f"dp/loss/{i}"], ref[f"dp/loss/{i}"])
        for key in keys:
            np.testing.assert_allclose(r[key], ref[key], atol=1e-4, rtol=0)


def test_compressed_dp_tracks_uncompressed(runs):
    """``tests/test_distributed.py``'s property at the reference's default
    schedule: compressed and uncompressed steps on the same objective (the
    mean of the data shards' losses) stay within 1e-3."""
    _, ranks = runs
    for r in ranks:
        keys = [k for k in r if k.startswith("dp_default/params/")]
        assert len(keys) == 2 + 2 * len(MLP_KEYS)
        diff = max(float(np.abs(r[k] - r[k.replace("/params/", "/plain/", 1)]).max())
                   for k in keys)
        assert diff < 1e-3
