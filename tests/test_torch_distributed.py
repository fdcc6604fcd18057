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

The sharded model forms, on the same ranks (and, for expert parallelism and
the halo GCN, again as a (2, 4) mesh, the reference's ``mesh2``): the
expert-parallel MoE's output within 1e-5 of the reference's and of the
dense dispatch, its aux within 1e-6 of the reference's EP aux; the sharded
LM step's first gradients within 1e-5 of each leaf's largest entry, its
params after 3 steps within 1e-4 (Adam's lr · sign(g) can move a last-bit
gradient by lr); the MoE's loss and gradients with and without
``mesh_context`` within 1e-5; the halo GCN's loss and gradients within
1e-5; ``ppermute`` exact, forward and backward.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten_with_path

from conftest import adj_of, tc_oracle
from repro.core.distributed import padded_n as ref_padded_n
from repro.data.recsys_stream import RecsysStream
from repro.data.tokens import TokenStream
from repro_torch.core.distributed import SCHEDULES, padded_n
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import _path_names
from repro_torch.models import transformer as tf
from torch_parity import ring_lattice

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TC_N, TC_SEEDS = 60, (0, 1, 2)
CFG = dict(user_vocab=64, item_vocab=32, embed_dim=8, tower_dims=[16, 8], user_fields=2,
           item_fields=2, field_hots=3, n_dense_feat=4)
MLP_KEYS = ["w0", "b0", "w1", "b1"]
DP_STEPS = 3
DP_SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
TOL = 1e-5
# tests/test_distributed.py's two LM configs: dense, and MoE with a shared expert
LM_CFGS = {
    "dense": dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                  vocab=64, dtype="float32", param_dtype="float32"),
    "moe": dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                vocab=64, moe=True, n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=16,
                dtype="float32", param_dtype="float32"),
}
LM_STEPS = 3
MESH2 = (2, 4)                 # the reference test's mesh2
GCN_CFG = dict(n_layers=2, d_hidden=16, d_in=12, d_out=5)
HALO = dict(n=64, width=3, halo=4, e_loc=256)


def lm_param_names(cfg) -> dict:
    """{path names: leaf} of the port's params of ``cfg`` (the reference's
    layout and names)."""
    params = tf.init_params(tf.TransformerConfig(**cfg), torch.Generator().manual_seed(7),
                            device="cpu")
    return {"/".join(_path_names(path)): leaf
            for path, leaf in tree_flatten_with_path(params)[0]}


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
    for name, cfg in LM_CFGS.items():
        for path, leaf in lm_param_names(cfg).items():
            data[f"lm/{name}/{path}"] = leaf.numpy()
    rng = np.random.default_rng(8)
    data["ep_tokens"] = rng.integers(0, 64, size=(4, 8)).astype(np.int32)
    stream = TokenStream(64, batch=8, seq_len=16, seed=0)
    for i in range(LM_STEPS):
        for k, v in stream.batch(i).items():
            data[f"lm_batch/{i}/{k}"] = v
    rng = np.random.default_rng(9)
    for shards in (4, MESH2[0]):
        feats, snd, rcv, labels = ring_lattice(HALO["n"], HALO["width"], shards, HALO["halo"],
                                               HALO["e_loc"], rng)
        for k, v in (("feats", feats), ("senders", snd), ("receivers", rcv),
                     ("labels", labels)):
            data[f"halo/{shards}/{k}"] = v
    dims = [GCN_CFG["d_in"], GCN_CFG["d_hidden"], GCN_CFG["d_out"]]
    for i in range(2):
        data[f"gcn/w{i}"] = (rng.standard_normal((dims[i], dims[i + 1]))
                             / np.sqrt(dims[i])).astype(np.float32)
    np.savez(work / "inputs.npz", **data)
    (work / "inputs.json").write_text(json.dumps(dict(
        cfg=CFG, mlp_keys=MLP_KEYS, tc_n=TC_N, tc_seeds=list(TC_SEEDS), dp_steps=DP_STEPS,
        dp_schedule=DP_SCHEDULE, lm_cfgs=LM_CFGS, lm_steps=LM_STEPS, mesh2=list(MESH2),
        gcn_cfg=GCN_CFG, halo=HALO)))


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


# -- the sharded model forms ---------------------------------------------------------


def _coord_block(arr, coord, shape):
    """The rows of ``arr`` that a rank at ``coord`` of a ``shape`` mesh holds
    over ``data``."""
    n = arr.shape[0] // shape[0]
    return arr[int(coord[0]) * n:(int(coord[0]) + 1) * n]


def _rel_close(got, want, tol=TOL):
    """Within ``tol`` of the largest entry of ``want``."""
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_ep_moe_matches_reference_and_dense(runs, mesh):
    """The expert-parallel output, whole stacks narrowed or stacks cut by
    ``place``, equals the reference's and the dense dispatch's; the aux
    equals the reference's EP aux (``tests/test_distributed.py``'s ``cfg_m``)."""
    ref, ranks = runs
    shape = (4, 2) if mesh == "4x2" else MESH2
    for key in ("ep/dense/out", "ep/dense/aux"):
        for r in ranks:
            _close(r[key], ref[key])
    for r in ranks:
        coord = r[f"ep/{mesh}/coord"]
        for key in ("out", "out_cut"):
            got = r[f"ep/{mesh}/{key}"]
            _close(got, _coord_block(ref[f"ep/{mesh}/out"], coord, shape))
            _close(got, _coord_block(r["ep/dense/out"], coord, shape))
        np.testing.assert_allclose(r[f"ep/{mesh}/aux"], ref[f"ep/{mesh}/aux"], atol=1e-6,
                                   rtol=0)


def test_ep_aux_differs_from_dense_aux_at_dp_above_one(runs):
    """A trait of the reference that the port keeps: the EP aux is the mean
    over data blocks of each block's density × router mean, not the
    product over the whole batch, so at dp > 1 both packages' EP aux
    differ from their dense aux by the same amount."""
    ref, ranks = runs
    for mesh in ("4x2", "2x4"):
        gap = float(ref[f"ep/{mesh}/aux"] - ref["ep/dense/aux"])
        assert abs(gap) > 1e-4
        for r in ranks:
            np.testing.assert_allclose(float(r[f"ep/{mesh}/aux"] - r["ep/dense/aux"]), gap,
                                       atol=1e-6)


def test_sharded_lm_step_matches_reference(runs):
    """``make_sharded_train_step`` against ``jit(make_train_step, in_shardings=)``
    on the dense config at (4, 2): first gradients within 1e-5 of each leaf's
    largest entry, losses and global norms within 1e-5, gathered params
    after 3 steps within 1e-4."""
    ref, ranks = runs
    grads = sorted(k for k in ref if k.startswith("step/grad/"))
    params = sorted(k for k in ref if k.startswith("step/params/"))
    assert len(grads) == len(params) > 10
    for r in ranks:
        _close(r["step/grad_loss"], ref["step/grad_loss"])
        for key in grads:
            _rel_close(r[key], ref[key])
        for i in range(LM_STEPS):
            _close(r[f"step/loss/{i}"], ref[f"step/loss/{i}"])
            _close(r[f"step/gnorm/{i}"], ref[f"step/gnorm/{i}"])
        for key in params:
            np.testing.assert_allclose(r[key], ref[key], atol=1e-4, rtol=0)


@pytest.mark.parametrize("form", ["ep", "gspmd"])
def test_sharded_moe_loss_and_gradients_match_reference(runs, form):
    """``cfg_m`` through ``sharded_value_and_grad`` at (4, 2): under
    ``mesh_context`` (the EP form, its aux) and without it (dense dispatch
    on gathered stacks, the whole batch's aux: GSPMD's), each against the
    reference's value and gradients of the same form."""
    ref, ranks = runs
    keys = sorted(k for k in ref if k.startswith(f"moe/{form}/grad/"))
    assert any(k.endswith("ffn/w_gate") for k in keys)
    for r in ranks:
        _close(r[f"moe/{form}/loss"], ref[f"moe/{form}/loss"])
        for key in keys:
            _rel_close(r[key], ref[key])


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_halo_gcn_matches_reference(runs, mesh):
    """``loss_halo`` on a ring lattice cut into data blocks (a ring of 4,
    and of 2, where both halo messages go to one peer): the loss and the
    weights' gradients on every rank equal the reference's."""
    ref, ranks = runs
    keys = sorted(k for k in ref if k.startswith(f"halo/{mesh}/grad/"))
    assert len(keys) == 2
    for r in ranks:
        _close(r[f"halo/{mesh}/loss"], ref[f"halo/{mesh}/loss"])
        for key in keys:
            _rel_close(r[key], ref[key])


@pytest.mark.parametrize("axis,size", [("model", 2), ("data", 4)])
def test_ppermute_and_its_inverse_transpose(runs, axis, size):
    """Along a ring: each rank gets its predecessor's ``x`` and, as the
    gradient of ``sum(w · y)``, its successor's ``w``."""
    _, ranks = runs

    def peer(r, step):
        coord = [int(c) for c in r["coord"]]
        dim = 0 if axis == "data" else 1
        coord[dim] = (coord[dim] + step) % size
        return coord[0] * 2 + coord[1]

    for rank, r in enumerate(ranks):
        assert int(r[f"ppermute/{axis}/index"]) == int(r["coord"][0 if axis == "data" else 1])
        np.testing.assert_array_equal(r[f"ppermute/{axis}/y"],
                                      np.arange(3.0) + 10 * peer(r, -1))
        np.testing.assert_array_equal(r[f"ppermute/{axis}/grad"],
                                      np.arange(3.0) * (peer(r, 1) + 1))
