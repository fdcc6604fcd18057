"""The GNN slice: ``repro_torch.models.gnn``, ``relational.sampler``, the
graph generators and the registry's GNN entries against ``repro``'s, on the
CPU.

Inputs are made with numpy from seeds and handed to both packages; the
reference's functions run under ``jax.jit``.  The generators, ``build_csr``
and the sampler given the reference's draws are held bit for bit.  The
models run at their SMOKE configs on ``tests/test_models_smoke.py``'s graph
batches, the reference's ``init_params`` weights carried over by
``interop.gnn_params_from_reference``: forward, loss and every gradient
leaf within 1e-5 of the output's or the leaf's largest absolute value in
float32, and three ``make_train_step`` steps within 1e-5 (loss, global norm
and learning rate relative, params absolute; Adam's lr · sign(g) would
magnify float32 noise in a gradient entry that cancels, so the port's
update is fed the reference's gradients once its own are held against them).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import repro.train as ref_train
from repro.configs import registry as ref_registry
from repro.data import graphs as ref_graphs
from repro.models.gnn import common as ref_common
from repro.models.gnn.common import GraphBatch as RefGraphBatch
from repro.relational import sampler as ref_sampler
from repro_torch.configs import registry
from repro_torch.data import graphs
from repro_torch.interop import (
    gnn_params_from_reference,
    gnn_params_to_reference,
    graph_batch_from_reference,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.models.gnn import MODELS, common
from repro_torch.relational import sampler
from repro_torch.train import make_train_step
from repro_torch.train import step as train_step_mod

ARCHS = list(ref_registry.GNN_ARCHS)
TOL = 1e-5
SCHEDULE = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)


def ref_model(arch):
    return importlib.import_module(f"repro.models.gnn.{ref_registry.GNN_ARCHS[arch][1]}")


def rel_close(got, want, tol=TOL):
    """|got − want| ≤ tol · max |want|, elementwise over the whole output."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30) if want.size else 0
    assert err <= tol, err


def graph_batch(arch, cfg, rng):
    """``tests/test_models_smoke.py``'s ``_graph_batch``, in numpy."""
    if arch == "schnet":
        feats, s, r, gids, pos = ref_graphs.batched_molecules(4, 8, 16, cfg.d_in)
        labels = rng.standard_normal((4, cfg.d_out)).astype(np.float32)
        return RefGraphBatch(feats, s, r, None, pos, gids, labels)
    n, e = 60, 240
    s, r = ref_graphs.grid_mesh_graph(n, e)
    feats = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    if cfg.task == "node_class":
        labels = rng.integers(0, cfg.d_out, n).astype(np.int32)
    else:
        labels = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    edge_feat = rng.standard_normal((e, cfg.d_edge)).astype(np.float32) if cfg.d_edge else None
    pos = rng.standard_normal((n, 3)).astype(np.float32) if arch == "graphcast" else None
    return RefGraphBatch(feats, s, r, edge_feat, pos, None, labels)


def padded(g: RefGraphBatch, extra: int, rng) -> RefGraphBatch:
    """``g`` with ``extra`` padded edges (-1 senders and receivers) spread
    among the real ones, and their edge features random."""
    e = len(g.senders) + extra
    keep = np.sort(rng.choice(e, len(g.senders), replace=False))
    snd, rcv = np.full(e, -1, np.int32), np.full(e, -1, np.int32)
    snd[keep], rcv[keep] = g.senders, g.receivers
    ef = None
    if g.edge_feat is not None:
        ef = rng.standard_normal((e, g.edge_feat.shape[1])).astype(np.float32)
        ef[keep] = g.edge_feat
    return g._replace(senders=snd, receivers=rcv, edge_feat=ef)


def to_jax(g: RefGraphBatch) -> RefGraphBatch:
    return RefGraphBatch(*(None if f is None else jnp.asarray(f) for f in g))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref_cfg = ref_registry.arch_config(arch, smoke=True)
    cfg = registry.arch_config(arch, smoke=True)
    ref_p = ref_model(arch).init_params(jax.random.PRNGKey(0), ref_cfg)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, ref_p), cfg, "cpu")
    return arch, ref_cfg, cfg, ref_p, params


# -- generators, CSR and the sampler ------------------------------------------------


@pytest.mark.parametrize("n,e,seed", [(60, 240, 0), (100, 250, 3), (50, 30, 1), (7, 7, 2)])
def test_grid_mesh_graph_bit_for_bit(n, e, seed):
    got, want = graphs.grid_mesh_graph(n, e, seed), ref_graphs.grid_mesh_graph(n, e, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("args", [(4, 8, 16, 8, 0), (3, 30, 64, 32, 5)])
def test_batched_molecules_bit_for_bit(args):
    for g, w in zip(graphs.batched_molecules(*args), ref_graphs.batched_molecules(*args)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_csr_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    for g, w in zip(sampler.build_csr(src, dst, 45), ref_sampler.build_csr(src, dst, 45)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _csr_graph(seed, n=50, m=300):
    """A CSR over ``m`` random edges of ``n`` nodes; every fifth node has no
    in-edge, so some frontier nodes sample nothing."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    dst = np.where(dst % 5 == 0, (dst + 1) % n, dst)
    return n, src, dst, sampler.build_csr(src, dst, n)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_blocks_equal_the_reference_under_its_draws(seed):
    """Each layer's draws are the reference's ``jax.random.randint`` on the
    key it splits off; given them, every block is the reference's."""
    n, _, _, (row_ptr, col) = _csr_graph(seed)
    fanouts = (7, 3)
    ref = ref_sampler.NeighborSampler(row_ptr, col, fanouts)
    port = sampler.NeighborSampler(row_ptr, col, fanouts, device="cpu")
    seeds = np.random.default_rng(seed + 1).integers(0, n, 16).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = ref.sample(key, jnp.asarray(seeds))
    frontier = torch.as_tensor(seeds)
    for fanout, block in zip(fanouts, want):
        key, sub = jax.random.split(key)
        u = jax.random.randint(sub, (frontier.shape[0], fanout), 0, jnp.iinfo(jnp.int32).max)
        got = port.sample_layer(frontier, fanout, torch.as_tensor(np.array(u)))
        for name, g, w in zip(block._fields, got, block):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name
        assert not got.mask.all() and got.mask.any()
        frontier = torch.where(got.mask, got.src, 0)


def test_sampler_draws_valid_neighbors():
    """``tests/test_relational.py``'s property on the port's own draws: every
    masked-in slot holds an in-neighbor of its frontier node, and a slot is
    masked out exactly where the node has none; each layer's frontier is the
    last one's slots."""
    n, src, dst, (row_ptr, col) = _csr_graph(3)
    in_nbrs = {v: set(src[dst == v].tolist()) for v in range(n)}
    samp = sampler.NeighborSampler(row_ptr, col, (7, 3), device="cpu")
    seeds = torch.as_tensor(np.random.default_rng(0).integers(0, n, 16).astype(np.int32))
    blocks = samp.sample(torch.Generator().manual_seed(0), seeds)
    assert len(blocks) == 2 and torch.equal(blocks[0].nodes, seeds)
    assert torch.equal(blocks[1].nodes, torch.where(blocks[0].mask, blocks[0].src, 0))
    for block, fanout in zip(blocks, (7, 3)):
        k = block.nodes.shape[0]
        s, m = block.src.reshape(k, fanout).numpy(), block.mask.reshape(k, fanout).numpy()
        assert block.src.dtype == block.dst.dtype == torch.int32
        assert np.array_equal(block.dst.reshape(k, fanout).numpy(),
                              np.repeat(np.arange(k), fanout).reshape(k, fanout))
        for i, v in enumerate(block.nodes.tolist()):
            for j in range(fanout):
                if m[i, j]:
                    assert s[i, j] in in_nbrs[v]
                else:
                    assert not in_nbrs[v] and s[i, j] == -1
    again = samp.sample(torch.Generator().manual_seed(0), seeds)
    assert all(torch.equal(a.src, b.src) for a, b in zip(blocks, again))


def test_sampler_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sampler runs on it")
    _, _, _, (row_ptr, col) = _csr_graph(0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sampler.NeighborSampler(row_ptr, col, (2,))


# -- the shared helpers --------------------------------------------------------------


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_scatter_edges_with_masked_edges_and_empty_segments(agg):
    rng = np.random.default_rng(4)
    e, n = 40, 12
    msgs = rng.standard_normal((e, 5)).astype(np.float32)
    recv = rng.integers(0, n - 3, e).astype(np.int32)         # the last 3 nodes receive nothing
    mask = rng.random(e) < 0.7
    recv = np.where(mask, recv, -1)                           # padded edges carry -1
    want = ref_common.scatter_edges(jnp.asarray(msgs), jnp.asarray(recv), n,
                                    jnp.asarray(mask), agg)
    got = common.scatter_edges(torch.as_tensor(msgs), torch.as_tensor(recv), n,
                               torch.as_tensor(mask), agg)
    rel_close(got, want)
    assert not got[-3:].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("with_ids", [True, False])
def test_graph_pool(mode, with_ids):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    ids = np.sort(rng.integers(0, 4, 20)).astype(np.int32) if with_ids else None
    want = ref_common.graph_pool(jnp.asarray(x), None if ids is None else jnp.asarray(ids),
                                 5, mode)
    got = common.graph_pool(torch.as_tensor(x), None if ids is None else torch.as_tensor(ids),
                            5, mode)
    rel_close(got, want)


# -- the four models -------------------------------------------------------------


@pytest.mark.parametrize("pad", [0, 37], ids=["unpadded", "padded"])
def test_forward_loss_and_gradients(pair, pad):
    arch, ref_cfg, cfg, ref_p, params = pair
    rng = np.random.default_rng(0)
    g = graph_batch(arch, ref_cfg, rng)
    if pad:
        g = padded(g, pad, rng)
    ref = ref_model(arch)
    want = jax.jit(ref.forward, static_argnums=2)(ref_p, to_jax(g), ref_cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.loss), static_argnums=2)(
        ref_p, to_jax(g), ref_cfg)
    gb = graph_batch_from_reference(g, "cpu")
    model = MODELS[cfg.arch]
    rel_close(model.forward(params, gb, cfg), want)
    loss, grads = train_step_mod.value_and_grad(model.loss, params, gb, cfg)
    rel_close(loss, want_loss)
    want_grads = dict(jax.tree_util.tree_flatten_with_path(want_grads)[0])
    got_grads = jax.tree_util.tree_flatten_with_path(gnn_params_to_reference(grads))[0]
    assert len(got_grads) == len(want_grads)
    for path, leaf in got_grads:
        rel_close(leaf, want_grads[path])
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(grads))


def test_train_steps_match_the_reference(pair, monkeypatch):
    arch, ref_cfg, cfg, ref_p, _ = pair
    g = graph_batch(arch, ref_cfg, np.random.default_rng(1))
    ref = ref_model(arch)
    ref_state = ref_train.init_train_state(ref_p)
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state), "cpu")
    ref_step = ref_train.make_train_step(ref.loss, ref_cfg, donate=False, **SCHEDULE)
    ref_grads = jax.jit(jax.grad(ref.loss), static_argnums=2)
    step = make_train_step(MODELS[cfg.arch].loss, cfg, **SCHEDULE)
    real = train_step_mod.value_and_grad
    gb = graph_batch_from_reference(g, "cpu")

    for _ in range(3):
        want = jax.tree.map(np.asarray, ref_grads(ref_state.params, to_jax(g), ref_cfg))

        def fed(*args, **kwargs):
            loss, grads = real(*args, **kwargs)
            got = dict(jax.tree_util.tree_flatten_with_path(gnn_params_to_reference(grads))[0])
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
                rel_close(got[path], leaf)
            return loss, gnn_params_from_reference(want, cfg, "cpu")

        monkeypatch.setattr(train_step_mod, "value_and_grad", fed)
        state, metrics = step(state, gb)
        ref_state, ref_metrics = ref_step(ref_state, to_jax(g))
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=TOL,
                                       err_msg=k)
    got_params, _, step_no = train_state_to_reference(state)
    want_params = dict(jax.tree_util.tree_flatten_with_path(ref_state.params)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(got_params)[0]:
        np.testing.assert_allclose(leaf, np.asarray(want_params[path]), atol=TOL, rtol=0,
                                   err_msg=str(path))
    assert int(step_no) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own draws have the reference's tree, shapes and dtypes (at
    FULL width, on the meta device), and round-trip through ``interop``."""
    cfg = registry.arch_config(arch)
    port = MODELS[cfg.arch].init_params(cfg, torch.Generator(), device="meta")
    ref = jax.eval_shape(lambda: ref_model(arch).init_params(jax.random.PRNGKey(0),
                                                             ref_registry.arch_config(arch)))
    got = {jax.tree_util.keystr(p): tuple(t.shape)
           for p, t in jax.tree_util.tree_flatten_with_path(port)[0]}
    want = {jax.tree_util.keystr(p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    small = registry.arch_config(arch, smoke=True)
    params = MODELS[small.arch].init_params(small, torch.Generator().manual_seed(1), device="cpu")
    back = gnn_params_from_reference(gnn_params_to_reference(params), small, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(back)))
    bad = gnn_params_to_reference(params)
    bad[next(iter(bad))] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="gnn_params_from_reference"):
        gnn_params_from_reference(bad, small, "cpu")


def test_models_run_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the models run on it")
    for arch in ARCHS:
        cfg = registry.arch_config(arch, smoke=True)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            MODELS[cfg.arch].init_params(cfg)


def test_graphcast_without_positions_takes_a_linspace_mesh():
    """With ``pos`` absent the mesh's positions are a float32 ``linspace``,
    and ``cfg.mesh_nodes`` sets the mesh's size."""
    ref_cfg = ref_registry.arch_config("graphcast", smoke=True)
    cfg = registry.arch_config("graphcast", smoke=True)
    ref_p = ref_model("graphcast").init_params(jax.random.PRNGKey(3), ref_cfg)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, ref_p), cfg, "cpu")
    g = graph_batch("graphcast", ref_cfg, np.random.default_rng(2))._replace(pos=None)
    for mesh_nodes in (0, 9):
        rc, c = (dataclasses.replace(x, mesh_nodes=mesh_nodes) for x in (ref_cfg, cfg))
        want = jax.jit(ref_model("graphcast").forward, static_argnums=2)(ref_p, to_jax(g), rc)
        rel_close(MODELS["graphcast"].forward(params, graph_batch_from_reference(g, "cpu"), c),
                  want)


# -- the registry ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_registry.ALL_ARCHS)
def test_every_arch_resolves_to_the_reference_config(arch):
    for smoke in (False, True):
        want = ref_registry.arch_config(arch, smoke=smoke)
        got = registry.arch_config(arch, smoke=smoke)
        assert type(got).__name__ == type(want).__name__
        fields = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == fields
        for name in fields:
            a, b = getattr(got, name), getattr(want, name)
            if name in ("dtype", "param_dtype") and not isinstance(a, str):
                a, b = str(a).split(".")[-1], np.dtype(b).name
            assert a == b, name
    assert registry.shapes_for(arch) == ref_registry.shapes_for(arch)


def test_cells_shapes_and_flops_equal_the_reference():
    assert registry.ALL_ARCHS == ref_registry.ALL_ARCHS
    assert registry.all_cells() == ref_registry.all_cells()
    assert registry._LM_SHAPE_DEFS == ref_registry._LM_SHAPE_DEFS
    assert registry._GNN_SHAPE_DEFS == ref_registry._GNN_SHAPE_DEFS
    for arch in ref_registry.LM_ARCHS:
        for tokens in (4096, 256 * 4096):
            assert registry._lm_train_flops(registry.arch_config(arch), tokens) == \
                ref_registry._lm_train_flops(ref_registry.arch_config(arch), tokens)
    for arch in ref_registry.GNN_ARCHS:
        for shape in ref_registry._GNN_SHAPE_DEFS.values():
            args = (shape["n"], shape["e"])
            assert registry._gnn_flops(arch, registry.arch_config(arch), *args) == \
                ref_registry._gnn_flops(arch, ref_registry.arch_config(arch), *args)
    with pytest.raises(KeyError, match="gcn-cora"):
        registry.arch_config("gcn")
