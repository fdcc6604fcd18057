"""The sharding rules, the production mesh and the registry's cells: the
port against ``repro``, without ranks (plus one gloo rank in this process).

The rules read only the mesh's axis sizes, so they are held against the
reference's ``lm_param_spec`` and ``_divisible`` at (1, 1), (4, 2),
(16, 16) and (2, 16, 16) on every leaf of the five LM configs' params and
train states (SMOKE, and FULL from ``jax.eval_shape`` against the port's
meta tensors), two-tower FULL, the four GNNs and ``tests/test_distributed.py``'s
tree; the reference gets an object that carries only the mesh's ``shape``.
The cells: every ``all_cells()`` entry built by both packages, compared
field by field (skip, bonus, note, MODEL_FLOPS, argument shapes and
dtypes, specs).  On one gloo rank, a (1, 1) mesh: the halo GCN on a ring of
one equals ``gcn.loss``, ``ppermute`` on a ring of one is a copy whose
backward is the identity, a cell's step equals the plain step, and the
production mesh refuses a world of the wrong size.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.utils._pytree import tree_flatten_with_path, tree_leaves, tree_map

from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_sharding
from repro.distributed.compat import make_mesh as ref_make_mesh
from repro.models import transformer as ref_tf
from repro.train import init_train_state as ref_init_state
from repro_torch.configs import registry
from repro_torch.distributed import (
    Sharding, batch_sharding, lm_param_spec, make_mesh, param_sharding, place, ppermute,
    replicated,
)
from repro_torch.distributed.sharding import _divisible, _path_names
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import MODELS, GraphBatch, gcn
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import value_and_grad
from torch_parity import ring_lattice

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": {"data": 1, "model": 1}, "4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jax_named(tree):
    return {"/".join(ref_sharding._path_names(path)): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_named(tree):
    """{path names: leaf}, leaving out ``None`` (a leaf in torch's trees)."""
    return {"/".join(_path_names(path)): leaf for path, leaf in tree_flatten_with_path(tree)[0]
            if leaf is not None}


def _ref_specs(tree, sizes):
    """The reference's ``param_sharding`` specs from its rules, at mesh sizes."""
    mesh = SimpleNamespace(shape=sizes)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = ref_sharding.lm_param_spec(path, leaf)
        if not ref_sharding._divisible(spec, leaf.shape, mesh):
            spec = P()
        out["/".join(ref_sharding._path_names(path))] = tuple(spec)
    return out


def _port_specs(tree, sizes):
    return {k: sh.spec for k, sh in _torch_named(param_sharding(tree, sizes)).items()}


@pytest.fixture(scope="module")
def cells():
    """Every cell built by both packages on a (1, 1) mesh."""
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    ref = {(a, s): ref_registry.build_cell(a, s, mesh) for a, s in ref_registry.all_cells()}
    port = {(a, s): registry.build_cell(a, s, MESHES["1x1"]) for a, s in registry.all_cells()}
    return ref, port


def _trees(cells):
    """(name, reference tree, port tree) for every tree the rules see."""
    ref, port = cells
    out = []
    for arch in registry.LM_ARCHS:
        out.append((f"{arch}/full/state", ref[arch, "train_4k"].args[0],
                    port[arch, "train_4k"].args[0]))
        out.append((f"{arch}/full/params", ref[arch, "prefill_32k"].args[0],
                    port[arch, "prefill_32k"].args[0]))
        smoke = ref_registry.arch_config(arch, smoke=True)
        ref_state = jax.eval_shape(
            lambda: ref_init_state(ref_tf.init_params(jax.random.PRNGKey(0), smoke)))
        port_state = init_train_state(tf.init_params(registry.arch_config(arch, smoke=True),
                                                     device="meta"))
        out.append((f"{arch}/smoke/state", ref_state, port_state))
    for arch in registry.GNN_ARCHS:
        out.append((f"{arch}/state", ref[arch, "molecule"].args[0],
                    port[arch, "molecule"].args[0]))
    out.append(("two-tower/full/state", ref["two-tower-retrieval", "train_batch"].args[0],
                port["two-tower-retrieval", "train_batch"].args[0]))
    small = {"embed": np.zeros((16, 8)),
             "layers": {"attn": {"wq": np.zeros((2, 8, 8)), "wo": np.zeros((2, 8, 8))},
                        "ffn": {"w_gate": np.zeros((2, 4, 8, 8))}}}
    out.append(("test_distributed", jax.tree.map(jax.numpy.asarray, small),
                tree_map(torch.as_tensor, small)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_reference(cells, mesh):
    sizes = MESHES[mesh]
    trees = _trees(cells)
    assert len(trees) == 3 * 5 + 4 + 2
    sharded = 0
    for name, ref_tree, port_tree in trees:
        want, got = _ref_specs(ref_tree, sizes), _port_specs(port_tree, sizes)
        assert got == want, name
        sharded += sum(1 for s in got.values() if s)
    assert sharded > 0


def test_rules_match_the_reference_test_and_fall_back_for_granite():
    """``tests/test_distributed.py::test_param_sharding_rules``, and granite's
    vocab 49155, which 16-way ``model`` does not divide: replicated."""
    params = {"embed": torch.zeros((16, 8)),
              "layers": {"attn": {"wq": torch.zeros((2, 8, 8)), "wo": torch.zeros((2, 8, 8))},
                         "ffn": {"w_gate": torch.zeros((2, 4, 8, 8))}}}
    sh = param_sharding(params, MESHES["1x1"])
    assert sh["embed"].spec == tuple(P("model", None))
    assert sh["layers"]["attn"]["wq"].spec == tuple(P(None, None, "model"))
    assert sh["layers"]["attn"]["wo"].spec == tuple(P(None, "model", None))
    assert sh["layers"]["ffn"]["w_gate"].spec == tuple(P(None, "model", None, None))
    granite = tf.init_params(registry.arch_config("granite-moe-1b-a400m"), device="meta")
    assert granite["embed"].shape[0] == 49155
    assert lm_param_spec([SimpleNamespace(key="embed")], granite["embed"]) == ("model", None)
    assert not _divisible(("model", None), granite["embed"].shape, MESHES["16x16"])
    assert param_sharding(granite, MESHES["16x16"])["embed"].spec == ()


def test_batch_and_replicated_specs_match_reference():
    mesh = ref_make_mesh((4, 2), ("data", "model"))
    batch = {"tokens": np.zeros((8, 16), np.int32), "step": np.zeros((), np.int32),
             "feat": np.zeros((8, 3, 5), np.float32)}
    ref_b = ref_sharding.batch_sharding(jax.tree.map(jax.numpy.asarray, batch), mesh)
    got = batch_sharding(tree_map(torch.as_tensor, batch), MESHES["4x2"])
    for k in batch:
        assert got[k].spec == tuple(ref_b[k].spec), k
    assert got["tokens"].spec == ("data", None)
    rep = replicated(tree_map(torch.as_tensor, batch), MESHES["4x2"])
    assert all(s.spec == () and s.mesh is MESHES["4x2"] for s in tree_leaves(rep))
    three = dict(MESHES["2x16x16"])
    assert batch_sharding({"x": torch.zeros(4)}, three)["x"].spec == (("pod", "data"),)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_cells_match_reference(cells):
    ref, port = cells
    assert len(ref) == len(port) == len(ref_registry.all_cells()) == 40
    assert list(port) == list(ref)
    for key, want in ref.items():
        got = port[key]
        for field in ("arch", "shape", "kind", "step", "skip", "bonus", "note"):
            assert getattr(got, field) == getattr(want, field), (key, field)
        np.testing.assert_allclose(got.model_flops, want.model_flops, rtol=1e-12)
        want_args, got_args = _jax_named(want.args), _torch_named(got.args)
        assert list(sorted(got_args)) == list(sorted(want_args)), key
        for name, leaf in want_args.items():
            assert tuple(got_args[name].shape) == tuple(leaf.shape), (key, name)
            assert _dtype(got_args[name]) == _dtype(leaf), (key, name)
            assert got_args[name].device.type == "meta"
        want_sh = {k: tuple(v.spec) for k, v in _jax_named(want.in_shardings).items()}
        got_sh = {k: v.spec for k, v in _torch_named(got.in_shardings).items()}
        assert got_sh == want_sh, key
    skipped = [k for k, c in port.items() if c.skip]
    assert skipped == [(a, "long_500k") for a in registry.LM_ARCHS]
    assert all(port[k].bonus for k in skipped)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_accum_and_recsys_flops_match_reference(mesh):
    sizes = MESHES[mesh]
    ref_mesh = SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    for arch in registry.LM_ARCHS:
        for shape, sd in registry._LM_SHAPE_DEFS.items():
            got = registry._accum_for(registry.arch_config(arch), sd["batch"], sd["seq"], sizes)
            want = ref_registry._accum_for(ref_registry.arch_config(arch), sd["batch"],
                                           sd["seq"], ref_mesh)
            assert got == want, (arch, shape)
    cfg, ref_cfg = (r.arch_config("two-tower-retrieval") for r in (registry, ref_registry))
    for sd in registry._RECSYS_SHAPE_DEFS.values():
        for train in (True, False):
            assert registry._recsys_flops(cfg, sd["batch"], train) == \
                ref_registry._recsys_flops(ref_cfg, sd["batch"], train)


def test_production_mesh_shape_matches_reference():
    script = ("from repro.launch.mesh import make_production_mesh\n"
              "for mp in (False, True):\n"
              "    m = make_production_mesh(multi_pod=mp)\n"
              "    print(repr((tuple(m.shape.values()), tuple(m.axis_names))))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout.splitlines()
    assert [eval(line) for line in out] == [production_shape(False), production_shape(True)]


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        make_production_mesh(device="cpu")


# -- one gloo rank in this process -------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_production_mesh_refuses_a_world_of_one(one_rank):
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_ppermute_ring_of_one_is_a_copy(one_rank):
    group = one_rank.get_group("data")
    x = torch.randn(3, 4, requires_grad=True)
    y = ppermute(x, group, [(0, 0)])
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    w = torch.randn(3, 4)
    (g,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, w)


def test_halo_gcn_on_one_shard_equals_gcn_loss(one_rank):
    """A ring of one: the halo rows are the block's own tail and head, the
    senders offset by ``halo``; a ring lattice joins nodes of equal degree,
    where the halo form's normalisation is GCN's."""
    rng = np.random.default_rng(0)
    halo = 4
    feats, snd, rcv, labels = ring_lattice(40, 3, 1, halo, 256, rng)
    cfg = dataclasses.replace(registry.arch_config("gcn-cora", smoke=True), d_in=12, d_out=5)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    t = torch.as_tensor
    local = GraphBatch(t(feats), t(snd), t(rcv), None, None, None, t(labels))
    plain_snd = np.where(snd >= 0, snd - halo, -1).astype(np.int32)
    plain = GraphBatch(t(feats), t(plain_snd), t(rcv), None, None, None, t(labels))
    got, got_g = value_and_grad(gcn.loss_halo, params, local, cfg, mesh=one_rank, halo=halo)
    want, want_g = value_and_grad(gcn.loss, params, plain, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in params:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-5,
                                   atol=1e-5 * float(want_g[k].abs().max()))


def test_a_cell_step_equals_the_plain_step(one_rank):
    """gcn-cora at full_graph_sm: the cell's step (``make_sharded_train_step``,
    the graph gathered at use) on the (1, 1) mesh against ``make_train_step``."""
    cell = registry.build_cell("gcn-cora", "full_graph_sm", one_rank)
    state_sds, g_sds = cell.args
    cfg = dataclasses.replace(registry.arch_config("gcn-cora"), d_in=g_sds.node_feat.shape[1])
    gen = torch.Generator().manual_seed(0)
    params = gcn.init_params(cfg, gen, device="cpu")
    assert {k: v.shape for k, v in params.items()} == \
        {k: v.shape for k, v in state_sds.params.items()}
    n, e = g_sds.node_feat.shape[0], g_sds.senders.shape[0]
    snd = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    snd[-100:] = -1
    g = GraphBatch(torch.randn(g_sds.node_feat.shape, generator=gen), snd,
                   torch.where(snd >= 0, torch.randint(0, n, (e,), generator=gen,
                                                       dtype=torch.int32), -1),
                   None, None, None,
                   torch.randint(-1, cfg.d_out, (n,), generator=gen, dtype=torch.int32))
    state_sh, g_sh = cell.in_shardings
    copy = lambda: tree_map(torch.clone, params)  # noqa: E731
    sharded = place(init_train_state(copy()), state_sh)
    plain = init_train_state(copy())
    step = make_train_step(MODELS["gcn"].loss, cfg)
    for _ in range(2):
        sharded, got = cell.fn(sharded, place(g, g_sh))
        plain, want = step(plain, g)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(sharded.params[k], plain.params[k], rtol=1e-6, atol=1e-7)
    assert isinstance(state_sh.params["w0"], Sharding)
