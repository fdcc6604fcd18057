"""The reference side of ``test_torch_distributed.py``: ``repro``'s sharded
paths on a (4, 2) ``("data", "model")`` mesh of 8 virtual CPU devices (and
on the same devices as a (2, 4) mesh).

Run as ``python tests/torch_dist_reference.py DIR`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: reads
``DIR/inputs.npz`` and ``DIR/inputs.json`` and writes ``DIR/reference.npz``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.core.bitmatrix import edges_to_bitmatrix
from repro.core.distributed import (
    make_tc_step_1d, make_tc_step_psum, padded_n, tc_fixpoint_sharded,
)
from repro.distributed.compat import make_mesh
from repro.distributed.context import mesh_context
from repro.distributed.sharding import _path_names, batch_sharding, param_sharding
from repro.models import transformer as tf
from repro.models.gnn import gcn
from repro.models.gnn.common import GNNConfig, GraphBatch
from repro.models.recsys import two_tower as tt
from repro.optim.grad_compress import compress_state_init
from repro.train import init_train_state, make_compressed_dp_step, make_train_step


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(_path_names(path))] = np.asarray(leaf)


def lm_params(data, name, cfg):
    tree = jax.eval_shape(lambda: tf.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(data[f"lm/{name}/" + "/".join(_path_names(path))]), tree)


def sharded_forms(data, meta, mesh, out):
    cfgs = {k: tf.TransformerConfig(**v) for k, v in meta["lm_cfgs"].items()}
    cfg_m = cfgs["moe"]
    pm = lm_params(data, "moe", cfg_m)
    tokens = jnp.asarray(data["ep_tokens"])
    mesh2 = make_mesh(tuple(meta["mesh2"]), ("data", "model"))
    forward = jax.jit(lambda p, t: tf.forward(p, t, cfg_m))
    out["ep/dense/out"], out["ep/dense/aux"] = (np.asarray(a) for a in forward(pm, tokens))
    for name, m in (("4x2", mesh), ("2x4", mesh2)):
        with mesh_context(m, ("data",)):
            logits, aux = jax.jit(lambda p, t: tf.forward(p, t, cfg_m))(pm, tokens)
        out[f"ep/{name}/out"], out[f"ep/{name}/aux"] = np.asarray(logits), np.asarray(aux)

    def lm_batch(i):
        return {k: jnp.asarray(data[f"lm_batch/{i}/{k}"]) for k in ("tokens", "labels")}

    cfg = cfgs["dense"]
    params = lm_params(data, "dense", cfg)
    state_sh = param_sharding(jax.eval_shape(lambda: init_train_state(params)), mesh)
    b_sh = batch_sharding(lm_batch(0), mesh)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg)),
                          in_shardings=(state_sh.params, b_sh))(params, lm_batch(0))
    out["step/grad_loss"] = np.asarray(loss)
    flat("step/grad/", grads, out)
    step = jax.jit(make_train_step(tf.lm_loss, cfg, donate=False, jit=False,
                                   **meta["dp_schedule"]), in_shardings=(state_sh, b_sh))
    state = jax.device_put(init_train_state(params), state_sh)
    for i in range(meta["lm_steps"]):
        state, metrics = step(state, jax.device_put(lm_batch(i), b_sh))
        out[f"step/loss/{i}"] = np.asarray(metrics["loss"])
        out[f"step/gnorm/{i}"] = np.asarray(metrics["gnorm"])
    flat("step/params/", state.params, out)

    # a function of its own for each form: jit caches a trace by function, and
    # the mesh context is not part of the key
    with mesh_context(mesh, ("data",)):
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg_m)))(
            pm, lm_batch(0))
    out["moe/ep/loss"] = np.asarray(loss)
    flat("moe/ep/grad/", grads, out)
    pm_sh = param_sharding(jax.eval_shape(lambda: pm), mesh)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg_m)),
                          in_shardings=(pm_sh, b_sh))(pm, lm_batch(0))
    out["moe/gspmd/loss"] = np.asarray(loss)
    flat("moe/gspmd/grad/", grads, out)

    gcfg = GNNConfig(arch="gcn", **meta["gcn_cfg"])
    gp = {f"w{i}": jnp.asarray(data[f"gcn/w{i}"]) for i in range(gcfg.n_layers)}
    for name, m in (("4x2", mesh), ("2x4", mesh2)):
        shards = m.shape["data"]
        arr = {k: jnp.asarray(data[f"halo/{shards}/{k}"])
               for k in ("feats", "senders", "receivers", "labels")}
        g = GraphBatch(arr["feats"], arr["senders"], arr["receivers"], None, None, None,
                       arr["labels"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: gcn.loss_halo(p, g, gcfg, m, ("data",), meta["halo"]["halo"])))(gp)
        out[f"halo/{name}/loss"] = np.asarray(loss)
        flat(f"halo/{name}/grad/", grads, out)


def tc_schedule(mesh, edges, n, sched):
    """``tc_fixpoint_sharded``'s loop on the rows1d and psum steps."""
    n_pad = padded_n(n, mesh.shape["data"], mesh.shape["model"])
    arc_host = edges_to_bitmatrix(edges, n_pad)
    if sched == "rows1d":
        step = make_tc_step_1d(mesh, ("data",))
        arc = jax.device_put(arc_host, NamedSharding(mesh, P(None, None)))
        dm = NamedSharding(mesh, P("data", None))
    else:
        step = make_tc_step_psum(mesh, ("data",), "model")
        arc = jax.device_put(arc_host, NamedSharding(mesh, P("model", None)))
        dm = NamedSharding(mesh, P("data", "model"))
    delta = m = jax.device_put(arc_host, dm)
    iters = 0
    while True:
        delta, m, cnt = step(delta, arc, m)
        iters += 1
        if int(cnt) == 0:
            return m, iters


def main(work):
    mesh = make_mesh((4, 2), ("data", "model"))
    data = np.load(f"{work}/inputs.npz")
    meta = json.load(open(f"{work}/inputs.json"))
    cfg = tt.RecsysConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in meta["cfg"].items()})
    out = {}

    for seed in meta["tc_seeds"]:
        edges, n = data[f"tc_edges_{seed}"], meta["tc_n"]
        runs = {"allgather": tc_fixpoint_sharded(edges, n, mesh)[::2]}
        for sched in ("rows1d", "psum"):
            runs[sched] = tc_schedule(mesh, edges, n, sched)
        for sched, (m, iters) in runs.items():
            out[f"tc/{sched}/{seed}/m"] = np.asarray(jax.device_get(m))
            out[f"tc/{sched}/{seed}/iters"] = np.array(iters)

    params = {k: jnp.asarray(data[f"p/{k}"]) for k in ("user_table", "item_table")}
    for k in ("user_mlp", "item_mlp"):
        params[k] = {w: jnp.asarray(data[f"p/{k}/{w}"]) for w in meta["mlp_keys"]}

    def batch_of(prefix):
        return {k: jnp.asarray(data[f"{prefix}/{k}"])
                for k in ("user_ids", "item_ids", "user_dense", "log_q")}

    ids = jnp.asarray(data["bag_ids"])
    batch = batch_of("loss")
    loss, grads = jax.jit(jax.value_and_grad(tt.loss), static_argnums=2)(params, batch, cfg)
    out["loss/unsharded/value"] = np.asarray(loss)
    flat("loss/unsharded/grad/", grads, out)
    for variant, scatter in (("psum", False), ("scatter", True)):
        out[f"bags/{variant}"] = np.asarray(jax.jit(
            lambda t, i: tt.sharded_bags(t, i, mesh, ("data",), scatter=scatter))(
                params["user_table"], ids))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: tt.loss_sharded(p, batch, cfg, mesh, ("data",), scatter=scatter)))(params)
        out[f"loss/{variant}/value"] = np.asarray(loss)
        flat(f"loss/{variant}/grad/", grads, out)
        out[f"bags/{variant}_bf16"] = np.asarray(jax.jit(
            lambda t, i: tt.sharded_bags(t, i, mesh, ("data",), scatter=scatter,
                                         wire_dtype=jnp.bfloat16))(params["user_table"], ids))

    out["serve"] = np.asarray(jax.jit(
        lambda p, b: tt.serve_scores(p, b, cfg, mesh, ("data",)))(params, batch))
    out["serve/unsharded"] = np.asarray(tt.serve_scores(params, batch, cfg))

    state, err = init_train_state(params), compress_state_init(params)
    step = make_compressed_dp_step(tt.loss, cfg, mesh, "data", **meta["dp_schedule"])
    for i in range(meta["dp_steps"]):
        state, err, metrics = step(state, err, batch_of(f"dp/{i}"))
        out[f"dp/loss/{i}"] = np.asarray(metrics["loss"])
    flat("dp/params/", state.params, out)

    sharded_forms(data, meta, mesh, out)
    np.savez(f"{work}/reference.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1])
