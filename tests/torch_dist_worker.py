"""One gloo rank of ``test_torch_distributed.py``: the port's sharded paths
on a (4, 2) ``("data", "model")`` mesh of CPU processes (and, for the
expert-parallel MoE and the halo GCN, on the same ranks as a (2, 4) mesh).

Run as ``python tests/torch_dist_worker.py RANK WORLD STORE DIR``: reads
``DIR/inputs.npz`` and ``DIR/inputs.json`` (numpy data made from seeds by
the test), joins the group through the ``file://`` store ``STORE`` and
writes this rank's results to ``DIR/rank<RANK>.npz``.
"""

import contextlib
import json
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten_with_path, tree_map, tree_map_with_path

from repro_torch.core.distributed import SCHEDULES, assemble_bitmatrix, tc_fixpoint_sharded
from repro_torch.distributed import (
    axis_index, batch_sharding, gather, make_mesh, mesh_context, param_sharding, place,
    ppermute, shard_rows,
)
from repro_torch.distributed.sharding import _path_names, expert_stack
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import GNNConfig, GraphBatch, gcn
from repro_torch.models.recsys import RecsysConfig
from repro_torch.models.recsys import two_tower as tt
from repro_torch.optim import compress_state_init
from repro_torch.train import (
    init_train_state, make_compressed_dp_step, make_sharded_train_step, make_train_step,
)
from repro_torch.train.step import ep_local, sharded_value_and_grad, value_and_grad


def flat(prefix, tree, out):
    for path, leaf in tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(_path_names(path))] = leaf.detach().numpy()


def lm_params(data, name, cfg):
    """The test's weights for LM config ``name`` in the port's tree."""
    tree = tf.init_params(cfg, device="meta")
    return tree_map_with_path(
        lambda path, _: torch.tensor(data[f"lm/{name}/" + "/".join(_path_names(path))]), tree)


def sharded_forms(data, meta, mesh, out):
    """The expert-parallel MoE, the sharded LM step, the halo GCN and
    ``ppermute``."""
    cfgs = {k: tf.TransformerConfig(**v) for k, v in meta["lm_cfgs"].items()}
    cfg_m = cfgs["moe"]
    pm = lm_params(data, "moe", cfg_m)
    tokens = torch.tensor(data["ep_tokens"])
    mesh2 = make_mesh(tuple(meta["mesh2"]), ("data", "model"), device="cpu")
    with torch.no_grad():
        out["ep/dense/out"], out["ep/dense/aux"] = (t.numpy() for t in tf.forward(pm, tokens,
                                                                                 cfg_m))
    for name, m in (("4x2", mesh), ("2x4", mesh2)):
        tok = shard_rows(tokens, m, "data")
        # expert stacks cut by ``place``, everything else whole
        cut = place(pm, param_sharding(pm, m))
        mixed = tree_map_with_path(lambda path, full, blk: blk if expert_stack(path, full)
                                   else full, pm, cut)
        with mesh_context(m, ("data",)), torch.no_grad():
            logits, aux = tf.forward(pm, tok, cfg_m)
            logits_cut, _ = tf.forward(mixed, tok, cfg_m)
        out[f"ep/{name}/out"], out[f"ep/{name}/aux"] = logits.numpy(), aux.numpy()
        out[f"ep/{name}/out_cut"] = logits_cut.numpy()
        out[f"ep/{name}/coord"] = np.array(m.get_coordinate())

    def lm_batch(i, m):
        b = {k: torch.tensor(data[f"lm_batch/{i}/{k}"]) for k in ("tokens", "labels")}
        return place(b, batch_sharding(b, m))

    # -- the sharded step (dense config) and its first gradients ---------------------
    cfg = cfgs["dense"]
    state = init_train_state(lm_params(data, "dense", cfg))
    sh = param_sharding(state, mesh)
    state = place(state, sh)
    loss, grads = sharded_value_and_grad(tf.lm_loss, state.params, lm_batch(0, mesh), cfg, mesh,
                                         sh.params, ep_local)
    out["step/grad_loss"] = loss.numpy()
    flat("step/grad/", gather(grads, sh.params), out)
    step = make_sharded_train_step(tf.lm_loss, cfg, mesh, sh.params, **meta["dp_schedule"])
    for i in range(meta["lm_steps"]):
        state, metrics = step(state, lm_batch(i, mesh))
        out[f"step/loss/{i}"] = metrics["loss"].numpy()
        out[f"step/gnorm/{i}"] = metrics["gnorm"].numpy()
    flat("step/params/", gather(state.params, sh.params), out)

    # -- the MoE's loss and gradients, expert-parallel and dense dispatch ----------
    sh_m = param_sharding(pm, mesh)
    blocks = place(pm, sh_m)
    for name, ctx in (("ep", mesh_context(mesh, ("data",))), ("gspmd", contextlib.nullcontext())):
        with ctx:
            loss, grads = sharded_value_and_grad(tf.lm_loss, blocks, lm_batch(0, mesh), cfg_m,
                                                 mesh, sh_m, ep_local)
        out[f"moe/{name}/loss"] = loss.numpy()
        flat(f"moe/{name}/grad/", gather(grads, sh_m), out)

    # -- the halo GCN ------------------------------------------------------------------
    gcfg = GNNConfig(arch="gcn", **meta["gcn_cfg"])
    gp = {f"w{i}": torch.tensor(data[f"gcn/w{i}"]) for i in range(gcfg.n_layers)}
    for name, m in (("4x2", mesh), ("2x4", mesh2)):
        shards = m.size(0)
        cut = {k: shard_rows(torch.tensor(data[f"halo/{shards}/{k}"]), m, "data")
               for k in ("feats", "senders", "receivers", "labels")}
        g = GraphBatch(cut["feats"], cut["senders"], cut["receivers"], None, None, None,
                       cut["labels"])
        loss, grads = value_and_grad(gcn.loss_halo, gp, g, gcfg, mesh=m, dp_axes=("data",),
                                     halo=meta["halo"]["halo"])
        out[f"halo/{name}/loss"] = loss.numpy()
        flat(f"halo/{name}/grad/", grads, out)

    # -- ppermute on rings of 2 (model) and 4 (data): forward and backward ---------
    rank = dist.get_rank()
    for axis in ("model", "data"):
        group, n = mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))
        x = (torch.arange(3.0) + 10 * rank).requires_grad_(True)
        y = ppermute(x, group, [(i, (i + 1) % n) for i in range(n)], tag=5)
        w = torch.arange(3.0) * (rank + 1)
        (gx,) = torch.autograd.grad((y * w).sum(), x)
        out[f"ppermute/{axis}/y"], out[f"ppermute/{axis}/grad"] = y.detach().numpy(), gx.numpy()
        out[f"ppermute/{axis}/index"] = np.array(axis_index(mesh, axis))


def main(rank, world, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    data = np.load(f"{work}/inputs.npz")
    meta = json.load(open(f"{work}/inputs.json"))
    cfg = RecsysConfig(**meta["cfg"])
    out = {"coord": np.array(mesh.get_coordinate())}

    # -- sharded PBME TC, three schedules --------------------------------------
    for sched in SCHEDULES:
        for seed in meta["tc_seeds"]:
            m, n_pad, iters = tc_fixpoint_sharded(data[f"tc_edges_{seed}"], meta["tc_n"], mesh,
                                                  schedule=sched)
            col = None if sched == "rows1d" else "model"
            out[f"tc/{sched}/{seed}/m"] = assemble_bitmatrix(m, mesh, ("data",), col).numpy()
            out[f"tc/{sched}/{seed}/iters"] = np.array(iters)
            out[f"tc/{sched}/{seed}/block"] = np.array(m.shape)
        for kind, nbytes in tc_fixpoint_sharded.last_collective_bytes.items():
            out[f"tc/{sched}/bytes/{kind}"] = np.array(nbytes)

    params = {k: torch.tensor(data[f"p/{k}"]) for k in ("user_table", "item_table")}
    for k in ("user_mlp", "item_mlp"):
        params[k] = {w: torch.tensor(data[f"p/{k}/{w}"]) for w in meta["mlp_keys"]}
    local = dict(params, user_table=shard_rows(params["user_table"], mesh, "model"),
                 item_table=shard_rows(params["item_table"], mesh, "model"))

    def batch_of(prefix):
        return {k: shard_rows(torch.tensor(data[f"{prefix}/{k}"]), mesh, "data")
                for k in ("user_ids", "item_ids", "user_dense", "log_q")}

    # -- sharded bags, loss and gradients ----------------------------------------
    ids = shard_rows(torch.tensor(data["bag_ids"]), mesh, "data")
    batch = batch_of("loss")
    for variant, scatter in (("psum", False), ("scatter", True)):
        out[f"bags/{variant}"] = tt.sharded_bags(
            local["user_table"], ids, mesh, ("data",), scatter=scatter).numpy()
        loss, grads = value_and_grad(tt.loss_sharded, local, batch, cfg, mesh=mesh,
                                     dp_axes=("data",), scatter=scatter)
        out[f"loss/{variant}/value"] = loss.numpy()
        flat(f"loss/{variant}/grad/", grads, out)
        out[f"bags/{variant}_bf16"] = tt.sharded_bags(
            local["user_table"], ids, mesh, ("data",), scatter=scatter,
            wire_dtype=torch.bfloat16).numpy()

    with torch.no_grad():
        out["serve"] = tt.serve_scores(local, batch, cfg, mesh=mesh).numpy()

    # -- compressed DP against the uncompressed step on the same objective -----
    def shard_mean_loss(p, b, cfg):
        """The mean of the 4 data shards' in-batch losses: the objective the
        compressed step's all-reduce averages."""
        return sum(tt.loss(p, {k: v.chunk(4)[i] for k, v in b.items()}, cfg)
                   for i in range(4)) / 4

    def train(schedule, prefix):
        copy = lambda: tree_map(torch.clone, params)  # noqa: E731
        state, err = init_train_state(copy()), compress_state_init(params)
        plain = init_train_state(copy())
        stepc = make_compressed_dp_step(tt.loss, cfg, mesh, "data", **schedule)
        stepu = make_train_step(shard_mean_loss, cfg, **schedule)
        for i in range(meta["dp_steps"]):
            state, err, metrics = stepc(state, err, batch_of(f"dp/{i}"))
            plain, _ = stepu(plain, {k: torch.tensor(data[f"dp/{i}/{k}"])
                                     for k in ("user_ids", "item_ids", "user_dense", "log_q")})
            out[f"{prefix}/loss/{i}"] = metrics["loss"].numpy()
        flat(f"{prefix}/params/", state.params, out)
        flat(f"{prefix}/plain/", plain.params, out)

    train(meta["dp_schedule"], "dp")          # against the reference
    train({}, "dp_default")                   # the reference's own property, its defaults

    sharded_forms(data, meta, mesh, out)

    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
