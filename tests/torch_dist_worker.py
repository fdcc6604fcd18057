"""One gloo rank of ``test_torch_distributed.py``: the port's sharded paths
on a (4, 2) ``("data", "model")`` mesh of CPU processes.

Run as ``python tests/torch_dist_worker.py RANK WORLD STORE DIR``: reads
``DIR/inputs.npz`` and ``DIR/inputs.json`` (numpy data made from seeds by
the test), joins the group through the ``file://`` store ``STORE`` and
writes this rank's results to ``DIR/rank<RANK>.npz``.
"""

import json
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten_with_path, tree_map

from repro_torch.core.distributed import SCHEDULES, assemble_bitmatrix, tc_fixpoint_sharded
from repro_torch.distributed import make_mesh, shard_rows
from repro_torch.models.recsys import RecsysConfig
from repro_torch.models.recsys import two_tower as tt
from repro_torch.optim import compress_state_init
from repro_torch.train import init_train_state, make_compressed_dp_step, make_train_step
from repro_torch.train.step import value_and_grad


def flat(prefix, tree, out):
    for path, leaf in tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = leaf.detach().numpy()


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

    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
