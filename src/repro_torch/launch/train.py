"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

``--arch datalog:<workload>`` runs the paper-native Datalog workloads
(``configs/datalog_workloads.py``) through ``Engine.run`` on ``--device``
(CUDA unless ``--device cpu``) over a ``gnp_graph(--graph-n, p=--graph-p,
seed=--seed)`` EDB, with engine checkpoints in ``--ckpt-dir`` every
``--ckpt-every`` iterations, and prints what it ran as JSON.  Training the
language models of the reference's other ``--arch`` values, and their
options (``--smoke``, ``--steps``, ``--batch``, ``--seq``, ``--lr``), wait for
the LM training branch (ROADMAP A11, ``train_lm``): the launcher exits
non-zero for them.  Serving them is ``python -m repro_torch.launch.serve``.

On a cluster each host runs this same entry point with ``--coordinator
host:port --num-processes N --process-id i``, which initialise
``torch.distributed`` (NCCL on CUDA, gloo on the CPU) before the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _maybe_distributed(args):
    if args.coordinator:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if torch.device(args.device).type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes,
            rank=args.process_id,
        )


def train_lm(args):
    sys.exit(
        f"repro_torch.launch.train: --arch {args.arch} needs LM training, the launcher's "
        "train_lm branch, which the port does not have yet (ROADMAP A11, LM training); "
        "only --arch datalog:<workload> runs (python -m repro_torch.launch.serve serves "
        "the LMs)"
    )


def train_datalog(args):
    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.data.graphs import gnp_graph

    name = args.arch.split(":", 1)[1]
    wl = ALL[name]
    edges = gnp_graph(args.graph_n, p=args.graph_p, seed=args.seed)
    edb = {"arc": edges}
    if name in ("reach", "sssp"):
        edb["id"] = np.array([[0]], np.int32)
    if name == "sssp":
        rng = np.random.default_rng(args.seed)
        w = rng.integers(1, 100, size=len(edges)).astype(np.int32)
        edb["arc"] = np.concatenate([edges, w[:, None]], axis=1)
    eng = Engine(
        EngineConfig(
            checkpoint_every=args.ckpt_every,
            checkpoint_dir=args.ckpt_dir,
        ),
        device=args.device,
    )
    t0 = time.time()
    out = eng.run(wl.program, edb)
    print(
        json.dumps(
            {
                "workload": name,
                "edges": len(edges),
                "output_sizes": {k: len(v) for k, v in out.items()},
                "iterations": eng.stats.iterations,
                "backends": eng.stats.backend_used,
                "seconds": round(time.time() - t0, 2),
            },
            indent=2,
        )
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--graph-n", type=int, default=1000)
    ap.add_argument("--graph-p", type=float, default=0.005)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the default) or cpu")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def main(argv=None):
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if not args.arch.startswith("datalog:"):
        train_lm(args)          # its options (--steps, --batch, ...) come with LM training
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    _maybe_distributed(args)
    train_datalog(args)


if __name__ == "__main__":
    main()
