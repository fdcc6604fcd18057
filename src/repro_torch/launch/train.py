"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Wires the stack as the reference does: config registry → init on
``--device`` (CUDA unless ``--device cpu``) → resilient train loop
(checkpoint/restart, straggler monitor) → metrics as JSON.

A language model (``--arch`` one of ``configs.registry.LM_ARCHS``) trains on
``TokenStream`` batches of ``--batch × --seq`` tokens for ``--steps`` steps at
a peak learning rate ``--lr`` (warm-up ``max(steps // 20, 10)`` steps, then
cosine), ``--smoke`` taking the SMOKE config; it prints the reference's keys
(``arch``, ``steps``, ``final_loss``, ``first_loss``, ``tokens``,
``tok_per_s``, ``restarts``, ``straggler_events``, ``params``).  Checkpoints
go to ``--ckpt-dir`` every ``--ckpt-every`` steps, and a run resumes from the
newest one it finds there.

``--arch datalog:<workload>`` runs the paper-native Datalog workloads
(``configs/datalog_workloads.py``) through ``Engine.run`` over a
``gnp_graph(--graph-n, p=--graph-p, seed=--seed)`` EDB, with engine
checkpoints in ``--ckpt-dir`` every ``--ckpt-every`` iterations; it accepts
the language models' options, as the reference's parser does, and ignores
them.

On a cluster each host runs this same entry point with ``--coordinator
host:port --num-processes N --process-id i``, which initialise
``torch.distributed`` (NCCL on CUDA, gloo on the CPU) before the run.
"""

from __future__ import annotations

import argparse
import json
import os
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
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.train import (
        CheckpointManager,
        StragglerMonitor,
        init_train_state,
        make_train_step,
        run_resilient,
    )

    if args.arch not in registry.LM_ARCHS:
        raise SystemExit(f"repro_torch.launch.train: --arch {args.arch} is not a language "
                         f"model ({sorted(registry.LM_ARCHS)}) or datalog:<workload>")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train trains on CUDA by default and no CUDA "
                           "device is available; pass --device cpu to train on the CPU")
    cfg = registry.arch_config(args.arch, smoke=args.smoke)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    step_fn = make_train_step(
        lm_loss,
        cfg,
        peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 10),
        total_steps=args.steps,
    )
    mgr = CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
    monitor = StragglerMonitor()

    def init_fn():
        generator = torch.Generator(device=device).manual_seed(args.seed)
        return init_train_state(init_params(cfg, generator, device=device))

    def data_fn(step):
        return {k: torch.as_tensor(v, device=device) for k, v in stream.batch(step).items()}

    t0 = time.time()
    state, history, restarts = run_resilient(
        init_state_fn=init_fn,
        step_fn=step_fn,
        data_fn=data_fn,
        manager=mgr,
        total_steps=args.steps,
        device=device,
        monitor=monitor,
    )
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "steps": args.steps,
                "final_loss": history[-1]["loss"] if history else None,
                "first_loss": history[0]["loss"] if history else None,
                "tokens": toks,
                "tok_per_s": round(toks / dt, 1),
                "restarts": restarts,
                "straggler_events": len(monitor.events),
                "params": cfg.param_count(),
            },
            indent=2,
        )
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
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--graph-n", type=int, default=1000)
    ap.add_argument("--graph-p", type=float, default=0.005)
    ap.add_argument("--device", default="cuda",
                    help="where training or the engine runs: cuda (the default) or cpu")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    _maybe_distributed(args)
    if args.arch.startswith("datalog:"):
        train_datalog(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
