#!/usr/bin/env python3
"""Time schnet's train step on the card at ``chip_smoke.py``'s molecule shape.

Prints one JSON line: the card (``torch.cuda.get_device_name`` and
``nvidia-smi``'s name and power limit) and the ms of each step between two
CUDA events, after one warm step, with their median.  The batch is
``chip_smoke.py``'s for schnet at the registry's ``molecule`` shape:
``batched_molecules(128, 30, 64, 32)``, edges padded with -1 to a multiple
of 512, FULL width, ``make_train_step(model.loss, cfg)``.  A launch-bound
step like schnet's moves with the host, so compare two trees only within
one call.

Usage, from the repository root on a machine with a GPU::

    PYTHONPATH=src python3 tools/gnn_step_times.py [--steps 20]

Point ``PYTHONPATH`` at another checkout's ``src`` to time that tree with
the same script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gnn_step_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import registry
    from repro_torch.data.graphs import batched_molecules
    from repro_torch.models.gnn import MODELS, GraphBatch
    from repro_torch.train import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sd = registry._GNN_SHAPE_DEFS["molecule"]
    cfg = dataclasses.replace(registry.arch_config("schnet"), d_in=sd["d"])
    feats, s, r, gids, pos = batched_molecules(128, 30, 64, sd["d"])
    e_pad = -(-sd["e"] // 512) * 512
    s, r = (np.concatenate([a, np.full(e_pad - len(a), -1, np.int32)]) for a in (s, r))
    gen = torch.Generator(device=dev).manual_seed(0)
    labels = torch.randn((128, cfg.d_out), generator=gen, device=dev)
    batch = GraphBatch(*(torch.as_tensor(a, device=dev) for a in (feats, s, r)), None,
                       torch.as_tensor(pos, device=dev), torch.as_tensor(gids, device=dev),
                       labels)
    model = MODELS[cfg.arch]
    state = init_train_state(model.init_params(cfg, gen, device=dev))
    step = make_train_step(model.loss, cfg)
    ms = []
    for i in range(1 + args.steps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        if i:
            ms.append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"arch": "schnet", "shape": "molecule", "card": smi,
                      "device": torch.cuda.get_device_name(0), "step_ms": ms,
                      "median_step_ms": statistics.median(ms),
                      "loss": float(metrics["loss"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
