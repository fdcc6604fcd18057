#!/usr/bin/env python3
"""Time ``Engine.run`` of one Datalog workload on the card, several times in one process.

Prints one JSON line: the workload, the card (``torch.cuda.get_device_name``
and ``nvidia-smi``'s name and power limit), and for each repetition the host
seconds of the whole call (ending in numpy rows on the host), of
``EvalStats.total_seconds`` (the fixpoint with its EDB upload) and their
difference (the rows' device → host copy), plus the iterations.  The first
call pays the port's imports and allocator warm-up and is reported apart.
The workloads are ``chip_smoke.py``'s: ``tc`` and ``sg`` on G10K
(``gnp_graph(10000, p=0.001, seed=1)``, PBME) and ``csda``
(``csda_facts(3000)``, the tuple path).

Usage, from the repository root on a machine with a GPU::

    PYTHONPATH=src python3 tools/fixpoint_times.py csda [--reps 5]

Point ``PYTHONPATH`` at another checkout's ``src`` to time that tree with
the same script.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", choices=("tc", "sg", "csda"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fixpoint_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.datalog_workloads import ALL
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.data.graphs import gnp_graph
    from repro_torch.data.program_facts import csda_facts

    edb = (csda_facts(3000) if args.workload == "csda"
           else {"arc": gnp_graph(10_000, p=0.001, seed=1)})
    runs = []
    for _ in range(args.reps + 1):
        eng = Engine(EngineConfig(), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(ALL[args.workload].program, edb)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs.append({"seconds": seconds, "engine_seconds": eng.stats.total_seconds,
                     "to_host_seconds": seconds - eng.stats.total_seconds,
                     "iterations": eng.stats.iterations})
        del eng
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "workload": args.workload, "card": smi, "kind": torch.cuda.get_device_name(0),
        "first": runs[0], "runs": runs[1:],
        "median_seconds": statistics.median(r["seconds"] for r in runs[1:]),
        "median_to_host_seconds": statistics.median(r["to_host_seconds"] for r in runs[1:]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
