"""Run a cell with the control in the program's place, on several seeds.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

The control is the plain reference with the fixpoint stopped one productive
round short (``bench/harness/control.py``); each run prints one JSON line
with its seed, ``correct`` (which has to come out false) and the numbers
compared.  On the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_run(workload: str, seed: int, seconds: float, device: str,
                root: Path = ROOT) -> dict:
    from bench.harness import cell, control, inputs
    from bench.harness.spec import load_cell

    c = load_cell(workload, root)
    if c.traffic["kind"] == "eval":
        program = control.ShortFixpoint(c.config, c.config["nodes"], device, root)
    else:
        data = inputs.make(c.config, c.traffic, seed, root)
        program = control.ShortServer(c.config, data.n, data.held, device, root)
    return cell.run(workload, seed, seconds, False, t_start=time.perf_counter(), root=root,
                    device=device, program=program)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in args.seeds:
        r = control_run(args.workload, seed, args.seconds, "cuda")
        print(json.dumps({"seed": seed, "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
