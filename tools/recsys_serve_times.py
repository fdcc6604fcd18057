#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s two-tower serving phases (8 and 9) alone on one GPU.

Usage, from a checkout's root on a machine with a GPU::

    PYTHONPATH=src python3 tools/recsys_serve_times.py

Builds ``TwoTower(two_tower_retrieval.FULL)`` on the card from seed 0 and the
batch of 262,144 from ``RecsysStream(seed=0)``, then runs ``recsys_phases``
of the ``chip_smoke.py`` that sits beside the ``repro_torch`` package that
``PYTHONPATH`` names (so each tree is held to its own launch counts), and
prints its ``recsys_serve:`` and ``recsys_retrieval:`` lines and the card's
name and power limit.  Point ``PYTHONPATH`` at another checkout's ``src`` to
time that tree; host-clock latencies move between calls, so compare two
trees only within one call, in turns (a b b a).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("recsys_serve_times: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch

    tree = Path(repro_torch.__file__).resolve().parents[2]
    sys.path.insert(0, str(tree))
    import chip_smoke
    from repro_torch.configs.two_tower_retrieval import FULL
    from repro_torch.data.recsys_stream import RecsysStream
    from repro_torch.models.recsys import TwoTower

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree: {tree}", flush=True)
    model = TwoTower(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
    stream = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields, FULL.item_fields,
                          FULL.field_hots, FULL.n_dense_feat, batch=chip_smoke.BULK_BATCH, seed=0)
    chip_smoke.recsys_phases(dev, FULL, model, stream, stream.batch(0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
