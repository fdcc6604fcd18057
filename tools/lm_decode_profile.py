#!/usr/bin/env python3
"""One decode step of the port's transformer LMs at FULL width in bf16, on the card.

For each ``--arch``: random weights (seed 0) drawn on the card, a prefill
of a ``[--batch, --filled]`` prompt, then the decode step after it: its
median ms between CUDA events, and from ``torch.profiler`` the device's busy
share, device events and host synchronisations per step
(``chip_smoke.device_profile``).  Prints one JSON line per arch, with the
``repro_torch`` it imported and the card's name and power limit.

To compare two trees of the port in one call, run it once for each with
``PYTHONPATH`` pointing at that tree's ``src``, in the order a, b, b, a::

    PYTHONPATH=src python3 tools/lm_decode_profile.py [--arch qwen2-7b ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# the port first, from PYTHONPATH: chip_smoke puts this checkout's src ahead of it
import repro_torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import device_profile, time_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["qwen2-7b", "deepseek-v2-lite-16b"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--filled", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_decode_profile: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    for arch in args.arch:
        cfg = registry.arch_config(arch)
        params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
        toks = torch.as_tensor(
            np.random.default_rng(0).integers(0, cfg.vocab, (args.batch, args.filled + 1)),
            dtype=torch.int32, device="cuda")
        _, cache = tf.prefill(params, toks[:, :args.filled], cfg, args.filled + 1)

        def step():
            return tf.decode_step(params, cache, toks[:, args.filled], args.filled, cfg)

        decode_ms = time_ms(step, reps=10, warm=2)
        profile = device_profile(step, calls=4)
        print(json.dumps({
            "arch": arch, "repro_torch": str(Path(repro_torch.__file__).parent), "card": card,
            "batch": args.batch, "filled": args.filled, "decode_ms": decode_ms,
            "busy_share": profile["busy_share"],
            "device_events_per_step": profile["device_events_per_call"],
            "host_syncs_per_step": profile["host_syncs_per_call"],
        }), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
