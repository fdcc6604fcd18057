#!/usr/bin/env python3
"""Variants of ``csrc/bitmm.cu``'s tiles and walk threshold, timed on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    PYTHONPATH=src python3 tools/bitmm_variants.py

Each variant is ``csrc/bitmm.cu`` built with some of its ``BITMM_*`` constants
set by ``-D`` (all variants compile at once).  Its fused product runs through
``kernels.bitmm.bitmm_fused_delta`` itself, is held bit for bit against the
plain version and timed (``chip_smoke.time_ms``) at n = 10000 with B the G10K
arc and A the arc, A mixed (empty, arc-sparse and dense 1024-bit K stages in
turn), a 1 % random frontier and dense A (density 0.5); ``torch.profiler``
splits one call into its kernels.  One JSON line per variant, then the card's
name and power limit.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import time_ms  # noqa: E402
from repro_torch.core.bitmatrix import edges_to_bitmatrix  # noqa: E402
from repro_torch.data.graphs import gnp_graph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bitmm as kb  # noqa: E402
from repro_torch.kernels.ref import bitmm_fused_delta_plain, pack_bits  # noqa: E402

N = 10_000
# name -> -D defines; the walk threshold is set bits per stage tile of A, so it
# scales with the tile's rows x bits (512 per 128 x 1024)
VARIANTS = {
    "base": (),                                        # 128 x 256 tiles, 8 warps, walk 512
    "bk16": ("BITMM_BKW=16", "BITMM_WALK_BELOW=256"),
    "nst4": ("BITMM_NST=4",),
    "u16": ("BITMM_U=16",),
    "wnt4": ("BITMM_WNT=4",),                          # 128 x 128, two blocks per SM
    "w16_bk16_nst4": ("BITMM_THREADS=512", "BITMM_WNT=4", "BITMM_BKW=16",
                      "BITMM_NST=4"),                  # 256 x 128, 16 warps
    **{f"walk{w}": (f"BITMM_WALK_BELOW={w}",) for w in (0, 128, 2048, 8192)},
}


def parts_ms(fn) -> dict[str, float]:
    """Device ms of each kernel of one call, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            key = next((k for k in ("transpose", "plan", "mma", "walk", "Memset")
                        if k in ev.key), ev.key[:40])
            out[key] = out.get(key, 0.0) + ev.self_device_time_total / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bitmm_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    built = _build.build({name: (_build.CSRC / "bitmm.cu", d) for name, d in VARIANTS.items()})
    for name in VARIANTS:
        ptxas = [ln.strip() for ln in _build.stats["log"].get(name, "").splitlines()
                 if "spill" in ln or "registers" in ln or "Compiling entry" in ln]
        print(json.dumps({"variant": name, "library": built[name].name, "ptxas": ptxas}),
              flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    arc = edges_to_bitmatrix(torch.as_tensor(gnp_graph(N, p=0.001, seed=1), device=dev), N)
    stage_density = torch.tensor([0.0, 1e-3, 0.5], device=dev)[torch.arange(N, device=dev)
                                                                // 1024 % 3]
    cases = {"sparse": arc,
             "mixed": pack_bits(torch.rand((N, N), generator=gen, device=dev) < stage_density)}
    for label, d in (("random_1pc", 0.01), ("dense", 0.5)):
        cases[label] = pack_bits(torch.rand((N, N), generator=gen, device=dev) < d)
    cur = pack_bits(torch.rand((N, N), generator=gen, device=dev) < 0.05)
    want = {label: bitmm_fused_delta_plain(a, arc, cur) for label, a in cases.items()}

    for name, defines in VARIANTS.items():
        row = {"variant": name, "defines": list(defines)}
        with mock.patch.object(kb, "_lib", functools.partial(kb._lib, defines)):
            for label, a in cases.items():
                got = kb.bitmm_fused_delta(a, arc, cur)
                if not all(torch.equal(g, w) for g, w in zip(got, want[label])):
                    raise RuntimeError(f"{name} differs from the plain version on {label}")
                row[label] = {"ms": time_ms(lambda: kb.bitmm_fused_delta(a, arc, cur)),
                              "parts_ms": parts_ms(lambda: kb.bitmm_fused_delta(a, arc, cur))}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
