#!/usr/bin/env python3
"""Tensor-core rates of int8 and single-bit (AND+POPC) products on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``::

    python3 tools/mma_rates.py

Builds ``tools/mma_rates.cu`` once per product kind (``mma.sync`` s8 and b1,
``wgmma`` s8 and b1) into ``build/tools/``, runs each on one block of 512
threads and on a grid of 4 blocks per SM, and prints one JSON line per kind:
bit multiply-accumulates per second (a s8 product counts 1 per byte pair, a
b1 product 1 per bit pair), for the block and for the card.  A kind the
assembler refuses prints its error instead.  Last comes the card's name and
power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tools" / "mma_rates.cu"
OUT = ROOT / "build" / "tools"
KINDS = {0: "mma.sync s8 m16n8k32", 1: "mma.sync b1 m16n8k256 and.popc",
         2: "wgmma s8 m64n128k32", 3: "wgmma b1 m64n128k256 and.popc"}
THREADS, ITERS = 512, 4096


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build() -> dict[int, Path | str]:
    """Compile every kind at once; kind → library path, or nvcc's error."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kind in KINDS:
        lib = OUT / f"mma_rates_{kind}.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", f"-DMMA_KIND={kind}", "-o", str(lib), str(SRC)]
        procs[kind] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    done = {}
    for kind, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        done[kind] = lib if proc.returncode == 0 else log.strip()[-600:]
    return done


def rate(lib: ctypes.CDLL, kind: int, blocks: int) -> float:
    """Bit multiply-accumulates per second, median of 5 timed launches."""
    lib.mma_rate_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mma_rate_macs_per_iter.restype = ctypes.c_longlong
    sink = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.mma_rate_launch(blocks, THREADS, ITERS, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{KINDS[kind]}: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    issuers = THREADS // (32 if kind < 2 else 128)
    macs = blocks * issuers * ITERS * lib.mma_rate_macs_per_iter()
    return macs / sorted(times)[2]


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rates: no CUDA device", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, lib in build().items():
        if isinstance(lib, str):
            print(json.dumps({"kind": KINDS[kind], "build_error": lib}), flush=True)
            continue
        so = ctypes.CDLL(str(lib))
        print(json.dumps({"kind": KINDS[kind], "one_block_macs_per_s": rate(so, kind, 1),
                          "card_macs_per_s": rate(so, kind, 4 * sms), "sms": sms}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
