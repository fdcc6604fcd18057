#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    PYTHONPATH=src python3 chip_smoke.py

Phases, one output line each:

1. device  — ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build   — compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``;
3. kernels — each hand-written kernel against its plain PyTorch version, bit
   for bit, at the test shapes and at the main path's shape (n = 10000:
   ``int32[10000, 313]`` operands), with median times of kernel, plain
   version and the library yardstick, and the least time the card could take;
4. tc / 5. sg — the main path: ``Engine.run`` on TC and SG over the paper's
   G10K graph (``gnp_graph(10000, p=0.001, seed=1)``) through the PBME
   kernels.  Launch counts are set to 0 just before and read just after, and
   each fixpoint must equal the one the plain fixpoint loop computes on the card;
6. tuple   — the tuple and dense paths (CSDA, Andersen, CC, REACH, SSSP at
   the benchmarks' largest sizes) on the card against the same port on the
   CPU, bit for bit.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.  Any
failure raises and exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
G10K = 10_000
REPS = 20


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def time_ms(fn, reps: int = REPS, warm: int = 3) -> float:
    """Median over ``reps`` calls, each between two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU to drive",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs.datalog_workloads import ALL, SG, TC
        from repro_torch.core import Engine, EngineConfig
        from repro_torch.core.bitmatrix import (
            edges_to_bitmatrix, popcount, sg_fixpoint, tc_fixpoint, transpose_packed,
        )
        from repro_torch.data.graphs import gnp_graph, rmat_graph
        from repro_torch.data.program_facts import andersen_facts, csda_facts
        from repro_torch.kernels import _build
        from repro_torch.kernels import bitmm as kb
        from repro_torch.kernels.ref import (
            bitmm_fused_delta_plain, bitmm_plain, pack_bits, unpack_bits,
        )
    except ImportError as err:
        print(f"chip_smoke: cannot import the port ({err}); run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    kb._lib()
    ptxas = [ln.strip() for log in _build.stats["log"].values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.stats["seconds"],
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()], ptxas=ptxas)

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def bits(rows, cols, density):
        return pack_bits(torch.rand((rows, cols), generator=gen, device=dev) < density)

    err = {"bitmm": 0, "bitmm_fused_delta": 0}
    compared = 0
    cases = [((m, k, n), d) for (m, k, n) in ((128, 128, 128), (130, 70, 200), (64, 33, 97))
             for d in (0.0, 0.02, 0.3, 1.0)]
    for (m, k, n), d in cases:
        a, b, cur = bits(m, k, d), bits(k, n, d), bits(m, n, 0.05)
        got, want = kb.bitmm(a, b), bitmm_plain(a, b)
        check(torch.equal(got, want), f"bitmm differs from plain at {(m, k, n)}, p={d}")
        for g, w in zip(kb.bitmm_fused_delta(a, b, cur), bitmm_fused_delta_plain(a, b, cur)):
            check(torch.equal(g, w), f"bitmm_fused_delta differs at {(m, k, n)}, p={d}")
        compared += 1

    edges = gnp_graph(G10K, p=0.001, seed=1)
    arc = edges_to_bitmatrix(torch.as_tensor(edges, device=dev), G10K)
    check(tuple(arc.shape) == (G10K, 313), f"arc shape {tuple(arc.shape)}")
    main_shape = {}
    for label, a in (("sparse", arc), ("dense", bits(G10K, G10K, 0.5))):
        cur = bits(G10K, G10K, 0.05)
        got, want = kb.bitmm(a, arc), bitmm_plain(a, arc)
        err["bitmm"] = max(err["bitmm"], max_abs_err(got, want))
        check(torch.equal(got, want), f"bitmm differs from plain at n={G10K}, A {label}")
        for g, w in zip(kb.bitmm_fused_delta(a, arc, cur), bitmm_fused_delta_plain(a, arc, cur)):
            err["bitmm_fused_delta"] = max(err["bitmm_fused_delta"], max_abs_err(g, w))
            check(torch.equal(g, w), f"bitmm_fused_delta differs at n={G10K}, A {label}")
        compared += 1

        af = unpack_bits(a, G10K).half()
        bf = unpack_bits(arc, G10K).half()
        words = a.numel() * 4
        ops = 2.0 * int(popcount(a)) * G10K        # one multiply-add per set bit of A per column
        bound_ops = ops / INT8_OPS_PER_S * 1e3
        library_ms = time_ms(lambda: torch.matmul(af, bf))
        del af, bf
        row = {}
        for name, kernel, plain, n_arrays in (
            ("bitmm", lambda: kb.bitmm(a, arc), lambda: bitmm_plain(a, arc), 3),
            ("bitmm_fused_delta", lambda: kb.bitmm_fused_delta(a, arc, cur),
             lambda: bitmm_fused_delta_plain(a, arc, cur), 5),
        ):
            bound_bytes = n_arrays * words / HBM_BYTES_PER_S * 1e3
            row[name] = {
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": library_ms,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
                "a_density": int(popcount(a)) / (G10K * G10K),
            }
        main_shape[label] = row
        torch.cuda.empty_cache()
    emit("kernels", exact_cases=compared, max_abs_err=err, n=G10K,
         shape=[G10K, 313], main_shape=main_shape)

    # -- 4/5. the main path: PBME TC and SG at G10K --------------------------
    def plain_tc(arc_m, _n):
        m, delta, iters = arc_m, arc_m, 0
        while True:
            delta, m_new = bitmm_fused_delta_plain(delta, arc_m, m)
            if int(popcount(delta)) == 0:
                return m, iters + 1
            m, iters = m_new, iters + 1

    def plain_sg(arc_m, n):
        arc_t = transpose_packed(arc_m, n)
        eye = pack_bits(torch.eye(n, dtype=torch.bool, device=dev))
        sg = bitmm_plain(arc_t, arc_m) & ~eye
        delta, iters = sg, 0
        while True:
            delta = bitmm_plain(bitmm_plain(arc_t, delta), arc_m) & ~sg
            if int(popcount(delta)) == 0:
                return sg, iters + 1
            sg, iters = sg | delta, iters + 1

    def reset_launches():
        kb.bitmm.launches = 0
        kb.bitmm_fused_delta.launches = 0

    def read_launches():
        return {"bitmm": kb.bitmm.launches, "bitmm_fused_delta": kb.bitmm_fused_delta.launches}

    launches = {"bitmm": 0, "bitmm_fused_delta": 0}
    for wl, plain, fixpoint in ((TC, plain_tc, tc_fixpoint), (SG, plain_sg, sg_fixpoint)):
        eng = Engine(EngineConfig(backend="auto"))
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.run(wl.program, {"arc": edges})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = read_launches()
        n = eng.domain
        iters = eng.stats.iterations[0]
        check(eng.stats.backend_used[wl.name] == "bitmatrix", f"{wl.name} left PBME")
        expect = ({"bitmm": 0, "bitmm_fused_delta": iters} if wl is TC
                  else {"bitmm": 1 + 2 * iters, "bitmm_fused_delta": 0})
        check(used == expect, f"{wl.name} launches {used}, expected {expect}")
        launches = {k: launches[k] + used[k] for k in launches}

        got = edges_to_bitmatrix(torch.as_tensor(out[wl.name], device=dev), n)
        arc_n = edges_to_bitmatrix(torch.as_tensor(edges, device=dev), n)
        t1 = time.perf_counter()
        want, plain_iters = plain(arc_n, n)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t1
        check(torch.equal(got, want), f"{wl.name} fixpoint differs from the plain loop")
        check(plain_iters == iters, f"{wl.name} iterations {iters} vs plain {plain_iters}")
        # the kernel fixpoint loop alone, outside the counted run: the products and
        # the Δ popcounts, without the EDB upload and the matrix → rows step
        t1 = time.perf_counter()
        fixpoint(arc_n, n)
        torch.cuda.synchronize()
        fixpoint_seconds = time.perf_counter() - t1
        emit(wl.name, n=n, edges=len(edges), facts=len(out[wl.name]), iterations=iters,
             seconds=seconds, engine_seconds=eng.stats.total_seconds,
             stratum_seconds=eng.stats.stratum_seconds[0],
             fixpoint_seconds=fixpoint_seconds, to_host_seconds=seconds - eng.stats.total_seconds,
             plain_fixpoint_seconds=plain_seconds, launches=used)
        del out, got, want, arc_n
        torch.cuda.empty_cache()

    # -- 6. tuple and dense paths: the card against the CPU ----------------------
    def record_key(stats):
        return (stats.iterations, stats.backend_used, [
            (r.stratum, r.iteration, r.idb, r.candidates, r.deduped, r.delta, r.full,
             r.dsd_strategy) for r in stats.records])

    rmat = rmat_graph(14, edge_factor=10, seed=0)
    w = np.random.default_rng(0).integers(1, 100, size=len(rmat)).astype(np.int32)
    src = np.array([[int(rmat[0, 0])]], np.int32)
    workloads = [
        ("csda", csda_facts(3000)),
        ("andersen", andersen_facts(3)[0]),
        ("cc", {"arc": rmat}),
        ("reach", {"id": src, "arc": rmat}),
        ("sssp", {"id": src, "arc": np.concatenate([rmat, w[:, None]], axis=1)}),
    ]
    reset_launches()
    for name, edb in workloads:
        runs = {}
        for device in ("cuda", "cpu"):
            eng = Engine(EngineConfig(), device=device)
            t0 = time.perf_counter()
            out = eng.run(ALL[name].program, edb)
            runs[device] = (out, record_key(eng.stats), time.perf_counter() - t0)
        (g_out, g_key, g_s), (c_out, c_key, c_s) = runs["cuda"], runs["cpu"]
        check(g_out.keys() == c_out.keys(), f"{name}: relations differ")
        for rel in g_out:
            check(np.array_equal(g_out[rel], c_out[rel]), f"{name}: {rel} differs")
        check(g_key == c_key, f"{name}: iterations or per-iteration records differ")
        emit("tuple", workload=name, facts={k: len(v) for k, v in g_out.items()},
             iterations=g_key[0], backends=g_key[1],
             dsd=sorted({r[-1] for r in g_key[2]}), gpu_seconds=g_s, cpu_seconds=c_s)
    check(read_launches() == {"bitmm": 0, "bitmm_fused_delta": 0},
          "the tuple workloads launched PBME kernels")

    # -- report --------------------------------------------------------------
    replaces = {
        "bitmm": "src/repro/kernels/bitmm.py:99 (bitmm_call, body _bitmm_kernel)",
        "bitmm_fused_delta":
            "src/repro/kernels/bitmm.py:131 (bitmm_fused_delta_call, body _bitmm_fused_kernel)",
    }
    dense = main_shape["dense"]
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/bitmm.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": dense[name]["ms"],
            "plain_ms": dense[name]["plain_ms"],
            "bound_ms": dense[name]["bound_ms"],
            "bound_by": dense[name]["bound_by"],
            "library_ms": dense[name]["library_ms"],
        }
        for name in ("bitmm", "bitmm_fused_delta")
    ]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
