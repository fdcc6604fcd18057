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
   ``int32[10000, 313]`` operands; A sparse as the arc, mixed — empty,
   sparse and dense 1024-bit K stages in turn — and dense), with median times
   of kernel, plain version and the library yardstick, and the least time
   the card could take;
4. tc / 5. sg — the main path: ``Engine.run`` on TC and SG over the paper's
   G10K graph (``gnp_graph(10000, p=0.001, seed=1)``) through the PBME
   kernels.  Launch counts are set to 0 just before and read just after, and
   each fixpoint must equal the one the plain fixpoint loop computes on the card;
   a separate run of the fixpoint loop alone gives ``fixpoint_seconds`` and
   one more, with CUDA events around each product, ``per_launch`` (ms, A's
   density and the bound of each launch);
6. tuple   — the tuple and dense paths (CSDA, Andersen, CC, REACH, SSSP at
   the benchmarks' largest sizes) on the card against the same port on the
   CPU, bit for bit;
7. gather_sum — the gather-sum kernel against its plain version at
   ``test_gather_sum_sweep``'s shapes (float32 within 1e-5, bfloat16 within
   2e-2) and at the two-tower path's shapes (``idx int32[262144, 8]`` from
   ``RecsysStream(seed=0)`` over the FULL user and item tables), with median
   times of kernel, plain version and ``F.embedding_bag``, and the bound;
8. recsys_serve — the two-tower model at ``two_tower_retrieval.FULL``
   (5e6 + 2e6 rows of 256 float32, TF32 off): ``serve_scores`` at batch 512
   (``serve_p99``, 50 requests: median and p99) and 262,144 (``serve_bulk``,
   rows/s), 6 gather-sum launches per call, scores within 1e-4 of the same
   model on the card with its bags made by the plain version, and where the
   time goes;
9. recsys_retrieval — a 1,000,000-item corpus embedded with ``item_tower``,
   then ``retrieval_scores`` for one query at top_k = 100 (4 launches per
   call), held against the plain-bag version: scores within 1e-4, indices
   equal wherever neighbouring reference scores differ by more than 1e-4.

Then a ``kernels`` JSON line, the card's name and power limit, and, last,
``{"ok": true, "device": ...}``.  Any failure raises and exits non-zero; so
does a machine without CUDA.
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
# bitmm runs single-bit mma.sync (AND + POPC), whose rate NVIDIA does not
# publish: tools/mma_rates.py measured 5.2e15 bit multiply-accumulates a second
# on an H100 80GB HBM3 at 700 W, two operations each
B1_OPS_PER_S = 2 * 5.20191304247123e15
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
G10K = 10_000
REPS = 20
# the two-tower cells of configs/registry.py: serve_p99, serve_bulk, retrieval_cand
P99_BATCH, P99_CALLS = 512, 50
BULK_BATCH, BULK_REPS = 262_144, 5
CORPUS, TOP_K, QUERY_CALLS = 1_000_000, 100, 20
GATHER_SWEEP = [(8, 3, 20, 128), (16, 7, 50, 256), (4, 1, 5, 384),   # test_gather_sum_sweep
                (9, 5, 30, 99), (5, 40, 64, 36)]                      # the scalar path
SCORE_TOL = 1e-4
# bitmm shapes held bit for bit against the plain version: multiples of none of
# the kernel's tiles (128 rows, 256 columns, 1024-bit K stages), or one past one
EXACT_SHAPES = [(128, 128, 128), (130, 70, 200), (64, 33, 97), (1, 1, 1), (300, 1000, 4100),
                (129, 257, 8193)]


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


def bitmm_bound(a, n: int, n_arrays: int) -> tuple[float, str]:
    """Least ms of a bit-matrix product with A ``a`` and an n-column B: its
    ``n_arrays`` word arrays of A's size read or written once, or one
    multiply-add per set bit of A and column of B at the b1 rate."""
    from repro_torch.core.bitmatrix import popcount

    bound_bytes = n_arrays * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
    bound_ops = 2.0 * int(popcount(a)) * n / B1_OPS_PER_S * 1e3
    return max(bound_bytes, bound_ops), "operations" if bound_ops >= bound_bytes else "bytes"


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def float_err(got, want) -> float:
    """Largest |got − want| in float32; NaN where exactly one side is NaN."""
    got, want = got.float(), want.float()
    check(torch.equal(got.isnan(), want.isnan()), "NaN in different places")
    both = ~got.isnan()
    return float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0


def host_ms(fn) -> float:
    """One call on the host clock, ending in a synchronised result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    ordered = sorted(values)
    return ordered[max(0, -(-len(ordered) * q // 100) - 1)]


def device_busy_share(fn, calls: int):
    """Share of a window of ``calls`` calls in which the card ran kernels or
    copies, as ``torch.profiler`` records them (one stream, so the device
    times add up); None where the profiler recorded no device time.  The
    profiler's own cost lengthens the window, so this is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / wall_us if busy_us > 0 else None


def gather_sum_phase(dev, model, bulk) -> dict:
    """Phase 7: the kernel against its plain version; times at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import gather_sum as kg
    from repro_torch.kernels.ref import gather_sum_plain

    rng = np.random.default_rng(0)
    sweep_err = {"float32": 0.0, "bfloat16": 0.0}
    for b, k, n, d in GATHER_SWEEP:
        idx = torch.as_tensor(rng.integers(-1, n, size=(b, k)).astype(np.int32), device=dev)
        x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            xt = x.to(dtype)
            e = float_err(kg.gather_sum(idx, xt), gather_sum_plain(idx, xt))
            check(e <= tol, f"gather_sum {dtype} differs from plain by {e} at {(b, k, n, d)}")
            key = str(dtype).removeprefix("torch.")
            sweep_err[key] = max(sweep_err[key], e)
        idx[0, 0] = n                                     # an id past the table: a NaN bag
        got = kg.gather_sum(idx, x)
        check(bool(got[0].isnan().all()) and float_err(got, gather_sum_plain(idx, x)) <= 1e-5,
              f"gather_sum out-of-range id at {(b, k, n, d)}")

    shapes = {}
    for name, table, ids in (("user", model.user_table, bulk["user_ids"][:, 0]),
                             ("item", model.item_table, bulk["item_ids"][:, 0])):
        idx = torch.as_tensor(np.ascontiguousarray(ids), device=dev)
        out = kg.gather_sum(idx, table)
        err = float_err(out, gather_sum_plain(idx, table))
        check(err <= 1e-5, f"gather_sum differs from plain by {err} on the {name} table")
        safe, weight = idx.clamp_min(0), (idx >= 0).to(table.dtype)
        lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=weight)
        check(float_err(lib, out) <= 1e-5, "the library yardstick computes another function")
        valid = idx[idx >= 0]
        rows = torch.unique(valid).numel()
        elsize = table.element_size()
        nbytes = rows * table.shape[1] * elsize + idx.numel() * 4 + out.numel() * elsize
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = valid.numel() * table.shape[1] / FP32_OPS_PER_S * 1e3
        shapes[name] = {
            "idx": list(idx.shape), "table": list(table.shape), "distinct_rows": rows,
            "max_abs_err": err,
            "ms": time_ms(lambda: kg.gather_sum(idx, table)),
            "plain_ms": time_ms(lambda: gather_sum_plain(idx, table)),
            "library_ms": time_ms(
                lambda: F.embedding_bag(safe, table, mode="sum", per_sample_weights=weight)),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        del out, lib
    emit("gather_sum", sweep_cases=len(GATHER_SWEEP) * 2, sweep_max_abs_err=sweep_err,
         main_shape=shapes)
    return shapes


def recsys_phases(dev, cfg, model, bulk_stream, bulk) -> int:
    """Phases 8 and 9: serve_scores and retrieval_scores on the card, each
    with the launch count set to 0 just before and read just after; the
    plain side runs the same heads on bags from the plain version.  Returns
    the path's gather-sum launches."""
    from repro_torch.data.recsys_stream import RecsysStream
    from repro_torch.kernels import gather_sum as kg
    from repro_torch.kernels.ref import gather_sum_plain

    def to_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items() if k != "log_q"}

    def plain_bags(table, ids):
        return [gather_sum_plain(f, table) for f in ids.transpose(0, 1).contiguous()]

    def plain_user(bt):
        return model.user_head(plain_bags(model.user_table, bt["user_ids"]), bt["user_dense"])

    def plain_item(ids):
        return model.item_head(plain_bags(model.item_table, ids))

    def plain_scores(bt):
        return (plain_user(bt) * plain_item(bt["item_ids"])).sum(-1) / cfg.temperature

    def request(b):
        return model.serve_scores(to_dev(b)).cpu()

    def breakdown(b, reps):
        """Median ms of each part: host → card, bags, MLPs, score, card → host."""
        parts = {k: [] for k in ("h2d", "bags", "mlp", "score", "d2h")}
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt = to_dev(b)
            torch.cuda.synchronize()
            parts["h2d"].append((time.perf_counter() - t0) * 1e3)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            ub, ib = model.user_bags(bt["user_ids"]), model.item_bags(bt["item_ids"])
            ev[1].record()
            q, v = model.user_head(ub, bt["user_dense"]), model.item_head(ib)
            ev[2].record()
            s = (q * v).sum(-1) / cfg.temperature
            ev[3].record()
            ev[3].synchronize()
            t0 = time.perf_counter()
            s.cpu()
            parts["d2h"].append((time.perf_counter() - t0) * 1e3)
            for name, a, z in (("bags", 0, 1), ("mlp", 1, 2), ("score", 2, 3)):
                parts[name].append(ev[a].elapsed_time(ev[z]))
        return {f"{k}_ms": statistics.median(v) for k, v in parts.items()}

    fields = cfg.user_fields + cfg.item_fields
    p99_stream = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields,
                              cfg.item_fields, cfg.field_hots, cfg.n_dense_feat,
                              batch=P99_BATCH, seed=0)
    p99 = [p99_stream.batch(step) for step in range(P99_CALLS)]

    # -- 8. serve_scores: serve_p99 and serve_bulk -------------------------------
    for _ in range(3):
        request(p99[0])
    request(bulk)
    torch.cuda.synchronize()
    kg.gather_sum.launches = 0
    lat, p99_out = [], []
    for b in p99:
        t0 = time.perf_counter()
        p99_out.append(request(b))
        lat.append((time.perf_counter() - t0) * 1e3)
    bulk_s = []
    for _ in range(BULK_REPS):
        t0 = time.perf_counter()
        bulk_out = request(bulk)
        bulk_s.append(time.perf_counter() - t0)
    serve_launches = kg.gather_sum.launches
    calls = P99_CALLS + BULK_REPS
    check(serve_launches == fields * calls,
          f"serve_scores launched gather_sum {serve_launches} times in {calls} calls")

    err = 0.0
    for b, got in list(zip(p99, p99_out)) + [(bulk, bulk_out)]:
        check(tuple(got.shape) == (len(b["user_ids"]),) and bool(got.isfinite().all()),
              "serve_scores gave a wrong shape or non-finite scores")
        err = max(err, float_err(got, plain_scores(to_dev(b)).cpu()))
    check(err <= SCORE_TOL, f"serve_scores differ from the plain-bag scores by {err}")
    emit("recsys_serve", config=cfg.name, tables=[list(model.user_table.shape),
                                                  list(model.item_table.shape)],
         launches=serve_launches, launches_per_call=serve_launches / calls,
         max_abs_err=err,
         serve_p99={"batch": P99_BATCH, "calls": P99_CALLS,
                    "median_ms": statistics.median(lat), "p99_ms": percentile(lat, 99),
                    "breakdown": breakdown(p99[0], 10),
                    "device_busy_share": device_busy_share(lambda: request(p99[1]), 20)},
         serve_bulk={"batch": BULK_BATCH, "reps": BULK_REPS,
                     "median_s": statistics.median(bulk_s),
                     "rows_per_s": BULK_BATCH / statistics.median(bulk_s),
                     "breakdown": breakdown(bulk, 3),
                     "device_busy_share": device_busy_share(lambda: request(bulk), 2)})

    # -- 9. retrieval_scores over a pre-embedded corpus ---------------------------
    chunks, have = [], 0
    while have < CORPUS:
        ids = bulk_stream.batch(len(chunks))["item_ids"][: CORPUS - have]
        chunks.append(ids)
        have += len(ids)
    query = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                         cfg.field_hots, cfg.n_dense_feat, batch=1, seed=0).batch(0)

    def ask():
        vals, idx = model.retrieval_scores(to_dev(query), cand, top_k=TOP_K)
        return vals.cpu(), idx.cpu()

    torch.cuda.synchronize()
    kg.gather_sum.launches = 0
    t0 = time.perf_counter()
    cand = torch.cat([model.item_tower(torch.as_tensor(ids, device=dev)) for ids in chunks])
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    for _ in range(3):
        ask()
    q_lat = []
    for _ in range(QUERY_CALLS):
        t0 = time.perf_counter()
        vals, idx = ask()
        q_lat.append((time.perf_counter() - t0) * 1e3)
    retrieval_launches = kg.gather_sum.launches
    want = cfg.item_fields * len(chunks) + cfg.user_fields * (3 + QUERY_CALLS)
    check(retrieval_launches == want,
          f"retrieval launched gather_sum {retrieval_launches} times, expected {want}")

    cand_plain = torch.cat([plain_item(torch.as_tensor(ids, device=dev)) for ids in chunks])
    scores = plain_user(to_dev(query)) @ cand_plain.T / cfg.temperature
    ref_vals, ref_idx = (t.cpu() for t in torch.topk(scores, TOP_K + 1))
    check(tuple(vals.shape) == (1, TOP_K) and bool(vals.isfinite().all()),
          "retrieval_scores gave a wrong shape or non-finite scores")
    err = float_err(vals, ref_vals[:, :TOP_K])
    check(err <= SCORE_TOL, f"retrieval scores differ from the plain-bag ones by {err}")
    gaps = -torch.diff(ref_vals, dim=1) > SCORE_TOL
    apart = gaps & torch.cat([torch.ones_like(gaps[:, :1]), gaps[:, :-1]], dim=1)
    check(torch.equal(idx[apart], ref_idx[:, :TOP_K][apart]),
          "retrieval indices differ from the plain-bag ones where the scores are apart")

    qt = to_dev(query)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    ub = model.user_bags(qt["user_ids"])
    ev[1].record()
    q = model.user_head(ub, qt["user_dense"])
    ev[2].record()
    torch.topk(q @ cand.T / cfg.temperature, TOP_K)
    ev[3].record()
    ev[3].synchronize()
    emit("recsys_retrieval", corpus=int(cand.shape[0]), chunks=len(chunks),
         corpus_seconds=corpus_s, top_k=TOP_K, calls=QUERY_CALLS,
         median_ms=statistics.median(q_lat), p99_ms=percentile(q_lat, 99),
         launches=retrieval_launches, max_abs_err=err, indices_compared=int(apart.sum()),
         device_busy_share=device_busy_share(ask, 20),
         breakdown={"bags_ms": ev[0].elapsed_time(ev[1]), "mlp_ms": ev[1].elapsed_time(ev[2]),
                    "gemm_topk_ms": ev[2].elapsed_time(ev[3])})
    del cand, cand_plain, scores
    return serve_launches + retrieval_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU to drive",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs.datalog_workloads import ALL, SG, TC
        from repro_torch.configs.two_tower_retrieval import FULL
        from repro_torch.data.recsys_stream import RecsysStream
        from repro_torch.kernels import gather_sum as kg
        from repro_torch.models.recsys import TwoTower
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
    torch.backends.cudnn.allow_tf32 = False

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
    kg._lib()
    ptxas = [ln.strip() for log in _build.stats["log"].values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.stats["seconds"],
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()], ptxas=ptxas)

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def bits(rows, cols, density):
        return pack_bits(torch.rand((rows, cols), generator=gen, device=dev) < density)

    err = {"bitmm": 0, "bitmm_fused_delta": 0}
    compared = 0
    cases = [((m, k, n), d) for (m, k, n) in EXACT_SHAPES for d in (0.0, 0.02, 0.3, 1.0)]
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
    def mixed_a():
        """Empty, arc-sparse and dense 1024-bit K stages in turn."""
        stage = torch.arange(G10K, device=dev) // 1024
        density = torch.tensor([0.0, 1e-3, 0.5], device=dev)[stage % 3]
        return pack_bits(torch.rand((G10K, G10K), generator=gen, device=dev) < density)

    main_shape = {}
    main_a = {"sparse": arc, "mixed": mixed_a(), "dense": bits(G10K, G10K, 0.5)}
    for label, a in main_a.items():
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
        library_ms = time_ms(lambda: torch.matmul(af, bf))
        del af, bf
        row = {}
        for name, kernel, plain, n_arrays in (
            ("bitmm", lambda: kb.bitmm(a, arc), lambda: bitmm_plain(a, arc), 3),
            ("bitmm_fused_delta", lambda: kb.bitmm_fused_delta(a, arc, cur),
             lambda: bitmm_fused_delta_plain(a, arc, cur), 5),
        ):
            bound_ms, bound_by = bitmm_bound(a, G10K, n_arrays)
            row[name] = {
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "a_density": int(popcount(a)) / (G10K * G10K),
            }
        main_shape[label] = row
        torch.cuda.empty_cache()
    emit("kernels", exact_cases=compared, max_abs_err=err, n=G10K,
         shape=[G10K, 313], main_shape=main_shape)

    del main_a, cur
    torch.cuda.empty_cache()

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

    def per_launch_ms(fixpoint, arc_m, n):
        """One more fixpoint run, with CUDA events around each product: its
        kernel, ms, the density of its A and its bound, in launch order."""
        from repro_torch.core import bitmatrix

        records = []

        def timed(fn):
            def call(a, *rest):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(a, *rest)
                end.record()
                records.append((fn.__name__, a, start, end))
                return out
            return call

        saved = bitmatrix.bitmm, bitmatrix.bitmm_fused_delta
        bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = timed(kb.bitmm), timed(kb.bitmm_fused_delta)
        try:
            fixpoint(arc_m, n)
        finally:
            bitmatrix.bitmm, bitmatrix.bitmm_fused_delta = saved
        torch.cuda.synchronize()
        return [{"kernel": name, "ms": start.elapsed_time(end),
                 "a_density": int(popcount(a)) / (a.shape[0] * n),
                 "bound_ms": bitmm_bound(a, n, 5 if name == "bitmm_fused_delta" else 3)[0]}
                for name, a, start, end in records]

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
             plain_fixpoint_seconds=plain_seconds, launches=used,
             per_launch=per_launch_ms(fixpoint, arc_n, n))
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

    # -- 7-9. the two-tower serving path at FULL ----------------------------------
    model = TwoTower(FULL, torch.Generator(device=dev).manual_seed(0), device=dev)
    bulk_stream = RecsysStream(FULL.user_vocab, FULL.item_vocab, FULL.user_fields,
                               FULL.item_fields, FULL.field_hots, FULL.n_dense_feat,
                               batch=BULK_BATCH, seed=0)
    bulk = bulk_stream.batch(0)
    gather_shapes = gather_sum_phase(dev, model, bulk)
    launches["gather_sum"] = recsys_phases(dev, FULL, model, bulk_stream, bulk)
    err["gather_sum"] = max(v["max_abs_err"] for v in gather_shapes.values())

    # -- report --------------------------------------------------------------
    sources = {   # name → (CUDA source, the TPU kernel it replaces)
        "bitmm": ("bitmm.cu", "src/repro/kernels/bitmm.py:99 (bitmm_call, body _bitmm_kernel)"),
        "bitmm_fused_delta": (
            "bitmm.cu",
            "src/repro/kernels/bitmm.py:131 (bitmm_fused_delta_call, body _bitmm_fused_kernel)"),
        "gather_sum": (
            "gather_sum.cu",
            "src/repro/kernels/gather_sum.py:49 (gather_sum_call, body _gather_sum_kernel)"),
    }
    timed = {**main_shape["dense"], "gather_sum": gather_shapes["user"]}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name][0]}",
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": timed[name]["ms"],
            "plain_ms": timed[name]["plain_ms"],
            "bound_ms": timed[name]["bound_ms"],
            "bound_by": timed[name]["bound_by"],
            "library_ms": timed[name]["library_ms"],
        }
        for name in sources
    ]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
