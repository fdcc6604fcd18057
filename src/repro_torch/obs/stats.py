"""Shared nearest-rank percentile helpers.

One definition of the percentile convention used across the codebase
(``ServerStats.latency`` in ``serve_datalog/server.py`` and the serving
benchmarks): the *nearest-rank* method, where the q-th percentile of n
sorted samples is the sample at index ``ceil(q·n) - 1`` — the smallest
sample with at least ``q·n`` samples ≤ it.  ``int(q·n)`` would be biased
high for small n (the p50 of 2 samples must be the lower one, not the max).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """The q-th nearest-rank percentile of an already-sorted sequence."""
    if not sorted_values:
        raise ValueError("nearest_rank of an empty sequence")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    return sorted_values[max(math.ceil(q * len(sorted_values)) - 1, 0)]


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted iterable."""
    return nearest_rank(sorted(values), q)


def latency_summary(
    seconds: Iterable[float], percentiles: Sequence[float] = (0.50, 0.95)
) -> dict:
    """``{"count", "p50_ms", "p95_ms", "max_ms"}`` from per-request seconds.

    The shape every latency surface in the repo reports: an empty sample set
    collapses to ``{"count": 0}``; otherwise each requested percentile lands
    as ``p<q*100>_ms`` in milliseconds plus the max.
    """
    lats = sorted(seconds)
    if not lats:
        return {"count": 0}
    out: dict = {"count": len(lats)}
    for q in percentiles:
        out[f"p{int(round(q * 100))}_ms"] = nearest_rank(lats, q) * 1e3
    out["max_ms"] = lats[-1] * 1e3
    return out
