"""Observability: span tracing, metrics, EXPLAIN/ANALYZE, latency statistics.

Stdlib-only apart from :func:`repro_torch.obs.profile.device_memory_stats`,
which imports torch when it is called to read the CUDA caching allocator, so
``core``, ``serve_datalog`` and ``persist`` can all import this package and
loading it imports no torch.
"""

from repro_torch.obs.explain import (
    PlanEstimate,
    RuleEstimate,
    StratumEstimate,
    estimate_plan,
    estimate_query_rows,
    estimate_rule,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profile import (
    RATIO_BUCKETS,
    FixpointProfile,
    ProfileNode,
    RuleProfile,
    StratumProfile,
    build_profile,
    device_memory_stats,
    misestimation_ratio,
    spans_for_rid,
)
from repro_torch.obs.stats import latency_summary, nearest_rank, percentile
from repro_torch.obs.trace import NOOP_SPAN, Span, Tracer, TRACER, get_tracer

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "FixpointProfile",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOOP_SPAN",
    "PlanEstimate",
    "ProfileNode",
    "RATIO_BUCKETS",
    "RuleEstimate",
    "RuleProfile",
    "Span",
    "StratumEstimate",
    "StratumProfile",
    "TRACER",
    "Tracer",
    "build_profile",
    "device_memory_stats",
    "estimate_plan",
    "estimate_query_rows",
    "estimate_rule",
    "get_tracer",
    "latency_summary",
    "misestimation_ratio",
    "nearest_rank",
    "percentile",
    "spans_for_rid",
]
