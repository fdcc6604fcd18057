"""Engine loop: the dense MIN/MAX table's rounds' share of their roofline, in
%: the sum over the ``agg.propagate`` spans of each round's least time
(:func:`propagate_bytes` at ``bench.harness.peaks.HBM_BYTES_PER_S``) over the
sum of their device time.

A span's device time runs from the round's start to its end on the stream,
the host's waits inside it (the join's total, the counts) included, so the
share reads the whole round, not one kernel."""

from bench.harness.peaks import HBM_BYTES_PER_S
from bench.harness.spans import named


def propagate_bytes(candidates: int, domain: int) -> int:
    """The least bytes of one round: the arc rows that Δ's keys select, read
    once as int32 pairs, and the int32 table of ``domain`` values read once
    and written once."""
    return 8 * candidates + 8 * domain


def read(records: dict):
    spans = [s for s in named(records, "eval", "agg.propagate")
             if s.device_ns and "candidates" in s.args]
    if not spans:
        return None
    least_s = sum(propagate_bytes(s.args["candidates"], s.args["domain"])
                  for s in spans) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(s.device_ns for s in spans) / 1e9)
