"""Kernels: the ``bitmm`` products' share of their roofline, the sum of each
call's least time (``bench.harness.peaks.bitmm_bound_s``) over the sum of
its time between CUDA events, in %."""


def read(records: dict):
    calls = records.get("bitmm_calls")
    if not calls:
        return None
    return 100.0 * sum(bound for bound, _ in calls) / sum(t for _, t in calls)
