"""Engine loop: device ms of the dense MIN/MAX table's rounds an evaluation,
the ``agg.propagate`` spans (one a round, the base included: Δ's keys, the
join with the arcs and the update of the table, host waits included),
between each span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "agg.propagate")
