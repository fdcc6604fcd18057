"""Engine loop: device ms of the tuple path's dedup an evaluation, the
``uie.dedup`` spans (one a round: the concat of the rule variants' buffers,
the sort of the padded rows and the compaction of each run's first row),
between each span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "uie.dedup")
