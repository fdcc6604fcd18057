"""Engine loop: device ms of the set differences' membership tests an
evaluation, the ``membership`` spans whichever their ``path`` (the compact
key's ``searchsorted`` or the scan's lexsort and ``cummax``), between each
span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "membership")
