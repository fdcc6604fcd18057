"""Engine loop: device ms of the tuple path's joins an evaluation, the
``join`` spans (the counts pass, the host's read of the total and the
expansion into bindings), between each span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "join")
