"""PBME, same generation: device ms of SG's prologue an evaluation,
``pbme.transpose`` (the arc's transpose) plus ``pbme.mask`` (the packed
identity), between each span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "pbme.transpose", "pbme.mask")
