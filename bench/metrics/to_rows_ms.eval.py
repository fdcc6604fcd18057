"""PBME: device ms of ``pbme.to_rows`` an evaluation (``bitmatrix_to_table``:
the fixpoint's bit matrix to its sorted table), between the span's CUDA
events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "pbme.to_rows")
