"""Engine loop: device ms from a round's distinct candidates to the new
table an evaluation, the ``dsd`` spans (the set difference against the table,
its membership tests included) and the ``idb.merge`` spans (the sorted merge
of the new facts), between each span's CUDA events."""

from bench.harness.spans import device_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, device_ms, "dsd", "idb.merge")
