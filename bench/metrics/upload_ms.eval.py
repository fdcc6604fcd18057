"""Front end: host ms of ``edb.upload`` an evaluation (each EDB relation's
host-to-card copy and its dedup on the card, ``TupleRelation.from_numpy``)."""

from bench.harness.spans import host_ms, per_evaluation


def read(records: dict):
    return per_evaluation(records, host_ms, "edb.upload")
