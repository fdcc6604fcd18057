"""PBME: bit-matrix products an evaluation, the ``products`` of
``pbme.fixpoint`` (the ``bitmm`` and ``bitmm_fused_delta`` launches, counted
where launched)."""

from bench.harness.spans import per_evaluation


def read(records: dict):
    return per_evaluation(records, lambda s: s.args.get("products"), "pbme.fixpoint")
