"""Engine loop: the body rows the dense MIN/MAX table's rounds hand to its
update an evaluation, the sum of the ``agg.propagate`` spans' ``candidates``.
Fixed by the data for each seed; a change that prunes the propagation's
work shows here."""

from bench.harness.spans import per_evaluation


def read(records: dict):
    return per_evaluation(records, lambda s: s.args.get("candidates"), "agg.propagate")
