"""Engine loop: the rows the tuple path's rule variants derive an
evaluation before the dedup, the sum of the ``uie.dedup`` spans'
``candidates``.  Fixed by the data; a change that prunes derivations shows
here."""

from bench.harness.spans import per_evaluation


def read(records: dict):
    return per_evaluation(records, lambda s: s.args.get("candidates"), "uie.dedup")
