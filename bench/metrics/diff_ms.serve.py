"""Instance: host ms of ``recompute.diff`` a transaction that recomputes a
stratum (the old fixpoint against the new one after a delete's full
recompute), summed over the transaction's strata and averaged over such
transactions."""

from bench.harness.spans import by_id, enclosing, host_ms, named


def read(records: dict):
    diffs = named(records, "serve", "recompute.diff")
    if not diffs:
        return None
    spans = by_id(records)
    txns = {id(enclosing(s, spans, "txn.apply") or s) for s in diffs}
    return sum(map(host_ms, diffs)) / len(txns)
