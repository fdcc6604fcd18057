"""Server: the 99th percentile (nearest rank) of the window's reads'
latency on the host clock, from ``submit_query`` to the moment the client
loop finds the reply, in ms.  The loop reaps the writer only between read
batches, so a slow batch holds back the transaction's reply too."""

from bench.harness.peaks import percentile


def read(records: dict):
    reads = records.get("reads") if records.get("kind") == "serve" else None
    if not reads:
        return None
    return percentile([r["latency_s"] * 1e3 for r in reads], 99)
