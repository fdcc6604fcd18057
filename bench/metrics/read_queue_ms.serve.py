"""Server: mean ``queued_seconds`` (``ServerStats``) of the window's reads,
the time from submission to the start of the batch that served it, in ms."""


def read(records: dict):
    reads = records.get("reads") if records.get("kind") == "serve" else None
    if not reads:
        return None
    return sum(r["queued_s"] for r in reads) / len(reads) * 1e3
