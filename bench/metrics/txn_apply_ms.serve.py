"""Instance: mean ``UpdateStats.seconds`` of the window's transactions, the
writer thread's apply time (propagation and publish), in ms."""


def read(records: dict):
    txns = records.get("txns") if records.get("kind") == "serve" else None
    if not txns:
        return None
    return sum(t["seconds"] for t in txns) / len(txns) * 1e3
