"""Server: device ms of a read's ``query.lookup`` (the key column's copy, the
keys' upload and the two ``searchsorted``), between the span's CUDA events,
averaged over the window's reads."""

from bench.harness.spans import device_ms, named


def read(records: dict):
    times = [t for t in map(device_ms, named(records, "serve", "query.lookup")) if t is not None]
    return sum(times) / len(times) if times else None
