#!/usr/bin/env python3
"""How long concurrent point reads wait beside each step of a snapshot write, on the card.

Materializes TC over G10K (``gnp_graph(10000, p=0.001, seed=1)``: 10^8
facts, a 2^27-row table of 1.07 GB) in a ``MaterializedInstance`` on CUDA
behind a ``DatalogServer``, then runs each step of a snapshot write alone on
a second thread while the main thread serves point reads (``tc(src=v)``,
eight per batch, as ``chip_smoke.py``'s ``durable_g10k`` does), and prints
one JSON line per step: the step's seconds and the read batches' latency
while it ran (p50, p99 and the longest batch, ms).  The steps:

* ``idle``          — nothing (the yardstick);
* ``to_host``       — the table's device → host copy, as the codec makes it
  (``repro_torch.core.relation.to_host``);
* ``save_npy``      — the snapshot codec's writer (``codec.save_npy``: the same
  bytes as ``np.save``, written in ``codec.WRITE_CHUNK_BYTES`` pieces);
* ``fsync``         — ``os.fsync`` of the saved file;
* ``sha256``        — the codec's SHA-256 pass over the saved file;
* ``remove``        — deleting the saved file;
* ``checkpoint``    — a whole ``DatalogServer.checkpoint_now()``.

Usage, from the repository root on a machine with a GPU::

    PYTHONPATH=src python3 tools/checkpoint_stalls.py [--dir DIR] [--n 10000]

``--dir`` is where files are written (default: a ``tempfile.mkdtemp()``,
removed at the end).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.datalog_workloads import ALL  # noqa: E402
from repro_torch.core.relation import to_host  # noqa: E402
from repro_torch.data.graphs import gnp_graph  # noqa: E402
from repro_torch.persist import DurabilityConfig, codec  # noqa: E402
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance  # noqa: E402

BATCH = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None)
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("checkpoint_stalls: needs a CUDA device", file=sys.stderr)
        return 2
    work = args.dir or tempfile.mkdtemp(prefix="checkpoint_stalls-")
    os.makedirs(work, exist_ok=True)
    try:
        return run(work, args.n)
    finally:
        if args.dir is None:
            shutil.rmtree(work, ignore_errors=True)


def run(work: str, n: int) -> int:
    dev = torch.device("cuda")
    edges = gnp_graph(n, p=0.001, seed=1)
    inst = MaterializedInstance(ALL["tc"].program, {"arc": edges}, device=dev)
    srv = DatalogServer(inst, max_batch=BATCH,
                        durability=DurabilityConfig(os.path.join(work, "root"),
                                                    checkpoint_every_epochs=0,
                                                    checkpoint_wal_bytes=0))
    table = inst.store["tc"].rows
    srcs = np.random.default_rng(0).integers(0, n, size=64).tolist()
    path = os.path.join(work, "table.npy")
    state: dict = {}

    def read_batch(i: int) -> float:
        t0 = time.perf_counter()
        rids = [srv.submit_query("tc", src=int(srcs[(i + j) % len(srcs)]))
                for j in range(BATCH)]
        while any(r not in srv.done for r in rids):
            srv.step()
        return (time.perf_counter() - t0) * 1e3

    def sha():
        codec._sha256(path)

    def fsync():
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def checkpoint():
        # a new epoch (a self-loop is never in a Gn-p arc), so that the
        # checkpoint has one to write
        inst.apply_txn([("insert", "arc", np.array([[1, 1]], np.int32))])
        srv.checkpoint_now()

    steps = [
        ("idle", lambda: time.sleep(0.5)),
        ("to_host", lambda: state.__setitem__("host", to_host(table))),
        ("save_npy", lambda: codec.save_npy(path, state["host"])),
        ("fsync", fsync),
        ("sha256", sha),
        ("remove", lambda: os.remove(path)),
        ("checkpoint", checkpoint),
    ]
    for i in range(4):                        # warm the read path
        read_batch(i)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(json.dumps({"card": smi.strip(), "dir": work, "table_bytes":
                      table.numel() * table.element_size()}), flush=True)
    for name, fn in steps:
        torch.cuda.synchronize()
        done = {}

        def body():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            done["seconds"] = time.perf_counter() - t0

        th = threading.Thread(target=body)
        th.start()
        lat, i = [], 0
        while th.is_alive() or not lat:
            lat.append(read_batch(i))
            i += BATCH
        th.join()
        lat.sort()
        print(json.dumps({
            "step": name, "seconds": done.get("seconds"), "batches": len(lat),
            "p50_ms": statistics.median(lat),
            "p99_ms": lat[max(0, -(-len(lat) * 99 // 100) - 1)], "max_ms": lat[-1],
        }), flush=True)
    srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
