"""Traffic of kind ``serve``: a fixpoint resident in
``DatalogServer(MaterializedInstance(...))`` with MVCC reads on, one writer
and one reader client, each in a closed loop.

The writer submits its transactions (``writer.ops`` in turn, each over the
held-out rows of the update relation, as one ``submit_txn``) and sends the
next when the last reply arrives.  The reader keeps ``reads.outstanding``
point queries in the queue.  One thread drives both through ``step``; the
server applies updates on its own writer thread.  A transaction's reply
arrives when the client loop finds its ``UpdateStats`` in ``done``: the loop
lets the server reap the writer (a ``step`` with no query queued) once the
instance's epoch shows the transaction published.  Each request is timed on
the host clock from its submission to the moment the loop finds its reply.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

#: one reply in this many, drawn from the seed, is kept whole for the check;
#: every reply's size and sum of values is kept
SAMPLE_ONE_IN = 32
#: seconds past the window's close that the client loop waits for replies
GRACE_S = 60.0


class ServerProgram:
    """The system under test: a materialized instance behind a server."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic, self.device = config, traffic, device

    def start(self, text: str, edb: dict):
        from repro_torch.core import EngineConfig
        from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

        self.instance = MaterializedInstance(
            text, edb, EngineConfig(**self.config["engine"]), device=self.device)
        self.server = DatalogServer(self.instance, max_batch=self.traffic["max_batch"])
        return self.server

    def epoch(self) -> int:
        return self.instance.epoch

    def relation(self, rel: str) -> np.ndarray:
        """The latest published epoch's rows of ``rel``."""
        return self.instance.relation(rel)

    def close(self) -> None:
        self.server.close()
        self.server = self.instance = None


@dataclass
class ServeWindow:
    txns: list[dict]
    reads: list[dict]
    window_s: float
    queued_s: dict[int, float] = field(default_factory=dict)   # read rid → queue seconds


def window(program, config: dict, traffic: dict, held: np.ndarray, keys: np.ndarray,
           seconds: float, seed: int) -> ServeWindow:
    srv = program.server
    upd = config["serve"]["update"]["relation"]
    read = config["serve"]["read"]
    ops = traffic["writer"]["ops"]
    outstanding = traffic["reads"]["outstanding"]
    keep = random.Random(seed)
    txns, reads, pending = [], [], {}
    txn = None
    k = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        open_ = time.perf_counter() < deadline
        if open_ and txn is None:
            txn = {"op": ops[len(txns) % len(ops)], "epoch0": program.epoch(),
                   "submitted": time.perf_counter()}
            txn["rid"] = srv.submit_txn([(txn["op"], upd, held)])
            txns.append(txn)
        while open_ and len(pending) < outstanding:
            key = int(keys[k % len(keys)])
            k += 1
            r = {"key": key, "submitted": time.perf_counter()}
            r["rid"] = srv.submit_query(read["relation"], **{read["column"]: key})
            pending[r["rid"]] = r
            reads.append(r)
        if not pending and txn is None:
            break
        if not open_ and time.perf_counter() > deadline + GRACE_S:
            break                        # what has not come by now never comes
        srv.step()
        now = time.perf_counter()
        for rid in [rid for rid in pending if rid in srv.done]:
            r = pending.pop(rid)
            _reply(r, srv.done.pop(rid), now, keep)
        if txn is not None and not pending and txn["rid"] not in srv.done \
                and program.epoch() != txn["epoch0"]:
            srv.step()                  # nothing queued: reaps the published writer
            now = time.perf_counter()
        if txn is not None and txn["rid"] in srv.done:
            txn["result"] = srv.done.pop(txn["rid"])
            txn["done"] = now
            txn = None
    window_s = time.perf_counter() - t0
    rids = {r["rid"] for r in reads}
    queued = {rec.rid: rec.queued_seconds for rec in srv.stats.snapshot()
              if rec.rid in rids}
    return ServeWindow(txns, reads, window_s, queued)


def _reply(r: dict, res, now: float, keep: random.Random) -> None:
    r["done"] = now
    if isinstance(res, Exception):
        r["error"] = f"{type(res).__name__}: {res}"[:500]
        return
    res = np.asarray(res)
    r["size"] = len(res)
    r["sum"] = int(res[:, 1].sum(dtype=np.int64)) if len(res) else 0
    r["keyed"] = bool((res[:, 0] == r["key"]).all()) if len(res) else True
    if keep.randrange(SAMPLE_ONE_IN) == 0:
        r["rows"] = res


def warm(program, config: dict, traffic: dict, held: np.ndarray, keys: np.ndarray) -> int:
    """Set-up's warm-up: one round of the writer's ops and a batch of reads
    through the server.  Returns the transactions applied."""
    srv = program.server
    upd = config["serve"]["update"]["relation"]
    read = config["serve"]["read"]
    for op in traffic["writer"]["ops"]:
        rid = srv.submit_txn([(op, upd, held)])
        for key in keys[: traffic["reads"]["outstanding"]]:
            srv.submit_query(read["relation"], **{read["column"]: int(key)})
        srv.run()
        if isinstance(srv.done.get(rid), Exception):
            raise RuntimeError(f"warm-up {op} failed: {srv.done[rid]}")
        srv.done.clear()
    return len(traffic["writer"]["ops"])


def states_allowed(r: dict, txns: list[dict]) -> range:
    """The numbers of the window's transactions that may have published when
    a read pinned its epoch: at least those seen done before it was
    submitted, at most those submitted before its reply was found."""
    lo = sum(1 for t in txns if "done" in t and t["done"] <= r["submitted"])
    hi = sum(1 for t in txns if t["submitted"] <= r["done"])
    return range(lo, hi + 1)


