"""The control: the plain reference put in the program's place, with one
guarantee of the configuration broken, the step that would tempt a later
change: the fixpoint loop stopped one productive round short.

In an ``eval`` cell it answers each evaluation; in a ``serve`` cell it
stands in for the server (transactions applied at once, reads answered
from the truncated fixpoint of the state they see).  The check has to find
it not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.harness.check import reference_iterations
from bench.harness.evalcell import Evaluation
from bench.harness.spec import ROOT, reference


def reference_rows(ref) -> torch.Tensor:
    """A reference's facts as int32 rows, lexicographic: a closure's
    ``[count, 2]`` pairs; a keyed relation's ``(key, value)`` pairs, or its
    keys as ``[count, 1]``."""
    if not hasattr(ref, "bits"):
        cols = [ref.keys] if ref.values is None else [ref.keys, ref.values]
        return torch.stack(cols, dim=1).to(torch.int32)
    idx, ys = torch.nonzero(ref.bits, as_tuple=True)
    return torch.stack([ref.keys[idx], ys], dim=1).to(torch.int32)


def _short(config: dict, edb: dict, n: int, device, root=ROOT):
    ref = reference(config["reference"]["kind"], root)
    full = ref.fixpoint(edb, config["reference"], n, device)
    return ref.fixpoint(edb, config["reference"], n, device,
                        max_rounds=max(full.rounds - 1, 0)), full.rounds


class ShortFixpoint:
    """``eval``: each evaluation the reference one round short, reporting its
    rounds as the tuple path counts them."""

    def __init__(self, config: dict, n: int, device, root=ROOT):
        self.config, self.n, self.device, self.root = config, n, device, root

    def __call__(self, text: str, edb: dict) -> Evaluation:
        short, _ = _short(self.config, edb, self.n, self.device, self.root)
        rows = reference_rows(short)
        return Evaluation(rows=rows, count=len(rows),
                          iterations=reference_iterations(short, "tuple"),
                          backend="tuple", stratum_s=0.0)


class ShortServer:
    """``serve``: the server protocol over the two states' short fixpoints."""

    def __init__(self, config: dict, n: int, held: np.ndarray, device, root=ROOT):
        self.config, self.n, self.held, self.device = config, n, held, device
        self.root = root

    def start(self, text: str, edb: dict):
        from bench.harness.cell import _without

        upd = self.config["serve"]["update"]["relation"]
        held_out = dict(edb)
        held_out[upd] = _without(edb[upd], self.held, self.n)
        self.edbs = {"full": edb, "held_out": held_out}
        self.short = {s: _short(self.config, e, self.n, self.device, self.root)[0]
                      for s, e in self.edbs.items()}
        self.state, self._epoch, self.server = "full", 0, self
        self.queue, self.done, self._next = [], {}, 0
        self.stats = _NoStats()
        return self

    # the server's surface the client loop uses
    def submit_txn(self, ops) -> int:
        return self._put(("txn", ops))

    def submit_query(self, rel: str, **kw) -> int:
        return self._put(("query", kw))

    def _put(self, item) -> int:
        self._next += 1
        self.queue.append((self._next, item))
        return self._next

    def step(self) -> bool:
        for rid, (kind, payload) in self.queue:
            if kind == "txn":
                op = payload[0][0]
                self.state = "held_out" if op == "delete" else "full"
                self._epoch += 1
                self.done[rid] = _Applied(len(self.held))
            else:
                key = next(iter(payload.values()))
                ys = self.short[self.state].row(int(key))
                self.done[rid] = np.stack([np.full(len(ys), key), ys], axis=1).astype(np.int32)
        self.queue.clear()
        return False

    def run(self):
        self.step()
        return self.done

    def epoch(self) -> int:
        return self._epoch

    def relation(self, rel: str) -> np.ndarray:
        if rel == self.config["idb"]:
            return reference_rows(self.short[self.state]).cpu().numpy()
        return self.edbs[self.state][rel]

    def close(self) -> None:
        pass


class _Applied:
    """What the client loop reads of an ``UpdateStats``."""

    def __init__(self, rows: int):
        self.removed = self.inserted = rows
        self.seconds = 0.0


class _NoStats:
    def snapshot(self) -> list:
        return []
