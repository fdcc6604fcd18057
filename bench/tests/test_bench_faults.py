"""The check finds a broken timed path: each run drives the rest of a run on
the CPU with one fault planted in the program underneath, and ``correct``
comes out false.  Also the control (the reference one round short, in the
program's place)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench.harness import cell
from bench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, name):
    return cell.run(name, 2**31 + 21, 0.3, False, t_start=time.perf_counter(), root=root,
                    device="cpu")


def _unchanged_step(mp):
    """Every step returns its state unchanged: PBME's product finds nothing
    new, a transaction applies nothing."""
    from repro_torch.core import bitmatrix
    from repro_torch.serve_datalog import instance

    mp.setattr(bitmatrix, "bitmm_fused_delta", lambda a, b, m: (torch.zeros_like(m), m))
    mp.setattr(instance.MaterializedInstance, "apply_txn",
               lambda self, ops, deadline_check=None: instance.UpdateStats(
                   relation="arc", requested=0, kind="txn", epoch=self.epoch))


def _half_batch(mp):
    """Half of each batch left out: the EDB's upload and each transaction's
    rows."""
    from repro_torch.core import relation
    from repro_torch.serve_datalog import instance

    real_upload = relation.TupleRelation.from_numpy.__func__
    mp.setattr(relation.TupleRelation, "from_numpy", classmethod(
        lambda cls, name, data, domain, device: real_upload(
            cls, name, np.asarray(data)[: max(len(data) // 2, 1)], domain, device)))
    real = instance.MaterializedInstance.apply_txn
    mp.setattr(instance.MaterializedInstance, "apply_txn",
               lambda self, ops, deadline_check=None: real(
                   self, [(op, rel, np.asarray(rows)[: len(rows) // 2 or 1])
                          for op, rel, rows in ops], deadline_check))


def _altered_answer(mp):
    """One answer altered where it is produced: a fact of the fixpoint's
    table, and a row of each read's reply."""
    from repro_torch.core import engine
    from repro_torch.serve_datalog import instance

    real_take = engine.Engine.take_store

    def take(self):
        store = real_take(self)
        for h in store.values():
            if h.count and h.rows.shape[1] == 2 and getattr(h, "name", "") == "tc":
                h.rows[0, 1] = (h.rows[0, 1] + 1) % self.domain
        return store

    mp.setattr(engine.Engine, "take_store", take)
    real_query = instance.MaterializedInstance.query

    def query(self, rel, **kw):
        rows = real_query(self, rel, **kw).copy()
        if len(rows):
            rows[-1, 1] = (rows[-1, 1] + 1) % self.domain
        return rows

    mp.setattr(instance.MaterializedInstance, "query", query)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _altered_answer])
@pytest.mark.parametrize("name", ["tc-tiny.eval", "tc-tiny.serve"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault, name):
    assert _run(root, name)["correct"]
    with monkeypatch.context() as mp:
        fault(mp)
        r = _run(root, name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", ["tc-tiny.eval", "tc-tiny.serve"])
def test_the_control_is_not_correct(root, name):
    from bench.control import control_run

    r = control_run(name, 2**31 + 22, 0.3, "cpu", root=root)
    assert r["correct"] is False
    assert r["checks"]["missing_facts" if name.endswith("eval") else "final_missing_facts"][
        "value"] > 0
