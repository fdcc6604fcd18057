"""The batching server and the refusals: ``repro_torch.serve_datalog`` against
``repro.serve_datalog``.

The same request script goes through the reference's ``DatalogServer`` and
the port's, serialized (``snapshot_reads=False``) so that every reply is
deterministic, and the replies, per-request records and counters must be
equal; the MVCC mode is held to the reference's contract (a read during an
update sees the pinned epoch, coalesced transactions publish one epoch).
The analyzer's surfaces of the server (``lint``, ``explain(adorn=...)``,
``on_demand`` queries) are held against the reference in
``test_torch_analysis.py`` and ``test_torch_demand.py``.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from conftest import random_edges
from repro.serve_datalog import DatalogServer as RefServer
from repro.serve_datalog import RequestError as RefRequestError
from repro_torch.serve_datalog import (
    DatalogServer,
    MaterializedInstance,
    PlanCache,
    RequestError,
    ServerLimits,
    UpdateStats,
)
from torch_parity import TC, TWO_EDB_TC, ServePair, stats_key

COUNTERS = (
    'datalog_requests_total{kind="query"}', 'datalog_requests_total{kind="txn"}',
    'datalog_requests_total{kind="insert"}', 'datalog_requests_total{kind="delete"}',
    "datalog_request_errors_total", "datalog_update_groups_total",
    "datalog_coalesced_requests_total", "datalog_rows_inserted_total",
    "datalog_rows_removed_total", "datalog_rows_derived_total",
    "datalog_rows_retracted_total", "datalog_full_rebuilds_total", "datalog_epoch",
)


def _script(srv, edges, held):
    """One request script: queries, transactions (two compatible ones that
    group-commit), legacy shims, an invalid payload, a domain growth."""
    rids = [srv.submit_query("tc", src=3)]
    rids.append(srv.transaction().insert("arc", held[:3]).retract("arc", edges[:2]).submit())
    rids.append(srv.submit_txn([("insert", "arc", held[3:5])]))
    rids.append(srv.submit_query("tc", where={0: (2, 5)}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rids.append(srv.submit_insert("arc", held[5:7]))
        rids.append(srv.submit_insert("arc", held[7:8]))
        rids.append(srv.submit_delete("arc", edges[2:3]))
        rids.append(srv.submit_insert("arc", np.array([[-1, 0]], np.int32)))
    rids.append(srv.submit_query("tc", dst=4))
    rids.append(srv.submit_txn([("insert", "arc", np.array([[0, 40]], np.int32))]))
    rids.append(srv.submit_query("tc", src=(0, 40)))
    return rids


def _reply_key(reply):
    if isinstance(reply, (RequestError, RefRequestError)):
        return ("error", reply.rid, reply.error)
    if isinstance(reply, np.ndarray):
        return ("rows", reply.dtype.str, reply.tolist())
    return ("stats", stats_key(reply))


@pytest.mark.parametrize("backend", ["tuple", "auto"])
def test_server_replies_match(backend):
    edges = random_edges(np.random.default_rng(7), 24, 70)
    pair = ServePair(TC, {"arc": edges[:-8]}, backend=backend)
    servers = {
        "ref": RefServer(pair.ref, max_batch=8, snapshot_reads=False),
        "port": DatalogServer(pair.port, max_batch=8, snapshot_reads=False),
    }
    rids = {k: _script(srv, edges, edges[-8:]) for k, srv in servers.items()}
    done = {k: srv.run() for k, srv in servers.items()}
    assert rids["ref"] == rids["port"]
    for rid in rids["ref"]:
        assert _reply_key(done["port"][rid]) == _reply_key(done["ref"][rid]), rid
    assert isinstance(done["port"][rids["port"][-4]], RequestError)   # negative id
    records = {
        k: [(r.rid, r.kind, r.rel, r.batch_size, r.epoch, r.concurrent)
            for r in srv.stats.snapshot()]
        for k, srv in servers.items()
    }
    assert records["port"] == records["ref"]
    metrics = {k: srv.metrics() for k, srv in servers.items()}
    for name in COUNTERS:
        assert metrics["port"][name] == metrics["ref"][name], name
    pair.check()


def test_group_commit_and_conflicts():
    rng = np.random.default_rng(1)
    arc = np.unique(rng.integers(0, 12, size=(26, 2)), axis=0).astype(np.int32)
    rail = np.unique(rng.integers(0, 12, size=(18, 2)), axis=0).astype(np.int32)
    pair = ServePair(TWO_EDB_TC, {"arc": arc[:-6], "rail": rail}, backend="tuple")
    for inst, cls in ((pair.ref, RefServer), (pair.port, DatalogServer)):
        srv = cls(inst)
        e0 = inst.epoch
        a = srv.submit_txn([("insert", "arc", arc[-6:-4])])
        b = srv.transaction().insert("arc", arc[-4:-2]).retract("rail", rail[:2]).submit()
        c = srv.submit_txn([("insert", "rail", rail[:1])])     # conflicts with b
        srv.run()
        assert srv.done[a].epoch == srv.done[b].epoch == e0 + 1   # one group commit
        assert srv.done[c].epoch == e0 + 2
        assert inst.epoch == e0 + 2
    pair.check()


def test_invalid_transactions_are_refused_at_submission():
    edges = random_edges(np.random.default_rng(2), 16, 40)
    pair = ServePair(TC, {"arc": edges})
    for ops in ([], [("insert", "tc", edges[:1])], [("upsert", "arc", edges[:1])],
                [("insert", "arc", edges[:1]), ("delete", "arc", edges[:1])]):
        with pytest.raises(RefRequestError) as want:
            RefServer(pair.ref).submit_txn(ops)
        with pytest.raises(RequestError) as got:
            DatalogServer(pair.port).submit_txn(ops)
        assert str(got.value) == str(want.value)
    srv = DatalogServer(pair.port, limits=ServerLimits(max_queue_depth=1,
                                                       overload_policy="reject"))
    srv.submit_query("tc")
    with pytest.raises(RequestError, match="overload policy is reject"):
        srv.submit_query("tc")


def test_read_during_update_sees_the_pinned_epoch(monkeypatch):
    """A query admitted while a transaction is in flight on the writer
    thread returns the pre-update fixpoint; after the run every relation is
    the reference's."""
    edges = random_edges(np.random.default_rng(3), 16, 36)
    pair = ServePair(TC, {"arc": edges[:-4]}, backend="tuple")
    inst = pair.port
    pre = inst.relation("tc")
    srv = DatalogServer(inst)
    entered, release = threading.Event(), threading.Event()
    orig = inst._delta_stratum

    def paused(*a, **k):
        entered.set()
        assert release.wait(timeout=60)
        return orig(*a, **k)

    monkeypatch.setattr(inst, "_delta_stratum", paused)
    t = srv.submit_txn([("insert", "arc", edges[-4:])])
    q = srv.submit_query("tc")

    def unblock():
        assert entered.wait(timeout=60)
        for _ in range(6000):
            if q in srv.done:
                break
            threading.Event().wait(0.01)
        release.set()

    helper = threading.Thread(target=unblock)
    helper.start()
    done = srv.run()
    helper.join(timeout=60)
    assert not helper.is_alive()
    rec = next(r for r in srv.stats.snapshot() if r.rid == q)
    assert rec.concurrent and rec.epoch == 0
    np.testing.assert_array_equal(done[q], pre)
    assert isinstance(done[t], UpdateStats) and done[t].epoch == 1
    pair.ref.apply_txn([("insert", "arc", edges[-4:])])
    pair.check()
    assert srv.mvcc_stats()["concurrent_reads"] >= 1


def test_explain_profile_and_stats():
    edges = random_edges(np.random.default_rng(4), 16, 40)
    pair = ServePair(TC, {"arc": edges[:-3]}, backend="tuple")
    srv = DatalogServer(pair.port)
    rid = srv.submit_txn([("insert", "arc", edges[-3:])], profile=True)
    q = srv.submit_query("tc", src=1, profile=True)
    srv.run()
    assert srv.profile(rid).rid == rid and srv.profile(q).rid == q
    assert "tc" in srv.explain(text=True)
    pair.ref.apply_txn([("insert", "arc", edges[-3:])])
    pair.check()
    ref_est, port_est = pair.ref.explain(), pair.port.explain()
    assert port_est.to_json() == ref_est.to_json()
    assert srv.metrics()['datalog_requests_total{kind="txn"}'] == 1
    assert "datalog_epoch" in srv.metrics_prometheus()
    assert srv.slow_queries() == []
    srv.close()


# --------------------------------------------------------------------------
# the device
# --------------------------------------------------------------------------


def _tiny():
    return MaterializedInstance(
        TC, {"arc": np.array([[0, 1], [1, 2]], np.int32)}, cache=PlanCache(),
        device="cpu",
    )


def test_instance_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the instance runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MaterializedInstance(TC, {"arc": np.array([[0, 1]], np.int32)})
    inst = _tiny()
    assert inst.device.type == "cpu" and inst.engine.device.type == "cpu"
    assert inst.vstore.latest().ready is None
