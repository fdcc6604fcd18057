"""The port's tracer on the CPU: the off path, spans without device time,
the sync count, the export's clock, and the spans of the serving layer.

Its cases on the card (device time read from CUDA events, syncs counted
from PyTorch's sync debug mode, spans against the profiler's device trace)
are in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import threading
import time
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from conftest import random_edges
from repro_torch.core import EngineConfig
from repro_torch.obs import trace
from repro_torch.obs.profile import build_profile
from repro_torch.obs.trace import NOOP_SPAN, PORT_ONLY_SPANS, TRACER, Tracer
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance

TC = """
tc(x,y) :- arc(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
"""


def test_off_path_is_the_noop_span_and_keeps_nothing():
    tr = Tracer()
    assert tr.span("x", "t", big=1) is NOOP_SPAN
    assert tr.device_span("x", "t", device="cpu", big=1) is NOOP_SPAN
    assert tr.inherit("rid") == {}
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for i in range(20_000):
            with tr.span("a", "t", i=i) as sp:
                sp.set(rows=i)
            with tr.device_span("b", "t", device="cpu", i=i) as sp:
                sp.set(rows=i)
            tr.count_sync()
            tr.inherit("rid")
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 1024
    assert tr.spans() == []


def test_cpu_spans_have_no_device_time_and_no_syncs():
    tr = Tracer()
    tr.enable()
    with tr.device_span("outer", "t", device="cpu", rel="arc") as sp:
        with tr.device_span("inner", "t", device="cpu"):
            torch.ones(8).sum().item()
        sp.set(rows=3)
    tr.disable()
    spans = {s.name: s for s in tr.spans()}
    assert spans["outer"].args == {"rel": "arc", "rows": 3}
    assert spans["inner"].parent_id == spans["outer"].span_id
    for s in spans.values():
        assert s.device_ns is None and s.syncs == 0 and s.dur_ns >= 0


def test_explicit_syncs_count_in_every_open_span():
    tr = Tracer()
    tr.count_sync()                  # off: nothing
    tr.enable()
    with tr.span("outer"):
        tr.count_sync()
        with tr.span("inner"):
            tr.count_sync()
            tr.count_sync()
    with tr.span("after"):
        pass
    tr.disable()
    assert {s.name: s.syncs for s in tr.spans()} == {"outer": 3, "inner": 2, "after": 0}


def test_sync_warnings_are_counted_per_thread_and_never_shown(monkeypatch, recwarn):
    """With CUDA present, ``enable`` turns PyTorch's sync debug mode to
    ``warn`` and counts each warning on the thread that made it; other
    warnings still show; ``disable`` puts everything back."""
    modes = []
    monkeypatch.setattr(trace, "_cuda_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown, filters = warnings.showwarning, list(warnings.filters)

    def sync():
        warnings.warn(trace._SYNC_WARNING + " (Triggered internally)", UserWarning)

    tr = Tracer()
    tr.enable()
    try:
        with tr.span("main"):
            for _ in range(3):
                sync()
            warnings.warn("something else", UserWarning)

        def other():
            with tr.span("other"):
                sync()
                sync()

        t = threading.Thread(target=other)
        t.start()
        t.join()
    finally:
        tr.disable()
    assert modes == ["warn", 0]
    assert warnings.showwarning is shown and warnings.filters == filters
    assert {s.name: s.syncs for s in tr.spans()} == {"main": 3, "other": 2}
    assert [str(w.message) for w in recwarn] == ["something else"]


def _one_span_a_thread(tr, threads):
    def work(i):
        with tr.span("writer", i=i):
            pass

    for i in range(threads):          # one at a time: idents are reused
        t = threading.Thread(target=work, args=(i,), name="datalog-writer")
        t.start()
        t.join()


def test_spans_of_exited_threads_survive_the_reuse_of_their_ident():
    """The server starts a writer thread a transaction; each one's spans
    stay after the next thread takes its ident."""
    tr = Tracer()
    tr.enable()
    _one_span_a_thread(tr, 40)
    with tr.span("main"):
        pass
    tr.disable()
    assert sorted(s.args["i"] for s in tr.spans() if s.name == "writer") == list(range(40))
    names = {e["args"]["name"] for e in tr.export_chrome()["traceEvents"] if e["ph"] == "M"}
    assert "datalog-writer" in names


def test_spans_of_exited_threads_are_bounded():
    tr = Tracer(max_spans_per_thread=8)
    tr.enable()
    _one_span_a_thread(tr, 40)
    tr.disable()
    kept = sorted(s.args["i"] for s in tr.spans())
    assert len(kept) <= 9 and kept[-1] == 39


def test_export_stamps_the_unix_epoch_through_the_anchor(tmp_path):
    tr = Tracer()
    wall_before = time.time_ns()
    tr.enable()
    with tr.span("outer", "cat", k="v"):
        with tr.device_span("inner", "cat", device="cpu"):
            pass
    tr.disable()
    wall_after = time.time_ns()
    doc = tr.export_chrome(str(tmp_path / "trace.json"))
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    wall0, perf0 = tr._anchor
    assert wall_before <= wall0 <= wall_after
    for s in tr.spans():
        ev = xs[s.name]
        assert ev["ts"] == (wall0 + s.start_ns - perf0) / 1e3
        assert wall_before / 1e3 <= ev["ts"] <= wall_after / 1e3
        assert ev["args"]["syncs"] == 0 and "device_ms" not in ev["args"]
    assert xs["inner"]["args"]["parent_id"] == xs["outer"]["args"]["span_id"]
    assert xs["outer"]["args"]["k"] == "v"


def test_the_port_only_spans_leave_profile_trees_alone():
    """A span of ``PORT_ONLY_SPANS`` drops out of the ANALYZE tree and its
    children hang from the nearest span kept."""

    class S:
        def __init__(self, span_id, parent_id, name, args=None):
            self.span_id, self.parent_id, self.name = span_id, parent_id, name
            self.args, self.dur_ns = dict(args or {}), 1000

    spans = [S(1, 0, "query", {"profile_rid": 7, "rows": 4}), S(2, 1, "query.wait"),
             S(3, 1, "query.lookup"), S(4, 3, "device.sync"), S(5, 1, "device.sync")]
    prof = build_profile(spans, 7, kind="query")
    (root,) = prof.roots
    assert root.name == "query" and [c.name for c in root.children] == [
        "device.sync", "device.sync"]
    assert prof.rows == 4


def _tc_server():
    edges = random_edges(np.random.default_rng(5), 20, 60)
    inst = MaterializedInstance(TC, {"arc": edges}, config=EngineConfig(), device="cpu")
    return DatalogServer(inst, max_batch=4), edges


def test_query_spans_carry_the_rid_of_their_query():
    srv, edges = _tc_server()
    TRACER.enable()
    try:
        rids = [srv.submit_query("tc", src=int(v)) for v in edges[:3, 0]]
        done = srv.run()
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
        srv.close()
    by_id = {s.span_id: s for s in spans}
    queries = {s.args["rid"]: s for s in spans if s.name == "query"}
    assert sorted(queries) == sorted(rids)
    for name in ("query.wait", "query.lookup"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == len(rids)
        for s in mine:
            q = by_id[s.parent_id]
            assert q.name == "query" and s.args["rid"] == q.args["rid"]
    for s in spans:
        if s.name == "query.lookup":
            assert s.args["rows"] == len(done[s.args["rid"]])
    syncs = [s for s in spans if s.name == "device.sync"]
    assert syncs and all(by_id[s.parent_id].name == "query" for s in syncs)


def test_a_delete_traces_its_recompute_phases():
    """A delete on the resident PBME stratum recomputes it: the arc's two
    membership tests (the rows present, then the table less them), the
    engine's PBME phases, whose matrices stay resident, then one diff, with
    the facts it took away."""
    srv, edges = _tc_server()
    TRACER.enable()
    try:
        rid = srv.submit_txn([("delete", "arc", edges[:6])])
        stats = srv.run()[rid]
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
        srv.close()
    names = [s.name for s in spans if s.name in PORT_ONLY_SPANS]
    assert names == ["membership", "membership", "pbme.build", "pbme.fixpoint",
                     "pbme.to_rows", "recompute.diff"]
    assert all(s.args["path"] == "key" for s in spans if s.name == "membership")
    assert stats.modes == {0: "full"}
    diff = next(s for s in spans if s.name == "recompute.diff")
    assert diff.args == {"pred": "tc", "packed": True, "added": 0,
                         "removed": stats.retracted}
    assert stats.retracted > 0


def test_a_tuple_stratum_recompute_diffs_its_rows():
    """A stratum with no resident words (here the tuple backend's negation,
    recomputed because the relation it negates lost facts) diffs its stored
    tables: its ``recompute.diff`` says ``packed: False``."""
    edges = random_edges(np.random.default_rng(42), 14, 30)
    inst = MaterializedInstance(NEG, {"arc": edges}, config=EngineConfig(backend="tuple"),
                                device="cpu")
    srv = DatalogServer(inst, max_batch=4)
    TRACER.enable()
    try:
        rid = srv.submit_txn([("delete", "arc", edges[-4:])])
        stats = srv.run()[rid]
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
        srv.close()
    (diff,) = [s for s in spans if s.name == "recompute.diff"]
    assert "full" in stats.modes.values()
    assert diff.args["pred"] == "ntc" and diff.args["packed"] is False
    assert diff.args["added"] == stats.derived > 0


NEG = """
tc(x,y) :- arc(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
node(x) :- arc(x,y).
node(y) :- arc(x,y).
ntc(x,y) :- node(x), node(y), !tc(x,y).
"""

SG = """
sg(x,y) :- arc(p,x), arc(p,y), x != y.
sg(x,y) :- arc(a,x), sg(a,b), arc(b,y).
"""


def _traced_evaluation(program):
    from repro_torch.core import Engine
    from repro_torch.data.graphs import gnp_graph

    engine = Engine(EngineConfig(backend="bitmatrix"), device="cpu")
    TRACER.enable()
    try:
        engine.run(program, {"arc": gnp_graph(100, 0.02, seed=3).astype(np.int32)})
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
    return engine, spans


@pytest.mark.parametrize("program,plan", [(SG, "sg"), (TC, "tc")])
def test_the_fixpoint_span_names_its_plan_and_counts_its_products(program, plan):
    """SG: one product for the base and two a round, with the arc's
    transpose and the identity mask spanned inside the fixpoint; TC: one
    fused product a round, and neither span."""
    engine, spans = _traced_evaluation(program)
    (fixpoint,) = [s for s in spans if s.name == "pbme.fixpoint"]
    iterations = engine.stats.total_iterations()
    assert iterations >= 3
    assert fixpoint.args == {"n": engine.domain, "plan": plan, "iterations": iterations,
                             "products": 1 + 2 * iterations if plan == "sg" else iterations}
    inner = {s.name: s for s in spans if s.name in ("pbme.transpose", "pbme.mask")}
    if plan == "sg":
        assert sorted(inner) == ["pbme.mask", "pbme.transpose"]
        for s in inner.values():
            assert s.parent_id == fixpoint.span_id and s.args == {"n": engine.domain}
    else:
        assert inner == {}


def test_an_untraced_sg_evaluation_records_no_span():
    from repro_torch.core import Engine
    from repro_torch.data.graphs import gnp_graph

    TRACER.clear()
    engine = Engine(EngineConfig(backend="bitmatrix"), device="cpu")
    engine.run(SG, {"arc": gnp_graph(100, 0.02, seed=3).astype(np.int32)})
    assert engine.stats.backend_used["sg"] == "bitmatrix"
    assert TRACER.spans() == []
