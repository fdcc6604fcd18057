"""Connected components (CC) on the port against a plain reference on the CPU.

``plain_min_label`` is held to the graph worked by hand that the benchmark's
reference is held to (``bench/tests/test_bench_cc.py``); then ``Engine.run`` of
RecStep's CC program is held to it on RMAT graphs under the relabellings the
benchmark's ``cc-rmat1m.eval`` cell draws: ``cc2`` row for row, ``cc`` as its
distinct labels, the iteration count as the cell checks it, and the traced
spans' counters round by round.
"""

from __future__ import annotations

import numpy as np
import pytest

from bench.tests.test_bench_cc import (
    BY_HAND_ARC, BY_HAND_CANDIDATES, BY_HAND_LABELS, BY_HAND_ROUNDS,
)
from plain_min_label import min_label
from repro_torch.configs.datalog_workloads import CC
from repro_torch.core import Engine, EngineConfig
from repro_torch.data.graphs import rmat_graph
from repro_torch.obs.trace import PORT_ONLY_SPANS, TRACER

SEEDS = [3300000101, 3300000102, 2**31 + 7]


def relabelled(n_log2: int, seed: int, domain_log2: int | None = None) -> np.ndarray:
    """``rmat_graph(n_log2)`` relabelled as the benchmark relabels a run's
    graph (``default_rng([seed, 0]).permutation``), into ``2**domain_log2``
    ids where that is given."""
    arc = rmat_graph(n_log2).astype(np.int32)
    perm = np.random.default_rng([seed, 0]).permutation(1 << (domain_log2 or n_log2))
    return perm[arc].astype(np.int32)


def traced_run(arc: np.ndarray):
    engine = Engine(EngineConfig(), device="cpu")
    TRACER.enable()
    try:
        out = engine.run(CC.program, {"arc": arc})
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
    return engine, out, spans


def test_plain_min_label_by_hand():
    rows, rounds, candidates = min_label(np.array(BY_HAND_ARC), 8)
    assert rows.tolist() == [list(p) for p in BY_HAND_LABELS]
    assert rounds == BY_HAND_ROUNDS and candidates == BY_HAND_CANDIDATES
    short, short_rounds, _ = min_label(np.array(BY_HAND_ARC), 8, max_rounds=1)
    assert short_rounds == 1 and dict(map(tuple, short.tolist()))[6] == 4
    repeated, _, again = min_label(np.array(BY_HAND_ARC * 2), 8)
    assert np.array_equal(repeated, rows) and again == candidates


def test_engine_matches_plain_min_label_by_hand():
    engine, out, spans = traced_run(np.array(BY_HAND_ARC, np.int32))
    assert out["cc2"].tolist() == [list(p) for p in BY_HAND_LABELS]
    assert out["cc"].tolist() == [[2], [3], [5], [7]]
    assert engine.stats.total_iterations() == BY_HAND_ROUNDS + 4
    props = sorted((s for s in spans if s.name == "agg.propagate"),
                   key=lambda s: s.args["iteration"])
    assert [s.args["candidates"] for s in props] == BY_HAND_CANDIDATES
    assert [s.args["improved"] for s in props] == [6, 3, 1, 0]


def test_the_new_spans_are_the_ports_own():
    assert {"agg.propagate", "agg.groupby", "join", "membership"} <= PORT_ONLY_SPANS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_log2", [10, 12])
def test_engine_matches_plain_min_label(n_log2, seed):
    """``cc2`` and ``cc`` row for row, the backends, the iteration count
    (cc3's base, rounds and empty round, then cc2 and cc), and the spans:
    one ``agg.propagate`` a round whose ``candidates`` are the reference's,
    one ``join`` a round after the base whose probe rows are the keys that
    fell the round before and whose rows add up to the same candidates, one
    ``agg.groupby`` for cc2, and cc2's membership test on the compact key."""
    arc = relabelled(n_log2, seed)
    n = 1 << n_log2
    want, rounds, candidates = min_label(arc, n)
    engine, out, spans = traced_run(arc)
    assert np.array_equal(out["cc2"], want)
    assert np.array_equal(out["cc"][:, 0], np.unique(want[:, 1]))
    assert engine.stats.backend_used == {"cc3": "dense_agg", "cc2": "tuple", "cc": "tuple"}
    assert engine.stats.total_iterations() == rounds + 4 and rounds >= 3

    props = sorted((s for s in spans if s.name == "agg.propagate"),
                   key=lambda s: s.args["iteration"])
    assert [s.args["candidates"] for s in props] == candidates
    assert all(s.args["pred"] == "cc3" and s.args["domain"] == engine.domain for s in props)
    assert props[-1].args["improved"] == 0 and all(s.args["improved"] > 0 for s in props[:-1])
    joins = [s for s in spans if s.name == "join"]
    assert sum(s.args["rows"] for s in joins) == sum(candidates[1:])
    assert [s.args["rows_in"] for s in joins] == [s.args["improved"] for s in props[:-1]]
    by_id = {s.span_id: s for s in spans}
    assert all(by_id[s.parent_id].name == "agg.propagate" for s in joins)
    (groupby,) = [s for s in spans if s.name == "agg.groupby"]
    assert groupby.args["groups"] == len(want) <= groupby.args["rows_in"]
    assert _membership_paths(spans, by_id, "cc2") == ["key"]
    assert all(s.device_ns is None and s.syncs == 0 for s in props + joins + [groupby])


def _membership_paths(spans, by_id, pred):
    """The ``path`` of each membership test made inside ``pred``'s rule."""
    paths = []
    for s in spans:
        if s.name != "membership":
            continue
        up = by_id.get(s.parent_id)
        while up is not None and up.name != "rule":
            up = by_id.get(up.parent_id)
        if up is not None and up.args["pred"] == pred:
            paths.append(s.args["path"])
    return paths


@pytest.mark.parametrize("seed", SEEDS[:1])
def test_cc2_takes_the_scan_on_a_wide_domain(seed):
    """An RMAT graph's nodes spread over 2^16 ids: cc2's pairs have no 31-bit
    compact key, so its set difference takes the lexsort-and-``cummax`` scan,
    and the result is still the reference's."""
    arc = relabelled(10, seed, domain_log2=16)
    want, rounds, candidates = min_label(arc, 1 << 16)
    engine, out, spans = traced_run(arc)
    assert engine.domain ** 2 >= 2**31
    assert np.array_equal(out["cc2"], want)
    assert engine.stats.total_iterations() == rounds + 4
    by_id = {s.span_id: s for s in spans}
    assert _membership_paths(spans, by_id, "cc2") == ["scan"]
    (scan,) = [s for s in spans if s.name == "membership" and s.args["path"] == "scan"]
    assert scan.args["rows"] >= len(want)
    assert [s.args["candidates"] for s in sorted(
        (s for s in spans if s.name == "agg.propagate"),
        key=lambda s: s.args["iteration"])] == candidates
