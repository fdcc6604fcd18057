"""Andersen's points-to analysis on the port against a plain reference on the
CPU.

``plain_points_to`` is held to a case worked by hand that fires every rule;
then ``Engine.run`` of RecStep's program is held to it on the synthetic
program-fact datasets 1 and 2 under three relabellings of the variables:
``pointsTo`` row for row, the tuple path, the iteration count, and the tuple
path's spans round by round: each ``uie.dedup``'s derivations and each
``dsd``'s new facts.
"""

from __future__ import annotations

import numpy as np
import pytest

from plain_points_to import (
    BY_HAND_DERIVATIONS, BY_HAND_EDB, BY_HAND_FACTS, BY_HAND_NEW, BY_HAND_ROUNDS,
    derivations, new_facts, points_to,
)
from repro_torch.configs.datalog_workloads import ANDERSEN
from repro_torch.core import Engine, EngineConfig
from repro_torch.data.program_facts import andersen_facts
from repro_torch.obs.trace import PORT_ONLY_SPANS, TRACER

SEEDS = [3600000101, 3600000102, 2**31 + 11]
ROUND_SPANS = ("uie.dedup", "dsd", "idb.merge")


def relabelled(scale: int, seed: int) -> tuple[dict[str, np.ndarray], int]:
    """``andersen_facts(scale)`` relabelled and shuffled by ``seed``
    (``default_rng([seed, 0])``: a permutation of the variables, then one of
    each relation's rows)."""
    edb, n = andersen_facts(scale)
    rng = np.random.default_rng([seed, 0])
    perm = rng.permutation(n).astype(np.int32)
    return {rel: perm[rows][rng.permutation(len(rows))] for rel, rows in edb.items()}, n


def traced_run(edb: dict[str, np.ndarray]):
    engine = Engine(EngineConfig(), device="cpu")
    TRACER.enable()
    try:
        out = engine.run(ANDERSEN.program, edb)
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.clear()
    return engine, out, spans


def _by_iteration(spans, name, arg):
    """``{iteration: args[arg]}`` of the spans called ``name``, each span's
    iteration read off the ``uie.dedup`` of its round."""
    out, iteration = {}, None
    for s in spans:
        if s.name == "uie.dedup":
            iteration = s.args["iteration"]
        if s.name == name:
            out[iteration] = s.args[arg]
    return out


def _check_round_spans(spans, derived, added):
    """One ``uie.dedup``, ``dsd`` and ``idb.merge`` for each round that
    derived a row, in that order under the round's ``rule`` span, with the
    reference's derivations and new facts."""
    by_id = {s.span_id: s for s in spans}
    mine = [s for s in spans if s.name in ROUND_SPANS]
    rounds = [i for i, d in enumerate(derived) if d]
    assert [s.name for s in mine] == list(ROUND_SPANS) * len(rounds)
    assert all(by_id[s.parent_id].name == "rule" for s in mine)
    assert _by_iteration(spans, "uie.dedup", "candidates") == {i: derived[i] for i in rounds}
    assert _by_iteration(spans, "dsd", "delta") == {i: added[i] for i in rounds}
    for s in mine:
        assert s.device_ns is None and s.syncs == 0
    for s in (s for s in mine if s.name == "uie.dedup"):
        assert s.args["pred"] == "pointsTo"
        assert s.args["deduped"] <= s.args["candidates"] <= s.args["capacity"]
        assert s.args["capacity"] & (s.args["capacity"] - 1) == 0


def test_plain_points_to_by_hand():
    edb = {k: np.array(v, np.int32) for k, v in BY_HAND_EDB.items()}
    pairs, rounds = points_to(edb, 5)
    assert [tuple(p) for p in pairs.tolist()] == BY_HAND_FACTS and rounds == BY_HAND_ROUNDS
    assert derivations(edb, 5) == BY_HAND_DERIVATIONS and new_facts(edb, 5) == BY_HAND_NEW
    short, short_rounds = points_to(edb, 5, max_rounds=1)
    assert short_rounds == 1 and (4, 1) not in set(map(tuple, short.tolist()))
    repeated = {k: np.concatenate([v, v]) for k, v in edb.items()}
    assert np.array_equal(points_to(repeated, 5)[0], pairs)


def test_engine_matches_plain_points_to_by_hand():
    edb = {k: np.array(v, np.int32) for k, v in BY_HAND_EDB.items()}
    engine, out, spans = traced_run(edb)
    assert [tuple(p) for p in out["pointsTo"].tolist()] == BY_HAND_FACTS
    assert engine.stats.backend_used == {"pointsTo": "tuple"}
    assert engine.stats.total_iterations() == BY_HAND_ROUNDS + 2
    _check_round_spans(spans, BY_HAND_DERIVATIONS, BY_HAND_NEW)


def test_the_new_spans_are_the_ports_own():
    assert set(ROUND_SPANS) <= PORT_ONLY_SPANS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", [1, 2])
def test_engine_matches_plain_points_to(scale, seed):
    """``pointsTo`` row for row, the tuple path, the iteration count (the
    base, the productive rounds and the empty one) and the spans of every
    round."""
    edb, n = relabelled(scale, seed)
    want, rounds = points_to(edb, n)
    engine, out, spans = traced_run(edb)
    assert np.array_equal(out["pointsTo"], want)
    assert engine.stats.backend_used == {"pointsTo": "tuple"}
    assert engine.stats.total_iterations() == rounds + 2 and rounds >= 5
    derived = derivations(edb, n)
    assert all(derived) and len(derived) == rounds + 2
    _check_round_spans(spans, derived, new_facts(edb, n))
