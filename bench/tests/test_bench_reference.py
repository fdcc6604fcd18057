"""The plain reference against fixpoints worked by hand, and the check
against planted differences."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.harness import check
from bench.harness.spec import reference

closure = reference("linear_closure").fixpoint
TC = {"base": "arc", "step": "arc"}
CSDA = {"base": "nullEdge", "step": "arc"}


def facts(ref) -> set[tuple[int, int]]:
    idx, ys = np.nonzero(ref.bits.numpy())
    return {(int(ref.keys[i]), int(y)) for i, y in zip(idx, ys)}


def test_tc_of_a_chain():
    arc = np.array([[0, 1], [1, 2], [2, 3]], np.int32)
    ref = closure({"arc": arc}, TC, 4, "cpu")
    assert facts(ref) == {(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)}
    assert ref.rounds == 2 and ref.count == 6


def test_tc_of_a_cycle_and_a_tail():
    arc = np.array([[0, 1], [1, 0], [1, 2], [3, 3]], np.int32)
    ref = closure({"arc": arc}, TC, 4, "cpu")
    assert facts(ref) == {(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (3, 3)}
    assert ref.rounds == 1


def test_csda_by_hand():
    """null(x, y): y reachable from a nullEdge target of x."""
    arc = np.array([[1, 2], [2, 3], [5, 6]], np.int32)
    null_edge = np.array([[0, 1], [4, 5], [0, 5]], np.int32)
    ref = closure({"arc": arc, "nullEdge": null_edge}, CSDA, 7, "cpu")
    assert facts(ref) == {(0, 1), (0, 2), (0, 3), (0, 5), (0, 6), (4, 5), (4, 6)}
    assert ref.rounds == 2
    assert ref.row(0).tolist() == [1, 2, 3, 5, 6] and ref.row(3).tolist() == []
    counts, sums = ref.row_digests()
    assert counts.tolist() == [5, 2] and sums.tolist() == [17, 11]


def test_max_rounds_stops_short():
    arc = np.array([[0, 1], [1, 2], [2, 3]], np.int32)
    ref = closure({"arc": arc}, TC, 4, "cpu", max_rounds=1)
    assert (0, 3) not in facts(ref) and (0, 2) in facts(ref)


def test_reference_agrees_with_the_engine_on_the_cpu():
    from repro_torch.core import Engine, EngineConfig

    rng = np.random.default_rng(4)
    arc = np.unique(rng.integers(0, 60, size=(150, 2)), axis=0).astype(np.int32)
    for backend in ("bitmatrix", "tuple"):
        engine = Engine(EngineConfig(backend=backend), device="cpu")
        out = engine.run("tc(x,y) :- arc(x,y).\ntc(x,y) :- tc(x,z), arc(z,y).", {"arc": arc})
        ref = closure({"arc": arc}, TC, 60, "cpu")
        rows = torch.as_tensor(out["tc"])
        assert check.closure_gap(rows, ref) == {
            "missing_facts": 0, "extra_facts": 0, "duplicate_rows": 0}
        assert engine.stats.total_iterations() == check.expected_iterations(
            ref.rounds, engine.stats.backend_used["tc"])


@pytest.mark.parametrize("plant,field", [
    (lambda r: r[1:], "missing_facts"),
    (lambda r: torch.cat([r, torch.tensor([[3, 0]], dtype=r.dtype)]), "extra_facts"),
    (lambda r: torch.cat([r, torch.tensor([[9, 0]], dtype=r.dtype)]), "extra_facts"),
    (lambda r: torch.cat([r, r[:2]]), "duplicate_rows"),
])
def test_check_finds_planted_differences(plant, field):
    arc = np.array([[0, 1], [1, 2], [2, 3]], np.int32)
    ref = closure({"arc": arc}, TC, 4, "cpu")
    rows = torch.tensor(sorted(facts(ref)), dtype=torch.int32)
    assert check.closure_gap(rows, ref) == {
        "missing_facts": 0, "extra_facts": 0, "duplicate_rows": 0}
    assert check.closure_gap(plant(rows), ref)[field] > 0
