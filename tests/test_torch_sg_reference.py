"""Same generation on the port against a plain reference on the CPU.

``plain_same_generation`` is held to the fixpoints worked by hand that the
benchmark's reference is held to (``bench/tests/test_bench_sg.py``); then
``Engine.run`` of the SG program, on the PBME plan and on the tuple path, is
held to it fact for fact on seeded Gn-p graphs, with the engine's iteration
count checked as the benchmark's ``sg-g10k.eval`` cell checks it.
"""

from __future__ import annotations

import numpy as np
import pytest

from bench.harness.check import expected_iterations
from bench.tests.test_bench_sg import BY_HAND
from plain_same_generation import same_generation
from repro_torch.core import Engine, EngineConfig
from repro_torch.data.graphs import gnp_graph

SG = """
sg(x,y) :- arc(p,x), arc(p,y), x != y.
sg(x,y) :- arc(a,x), sg(a,b), arc(b,y).
"""

#: (n, p, seed): each graph has at least 2 productive rounds after the base
GRAPHS = [(64, 0.03, 0), (100, 0.02, 3), (200, 0.01, 1), (300, 0.006, 2), (400, 0.005, 0)]


def _facts(rows: np.ndarray) -> set[tuple[int, int]]:
    return {(int(x), int(y)) for x, y in rows}


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_plain_same_generation_by_hand(name):
    arc, n, want, diagonal, rounds = BY_HAND[name]
    rows, got_rounds = same_generation(np.array(arc), n)
    assert _facts(rows) == want and len(rows) == len(want) and got_rounds == rounds
    assert {x for x, y in rows if x == y} == diagonal
    base, base_rounds = same_generation(np.array(arc), n, max_rounds=0)
    assert base_rounds == 0 and all(x != y for x, y in base)
    short, short_rounds = same_generation(np.array(arc), n, max_rounds=rounds - 1)
    assert short_rounds == rounds - 1 and _facts(short) < want


@pytest.mark.parametrize("backend", ["bitmatrix", "tuple"])
@pytest.mark.parametrize("n,p,seed", GRAPHS)
def test_engine_matches_plain_same_generation(n, p, seed, backend):
    """Fact for fact, diagonal included.  PBME counts its products' rounds,
    the last (empty) one included: rounds + 1.  The tuple path counts the
    base round too: rounds + 2."""
    arc = gnp_graph(n, p, seed=seed).astype(np.int32)
    want, rounds = same_generation(arc, n)
    assert rounds >= 2
    engine = Engine(EngineConfig(backend=backend), device="cpu")
    got = engine.run(SG, {"arc": arc})["sg"]
    assert np.array_equal(got, want)
    assert engine.stats.backend_used["sg"] == backend
    assert engine.stats.total_iterations() == expected_iterations(rounds, backend)
    assert engine.stats.total_iterations() == rounds + (1 if backend == "bitmatrix" else 2)
