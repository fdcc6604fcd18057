"""Front-end parity: the port's parser and analyzer against the reference's.

Exact equality throughout: program ``repr``s, strata (order, predicates,
rules and flags) and the text of every ``ValueError``.
"""

from pathlib import Path

import numpy as np
import pytest

from repro.configs.datalog_workloads import ALL
from repro.core import analyze as ref_analyze
from repro.core import parse as ref_parse
from repro_torch.core import analyze, parse

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples" / "datalog").glob("*.dl"))

EXTRA = {
    "negation": """
        tc(x,y) :- arc(x,y).
        tc(x,y) :- tc(x,z), arc(z,y).
        node(x) :- arc(x,y).
        ntc(x,y) :- node(x), node(y), !tc(x,y).
    """,
    "mutual": """
        vf(x,y) :- assign(x,y).
        vf(x,y) :- vf(x,z), vf(z,y).
        ma(x,y) :- vf(x,z), vf(z,y).
        vf(x,y) :- assign(x,z), ma(z,y).
    """,
    "constants": "r(x, 5) :- e(x, _), x > 2. s(x) :- r(x, y), y != 3.",
    "aggregates": "c(x, COUNT(y)) :- e(x, y). t(SUM(y)) :- e(_, y).",
}

PROGRAMS = (
    [pytest.param(p.read_text(), id=p.stem) for p in EXAMPLES]
    + [pytest.param(w.program, id=f"workload-{n}") for n, w in ALL.items()]
    + [pytest.param(t, id=n) for n, t in EXTRA.items()]
)


def _strata(s):
    return [
        (st.index, st.preds, [repr(r) for r in st.rules], st.recursive, st.nonlinear,
         st.mutual, st.has_recursive_agg)
        for st in s.strata
    ], s.idb, s.edb


def test_examples_found():
    assert len(EXAMPLES) == 8


@pytest.mark.parametrize("text", PROGRAMS)
def test_parse_and_analyze_match(text):
    ref, port = ref_parse(text), parse(text)
    assert repr(ref) == repr(port)
    assert [repr(r.span) for r in ref.rules] == [repr(r.span) for r in port.rules]
    assert _strata(ref_analyze(ref)) == _strata(analyze(port))


def _random_program(rng, n_preds: int) -> str:
    rules = []
    for i in range(n_preds):
        rules.append(f"p{i}(x,y) :- e(x,y).")
        for _ in range(rng.integers(0, 3)):
            j, k = rng.integers(0, n_preds, size=2)
            rules.append(f"p{i}(x,y) :- p{j}(x,z), p{k}(z,y).")
        if rng.random() < 0.3:
            j = rng.integers(0, n_preds)
            rules.append(f"p{i}(x,y) :- e(x,y), !p{j}(x,y).")
    order = rng.permutation(len(rules))
    return "\n".join(rules[o] for o in order)


@pytest.mark.parametrize("seed", range(4))
def test_random_programs_stratify_alike(seed):
    """Random dependency graphs (cycles, chains, negation): the same strata in
    the same order, or the same unstratifiable-negation message."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        text = _random_program(rng, int(rng.integers(2, 8)))
        try:
            expect = _strata(ref_analyze(ref_parse(text)))
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                analyze(parse(text))
            assert str(got.value) == str(err)
            continue
        assert _strata(analyze(parse(text))) == expect


@pytest.mark.parametrize(
    "text, stage",
    [
        ("r(x, y) :- e(x).", "parse"),
        ("r(_) :- e(x).", "parse"),
        ("r(x) :- e(x), !f(x, y).", "parse"),
        ("r(x) :- e(x), y > 2.", "parse"),
        ("r(x) :- e(x, y). r(x, y) :- e(x, y).", "parse"),
        ("p(x) :- e(x), !q(x). q(x) :- e(x), !p(x).", "analyze"),
        ("p(x) :- e(x), !q(x). q(x) :- r(x). r(x) :- p(x).", "analyze"),
        ("c(x, SUM(y)) :- c(x, y), e(x, y).", "analyze"),
    ],
)
def test_errors_match(text, stage):
    def run(parse_fn, analyze_fn):
        with pytest.raises(ValueError) as info:
            prog = parse_fn(text)
            if stage == "analyze":
                analyze_fn(prog)
        return str(info.value)

    assert run(parse, analyze) == run(ref_parse, ref_analyze)
