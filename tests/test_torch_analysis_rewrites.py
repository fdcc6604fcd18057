"""Rewrite soundness: ``repro_torch.analysis.rewrites`` against
``repro.analysis.rewrites``.

The counterparts of ``test_analysis_rewrites.py``.  Each rewrite runs in
both packages on the same program and must give the same program text and
the same ``DL3xx`` diagnostics; ``verify_rewrite`` runs the port's engine on
the CPU and must find no difference between a program's fixpoint and its
rewrite's.  The PBME protection of the reorder pass is pinned on the served
workloads: TC and SG keep both rules in place, so their strata stay on the
``bitmm`` kernels once every program is admitted through the rewrites.
"""

import random

import numpy as np
import pytest
import torch

import repro.analysis as ref_analysis
from repro.analysis.rewrites import _pbme_protected_rules as ref_protected
from repro.core.parser import parse as ref_parse
from repro_torch.analysis import (
    NO_REWRITES,
    RewriteConfig,
    analyze_program,
    rewrite_program,
    verify_rewrite,
)
from repro_torch.analysis.rewrites import _pbme_protected_rules
from repro_torch.configs.datalog_workloads import ALL as WORKLOADS
from repro_torch.core.parser import parse

CPU = "cpu"


def _codes(diags):
    return sorted({d.code for d in diags})


def both_rewrites(src, **cfg):
    """``rewrite_program`` in both packages: (program, diagnostics), equal."""
    prog, diags = rewrite_program(parse(src), RewriteConfig(**cfg))
    ref_prog, ref_diags = ref_analysis.rewrite_program(
        ref_parse(src), ref_analysis.RewriteConfig(**cfg))
    assert repr(prog) == repr(ref_prog)
    assert [(d.code, d.message, repr(d.span), d.rule_index) for d in diags] == [
        (d.code, d.message, repr(d.span), d.rule_index) for d in ref_diags]
    return prog, diags


# -- unit: independent flags -------------------------------------------------

DUP_DEAD = """
p(x) :- e(x).
p(y) :- e(y).
p(x) :- e(x), 1 == 2.
q(x) :- e(x), x == 3.
"""


def test_flags_independent():
    p, d = both_rewrites(DUP_DEAD, fold_constants=False, dead_rules=False, reorder=False)
    assert _codes(d) == ["DL302"] and len(p.rules) == 3
    p, d = both_rewrites(DUP_DEAD, fold_constants=False, dedup=False, reorder=False)
    assert _codes(d) == ["DL301"] and len(p.rules) == 3
    p, d = both_rewrites(DUP_DEAD, dedup=False, dead_rules=False, reorder=False)
    assert _codes(d) == ["DL303"] and "e(3)" in repr(p.rules[-1])
    p, d = rewrite_program(parse(DUP_DEAD), NO_REWRITES)
    assert d == [] and repr(p) == repr(parse(DUP_DEAD))


def test_reorder_puts_constant_atom_first():
    p, d = both_rewrites("q(x) :- e(x,y), f(y,3).")
    assert _codes(d) == ["DL304"]
    assert p.rules[0].atoms[0].pred == "f"


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_reorder_skips_pbme_shaped_strata(name):
    """No rule of a served workload is reordered, and the TC- and SG-shaped
    strata are protected as the reference protects them."""
    src = WORKLOADS[name].program
    p, d = both_rewrites(src)
    assert d == [] and repr(p) == repr(parse(src))
    protected = _pbme_protected_rules(parse(src))
    assert protected == ref_protected(ref_parse(src))
    if name in ("tc", "sg"):
        assert sorted(protected) == [0, 1]


def test_unsat_rule_kept_when_last_for_its_pred():
    p, d = both_rewrites("p(x) :- e(x), 1 == 2.")
    assert len(p.rules) == 1 and not [x for x in d if x.code == "DL301"]


def test_reachability_elimination_needs_outputs():
    src = "p(x) :- e(x). q(x) :- f(x)."
    p, _ = both_rewrites(src)
    assert len(p.rules) == 2
    p, d = both_rewrites(src, outputs=("p",))
    assert [r.head_pred for r in p.rules] == ["p"] and _codes(d) == ["DL301"]


def test_pipeline_idempotent():
    for src in (
        DUP_DEAD,
        "q(x) :- e(x,y), f(y,3).",
        "tc(x,y) :- e(x,y). tc(x,y) :- tc(x,z), e(z,y).",
        "s(y) :- e(x,y), x == 2, f(y,z).",
    ):
        once, _ = both_rewrites(src)
        twice, d = rewrite_program(once, RewriteConfig())
        assert repr(twice) == repr(once) and d == [], src


# -- CSDA-family acceptance case --------------------------------------------

CSDA_NOISY = """
null(x,y) :- nullEdge(x,y).
null(x,y) :- null(x,w), arc(w,y).
null(a,b) :- nullEdge(a,b).
null(x,y) :- nullEdge(x,y), 0 == 1.
null(x,y) :- null(x,w), arc(w,y), nullEdge(x,y).
"""


def test_csda_dead_dup_subsumed_eliminated_bit_for_bit(rng):
    report = analyze_program(CSDA_NOISY)
    ref = ref_analysis.analyze_program(CSDA_NOISY)
    assert report.to_json() == ref.to_json()
    assert {d.code for d in report.warnings} >= {"DL104", "DL105", "DL106"}
    assert len(report.rewritten.rules) == 3
    arc = rng.integers(0, 40, size=(120, 2)).astype(np.int32)
    nul = rng.integers(0, 40, size=(15, 2)).astype(np.int32)
    edb = {"arc": arc, "nullEdge": nul}
    assert verify_rewrite(report.program, report.rewritten, edb, device=CPU) == []


def test_verify_rewrite_runs_on_the_card_by_default():
    """``verify_rewrite`` runs the port's engine, on CUDA unless given
    ``device="cpu"``; a broken rewrite is reported as the reference reports
    it."""
    prog = parse("p(x,y) :- e(x,y).")
    wrong = parse("p(x,y) :- e(y,x).")
    edb = {"e": np.array([[0, 1], [2, 2]], np.int32)}
    got = verify_rewrite(prog, wrong, edb, device=CPU)
    want = ref_analysis.verify_rewrite(ref_parse("p(x,y) :- e(x,y)."),
                                       ref_parse("p(x,y) :- e(y,x)."), edb)
    assert got == want == ["p: 2 rows before vs 2 after (symmetric difference 2)"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            verify_rewrite(prog, prog, edb)


# -- random safe programs, random EDBs ----------------------------------------


def _random_program(rnd: random.Random) -> str:
    """A random safe positive program over EDB preds e/2 and f/2, with the
    duplicate, dead, constant-selection and cross-product noise the rewrites
    fire on (the generator of ``test_analysis_rewrites.py``)."""
    vars_ = ["x", "y", "z", "w"]
    rules = []

    def atom(pred, bound):
        a, b = rnd.choice(vars_), rnd.choice(vars_)
        bound.update((a, b))
        return f"{pred}({a},{b})"

    for head, preds in (("p", ["e", "f"]), ("q", ["e", "f", "p"])):
        for _ in range(rnd.randint(1, 3)):
            bound: set = set()
            body = [atom(rnd.choice(preds), bound) for _ in range(rnd.randint(1, 3))]
            bvars = sorted(bound)
            if rnd.random() < 0.5:
                body.append(f"{rnd.choice(bvars)} == {rnd.randint(0, 5)}")
            if rnd.random() < 0.3:
                body.append(f"{rnd.choice(bvars)} != {rnd.choice(bvars)}")
            h = (rnd.choice(bvars), rnd.choice(bvars))
            rules.append(f"{head}({h[0]},{h[1]}) :- {', '.join(body)}.")
    if rnd.random() < 0.5:
        rules.append(rules[rnd.randrange(len(rules))])
    if rnd.random() < 0.5:
        r = rules[rnd.randrange(len(rules))]
        rules.append(r[:-1] + ", 1 == 2.")
    return "\n".join(rules)


@pytest.mark.parametrize("seed", range(6))
def test_rewrite_soundness_property(seed):
    rnd = random.Random(seed)
    src = _random_program(rnd)
    report = analyze_program(src)
    ref = ref_analysis.analyze_program(src)
    assert report.ok and report.to_json() == ref.to_json(), src
    npr = np.random.default_rng(seed)
    edb = {
        "e": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
        "f": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
    }
    assert verify_rewrite(report.program, report.rewritten, edb, device=CPU) == [], src
