"""Demand transformation: ``repro_torch.analysis.demand`` and on-demand
serving against the reference.

The counterparts of ``test_demand.py``.  Every transform is computed by both
packages and must be equal: the specialized program's text and fingerprint,
the seed, magic and answer names, the adorned and magic rules, the
predicates computed in full, every ``DL4xx`` diagnostic and the fallback.
The demanded slices run on the port's engine on the CPU and must equal the
selection over the full fixpoint.  The same ``on_demand=True`` request
script goes through the reference's ``DatalogServer`` and the port's: every
answer is equal bit for bit, and so are the ``datalog_demand_*`` counts,
stale-epoch respecialization included.
"""

import json
import random

import numpy as np
import pytest

import repro.analysis as ref_analysis
from repro.analysis.__main__ import run as ref_cli
from repro.core.engine import Engine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.core.parser import parse as ref_parse
from repro.serve_datalog import DatalogServer as RefServer
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro.serve_datalog import ServerLimits as RefLimits
from repro_torch.analysis import (
    AnalysisConfig,
    DemandConfig,
    analyze_program,
    demand_diagnostics,
    demand_transform,
    rewrite_program,
    verify_rewrite,
)
from repro_torch.analysis.__main__ import run as cli
from repro_torch.analysis.demand import magic_name, seed_name
from repro_torch.analysis.rewrites import RewriteConfig
from repro_torch.core.ast import Span
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.parser import parse
from repro_torch.serve_datalog import (
    DatalogServer,
    MaterializedInstance,
    PlanCache,
    RequestError,
    ServerLimits,
)
from repro_torch.serve_datalog.plan_cache import fingerprint

CPU = "cpu"
CFG = dict(backend="tuple")

TC = """
tc(x, y) :- arc(x, y).
tc(x, y) :- tc(x, z), arc(z, y).
"""

SG = """
sg(x, y) :- arc(p, x), arc(p, y), x != y.
sg(x, y) :- arc(a, x), sg(a, b), arc(b, y).
"""

CSDA = """
null(x, y) :- nullEdge(x, y).
null(x, y) :- null(x, w), arc(w, y).
"""

RIGHT_TC = """
tc(x, y) :- arc(x, y).
tc(x, y) :- arc(x, z), tc(z, y).
"""

NO_PROFIT = dict(profitability=False)


def _codes(diags):
    return sorted({d.code for d in diags})


def both_transforms(src, pred, pattern, config=None, **kw):
    """``demand_transform`` in both packages; assert they are equal."""
    config = config or {}
    t = demand_transform(parse(src), pred, pattern, DemandConfig(**config), **kw)
    ref = ref_analysis.demand_transform(
        ref_parse(src), pred, pattern, ref_analysis.DemandConfig(**config), **kw)
    assert t.to_dict() == ref.to_dict()
    assert t.render() == ref.render()
    assert repr(t.program) == repr(ref.program)
    assert fingerprint(t.program) == fingerprint(repr(ref.program))
    assert (t.seed_rel, t.answer_rel, t.bound_cols, t.full_preds, t.ok) == (
        ref.seed_rel, ref.answer_rel, ref.bound_cols, ref.full_preds, ref.ok)
    assert [repr(d.span) for d in t.diagnostics] == [repr(d.span) for d in ref.diagnostics]
    return t


# -- adornment + magic structure ---------------------------------------------


def test_tc_bf_structure():
    t = both_transforms(TC, "tc", "bf", NO_PROFIT)
    assert t.ok and t.seed_rel == "__s_bf__tc" and t.answer_rel == "tc__bf"
    assert t.bound_cols == (0,) and t.magic_rules == [] and len(t.adorned) == 2
    assert {r.guarded.atoms[0].pred for r in t.adorned} == {"__m_bf__tc"}
    assert repr(t.adorned[1].guarded) == (
        "tc__bf(x, y) :- __m_bf__tc(x), tc__bf(x, z), arc(z, y).")
    assert any(d.code == "DL400" for d in t.diagnostics)


def test_sg_bf_has_recursive_magic_rule():
    t = both_transforms(SG, "sg", "bf", NO_PROFIT)
    assert [repr(r) for r in t.magic_rules] == [
        "__m_bf__sg(a) :- __m_bf__sg(x), arc(a, x)."]


def test_sip_strategies_differ():
    src = "p(x) :- e(y, z), f(z, x).\ne(a,b) :- q(a,b).\n"
    lr = both_transforms(src, "p", "b", dict(NO_PROFIT, sip="left-to-right"))
    bf = both_transforms(src, "p", "b", dict(NO_PROFIT, sip="bound-first"))
    assert "e" in lr.full_preds and lr.magic_rules == []
    assert any(d.code == "DL408" for d in lr.diagnostics)
    assert [repr(r) for r in bf.magic_rules] == ["__m_fb__e(z) :- __m_b__p(x), f(z, x)."]
    for sip in ("left-to-right", "bound-first"):
        for profit in (True, False):
            port = DemandConfig(sip=sip, profitability=profit)
            ref = ref_analysis.DemandConfig(sip=sip, profitability=profit)
            assert repr(port) == repr(ref) and port.fingerprint() == ref.fingerprint()
    assert (DemandConfig(sip="left-to-right").fingerprint()
            != DemandConfig(sip="bound-first").fingerprint())
    with pytest.raises(ValueError, match="unknown SIP strategy"):
        DemandConfig(sip="right-to-left")


def test_name_helpers_round_trip_through_parser():
    prog = parse(f"{magic_name('p', 'bf')}(x) :- {seed_name('p', 'bf')}(x).")
    assert prog.rules[0].head_pred == "__m_bf__p"
    assert (magic_name("p", "bf"), seed_name("p", "bf")) == (
        ref_analysis.demand.magic_name("p", "bf"), ref_analysis.demand.seed_name("p", "bf"))


# -- fallbacks: coded decisions, never errors --------------------------------


def test_all_free_pattern_falls_back_dl407():
    t = both_transforms(TC, "tc", "ff", NO_PROFIT)
    assert not t.ok and t.fallback.code == "DL407"
    assert repr(t.program) == repr(parse(TC))


def test_aggregate_query_pred_falls_back_dl407():
    t = both_transforms("best(x, MIN(y)) :- e(x, y).", "best", "bf", NO_PROFIT)
    assert not t.ok and t.fallback.code == "DL407"
    assert any(d.code in ("DL401", "DL403") for d in t.diagnostics)


def test_negation_drops_binding_dl402():
    src = "p(x) :- e(x, y).\nq(x) :- e(x, x), !p(x).\n"
    t = both_transforms(src, "q", "b", NO_PROFIT)
    assert t.ok and "p" in t.full_preds
    assert any(d.code == "DL402" for d in t.diagnostics)


def test_unprofitable_falls_back_dl406():
    t = both_transforms(RIGHT_TC, "tc", "bb", sizes={"arc": 3000.0}, domain=1024)
    assert not t.ok and t.fallback.code == "DL406"
    assert both_transforms(RIGHT_TC, "tc", "bb", NO_PROFIT).ok
    assert both_transforms(TC, "tc", "bf", dict(profitability_margin=0.01),
                           sizes={"arc": 400.0}, domain=200).ok
    assert both_transforms(RIGHT_TC, "tc", "bb").ok


def test_name_clash_falls_back_dl405():
    t = both_transforms(TC + "tc__bf(x, y) :- arc(x, y).\n", "tc", "bf", NO_PROFIT)
    assert not t.ok and t.fallback.code == "DL405"


@pytest.mark.parametrize("pred, pattern", [("nosuch", "bf"), ("tc", "bq"), ("tc", "b")])
def test_usage_errors_raise_value_error(pred, pattern):
    with pytest.raises(ValueError) as got:
        demand_transform(parse(TC), pred, pattern)
    with pytest.raises(ValueError) as want:
        ref_analysis.demand_transform(ref_parse(TC), pred, pattern)
    assert str(got.value) == str(want.value)


# -- bit-for-bit verification on the paper suites ----------------------------


@pytest.mark.parametrize(
    "src, pred, pattern, edb_gen",
    [
        (TC, "tc", "bf", lambda r: {"arc": r.integers(0, 30, (80, 2))}),
        (TC, "tc", "bb", lambda r: {"arc": r.integers(0, 30, (80, 2))}),
        (SG, "sg", "bf", lambda r: {"arc": r.integers(0, 20, (50, 2))}),
        (
            CSDA, "null", "bf",
            lambda r: {
                "nullEdge": r.integers(0, 25, (12, 2)),
                "arc": r.integers(0, 25, (70, 2)),
            },
        ),
    ],
    ids=["tc-bf", "tc-bb", "sg-bf", "csda-bf"],
)
def test_demanded_slice_matches_selection(rng, src, pred, pattern, edb_gen):
    t = both_transforms(src, pred, pattern, NO_PROFIT)
    edb = {k: v.astype(np.int32) for k, v in edb_gen(rng).items()}
    n_bound = len(t.bound_cols)
    seeds = [tuple(s) for s in rng.integers(0, 30, (6, n_bound))] + [(0,) * n_bound]
    problems = verify_rewrite(parse(src), t.program, edb, EngineConfig(**CFG),
                              demand=t, seeds=seeds, device=CPU)
    assert problems == [], problems


# -- serving integration ------------------------------------------------------

DEMAND_METRICS = ("datalog_demand_hits_total", "datalog_demand_misses_total",
                  "datalog_demand_fallbacks_total", "datalog_demand_instances")


class DemandPair:
    """The reference's server and the port's (on the CPU), fed the same
    requests; every reply and every demand counter must be equal."""

    def __init__(self, prog, edb, limits=None):
        self.ref_inst = RefInstance(prog, edb, RefConfig(**CFG), cache=RefCache())
        self.inst = MaterializedInstance(prog, edb, EngineConfig(**CFG), cache=PlanCache(),
                                         device=CPU)
        self.ref = RefServer(self.ref_inst, limits=RefLimits(**limits) if limits else None)
        self.srv = DatalogServer(self.inst, limits=ServerLimits(**limits) if limits else None)

    def query(self, rel, **kw):
        rid, ref_rid = self.srv.submit_query(rel, **kw), self.ref.submit_query(rel, **kw)
        got, want = self.srv.run()[rid], self.ref.run()[ref_rid]
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return got

    def txn(self, ops):
        self.srv.submit_txn(ops)
        self.ref.submit_txn(ops)
        self.srv.run()
        self.ref.run()
        assert self.inst.epoch == self.ref_inst.epoch

    def metrics(self):
        m, ref_m = self.srv.metrics(), self.ref.metrics()
        for key in DEMAND_METRICS:
            assert m[key] == ref_m[key], key
        assert (m["datalog_demand_specialize_seconds"]["count"]
                == ref_m["datalog_demand_specialize_seconds"]["count"])
        return m

    def full(self, rel, bounds):
        rows = self.inst.relation(rel)
        keep = np.ones(len(rows), bool)
        for col, v in bounds.items():
            keep &= rows[:, col] == v
        return rows[keep]


def _tc_pair(rng, limits=None):
    edges = rng.integers(0, 60, size=(150, 2)).astype(np.int32)
    return DemandPair(TC, {"arc": edges}, limits)


def test_on_demand_point_queries_exact(rng):
    pair = _tc_pair(rng)
    for src in (3, 7, 3, 10**6, 11):
        got = pair.query("tc", src=src, on_demand=True)
        np.testing.assert_array_equal(got, pair.full("tc", {0: src}))
    m = pair.metrics()
    assert (m["datalog_demand_misses_total"], m["datalog_demand_fallbacks_total"]) == (1, 0)
    assert m["datalog_demand_hits_total"] >= 3 and m["datalog_demand_instances"] == 1
    assert m["datalog_demand_specialize_seconds"]["count"] == 1


def test_on_demand_fallback_is_counted_not_an_error(rng):
    pair = _tc_pair(rng)
    pair.query("tc", src=(0, 5), on_demand=True)
    pair.query("arc", src=3, on_demand=True)
    assert pair.metrics()["datalog_demand_fallbacks_total"] == 2


def test_on_demand_aggregate_program_falls_back(rng):
    edb = {"e": rng.integers(0, 20, size=(40, 2)).astype(np.int32)}
    pair = DemandPair("best(x, MIN(y)) :- e(x, y).", edb)
    src = int(pair.inst.relation("best")[0, 0])
    pair.query("best", src=src, on_demand=True)
    pair.query("best", src=src, on_demand=True)
    assert pair.metrics()["datalog_demand_fallbacks_total"] == 2


def test_on_demand_lru_bounded_and_staleness(rng):
    pair = _tc_pair(rng, limits=dict(demand_instances=1))
    pair.query("tc", src=3, on_demand=True)
    pair.query("tc", where={0: 3, 1: 5}, on_demand=True)
    assert pair.metrics()["datalog_demand_instances"] == 1
    misses = pair.metrics()["datalog_demand_misses_total"]
    pair.txn([("insert", "arc", np.array([[3, 59]], np.int32))])
    got = pair.query("tc", src=3, on_demand=True)
    np.testing.assert_array_equal(got, pair.full("tc", {0: 3}))
    assert pair.metrics()["datalog_demand_misses_total"] == misses + 1
    # the respecialized slice serves the next binding from its own Δ path
    pair.query("tc", src=59, on_demand=True)
    pair.txn([("delete", "arc", np.array([[3, 59]], np.int32))])
    got = pair.query("tc", src=3, on_demand=True)
    np.testing.assert_array_equal(got, pair.full("tc", {0: 3}))
    assert pair.metrics()["datalog_demand_misses_total"] == misses + 2


def test_specialized_instance_on_the_base_device(rng):
    """A specialized instance runs on its base's device with its own writer,
    and ``seed_demand`` extends the slice by one published epoch."""
    pair = _tc_pair(rng)
    plan, t = pair.inst.cache.get_demand(pair.inst.plan.program, "tc", "bf")
    assert plan.fingerprint == fingerprint(t.program)
    dinst = MaterializedInstance.specialize(pair.inst, t, (3,))
    assert dinst.device == pair.inst.device and dinst.demand is t
    assert dinst.plan.report is None                   # admitted as is
    assert dinst.seed_demand((3,)) is False
    e0 = dinst.epoch
    assert dinst.seed_demand((7,)) is True and dinst.epoch == e0 + 1
    np.testing.assert_array_equal(dinst.demand_query({0: 7}), pair.full("tc", {0: 7}))
    assert dinst.demand_query({0: 10**6}).shape == (0, 2)
    with pytest.raises(RuntimeError, match="not a demand-specialized instance"):
        pair.inst.demand_query({0: 3})


def test_plan_cache_keys_demand_plans_separately():
    cache, ref_cache = PlanCache(), RefCache()
    prog, ref_prog = parse(TC), ref_parse(TC)
    cfg, ref_cfg = DemandConfig(**NO_PROFIT), ref_analysis.DemandConfig(**NO_PROFIT)
    p1, t1 = cache.get_demand(prog, "tc", "bf", demand_config=cfg)
    p2, t2 = cache.get_demand(prog, "tc", "bb", demand_config=cfg)
    p3, t3 = cache.get_demand(prog, "tc", "bf", demand_config=cfg)
    r1, _ = ref_cache.get_demand(ref_prog, "tc", "bf", demand_config=ref_cfg)
    r2, _ = ref_cache.get_demand(ref_prog, "tc", "bb", demand_config=ref_cfg)
    ref_cache.get_demand(ref_prog, "tc", "bf", demand_config=ref_cfg)
    assert (p1.fingerprint, p2.fingerprint) == (r1.fingerprint, r2.fingerprint)
    assert p1.fingerprint != p2.fingerprint
    assert p3 is p1 and t3 is t1
    assert cache.stats()["demand_plans"] == 2
    assert cache.stats() == ref_cache.stats()


def test_server_explain_adorn(rng):
    pair = _tc_pair(rng)
    text = pair.srv.explain(adorn="tc^bf", text=True)
    assert text == pair.ref.explain(adorn="tc^bf", text=True)
    assert "demand tc^bf" in text and "plan " in text
    (transform, est), (ref_t, ref_est) = (pair.srv.explain(adorn=("tc", "bf")),
                                          pair.ref.explain(adorn=("tc", "bf")))
    assert transform.to_dict() == ref_t.to_dict()
    assert est.to_json() == ref_est.to_json() and est.total_cost() > 0
    with pytest.raises(RequestError, match="invalid adornment"):
        pair.srv.explain(adorn="tc^zz")


# -- DL202 eligibility explainer (lint surface) ------------------------------


def test_demand_diagnostics_cover_idb_preds():
    src = TC + "best(x, MIN(y)) :- tc(x, y).\n"
    diags = demand_diagnostics(parse(src))
    want = ref_analysis.demand_diagnostics(ref_parse(src))
    assert [(d.code, d.message, repr(d.span)) for d in diags] == [
        (d.code, d.message, repr(d.span)) for d in want]
    by_msg = {d.message.split("^")[0]: d for d in diags}
    assert _codes(diags) == ["DL202"]
    assert "eligible for demand specialization" in by_msg["tc"].message
    assert "not eligible" in by_msg["best"].message


def test_server_lint_reports_dl202(rng):
    edges = rng.integers(0, 20, size=(30, 2)).astype(np.int32)
    pair = DemandPair(TC, {"arc": edges})
    diags, want = pair.srv.lint(), pair.ref.lint()
    assert [(d.code, d.message) for d in diags] == [(d.code, d.message) for d in want]
    dl202 = [d for d in diags if d.code == "DL202"]
    assert dl202 and all(d.severity == "info" for d in dl202)
    assert not any(d.code == "DL202" for d in pair.inst.plan.report.diagnostics)


def test_explain_demand_config_off():
    report = analyze_program(TC, AnalysisConfig(explain_demand=False))
    ref = ref_analysis.analyze_program(TC, ref_analysis.AnalysisConfig(explain_demand=False))
    assert report.to_json() == ref.to_json()
    assert not any(d.code == "DL202" for d in report.diagnostics)


# -- CLI ----------------------------------------------------------------------


def both_cli(argv, capsys):
    code = cli(argv)
    out, err = capsys.readouterr()
    ref_code = ref_cli(argv)
    ref_out, ref_err = capsys.readouterr()
    assert (code, out, err) == (ref_code, ref_out, ref_err)
    return code, out


def test_cli_adorn_text(tmp_path, capsys):
    f = tmp_path / "tc.dl"
    f.write_text(TC)
    code, out = both_cli(["--adorn", "tc^bf", str(f)], capsys)
    assert code == 0 and "--- demand ---" in out and "__m_bf__tc" in out


def test_cli_adorn_json(tmp_path, capsys):
    f = tmp_path / "tc.dl"
    f.write_text(TC)
    code, out = both_cli(["--json", "--adorn", "tc/bf", str(f)], capsys)
    demand = json.loads(out)[0]["demand"]
    assert code == 0 and demand["ok"] is True and demand["seed_rel"] == "__s_bf__tc"


def test_cli_adorn_usage_errors_exit_two(tmp_path, capsys):
    f = tmp_path / "tc.dl"
    f.write_text(TC)
    for spec in ("garbage", "tc^bq", "nosuch^bf"):
        assert both_cli(["--adorn", spec, str(f)], capsys)[0] == 2


# -- spans ---------------------------------------------------------------------


MULTILINE = """\
p(x,
  y) :- e(x, y),
        f(y, x).

q(x, y) :-
    e(x, y).
"""


def test_parser_spans_on_multiline_rules():
    prog, ref = parse(MULTILINE), ref_parse(MULTILINE)
    assert prog.rules[0].span == Span(1, 1) and prog.rules[1].span == Span(5, 1)
    atoms = prog.rules[0].atoms
    assert atoms[0].span.line == 2 and atoms[1].span.line == 3
    assert [repr(a.span) for r in prog.rules for a in r.atoms] == [
        repr(a.span) for r in ref.rules for a in r.atoms]


def test_rewrite_pipeline_preserves_source_spans():
    prog = parse("\n\nq(x) :- e(x, y), f(y, 3).")
    rewritten, diags = rewrite_program(prog, RewriteConfig())
    assert _codes(diags) == ["DL304"]
    assert rewritten.rules[0].span == prog.rules[0].span == Span(3, 1)


def test_demand_rules_never_carry_stale_spans():
    prog = parse(TC)
    t = both_transforms(TC, "tc", "bf", NO_PROFIT)
    src_spans = {r.span for r in prog.rules}
    for ar in t.adorned:
        assert ar.guarded.span == ar.rule.span
        assert all(m.span is None for m in ar.magic_rules)
    for rule in t.program.rules:
        if rule.head_pred.startswith("__m_") or any(
            a.pred.startswith("__s_") for a in rule.atoms
        ):
            assert rule.span is None
        else:
            assert rule.span in src_spans


# -- random programs x random binding patterns --------------------------------


def _random_positive_program(rnd: random.Random) -> str:
    """Layered safe positive program over e/2, f/2 (the generator of
    ``test_demand.py``)."""
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
            if rnd.random() < 0.4:
                body.append(f"{rnd.choice(bvars)} == {rnd.randint(0, 5)}")
            h = (rnd.choice(bvars), rnd.choice(bvars))
            rules.append(f"{head}({h[0]},{h[1]}) :- {', '.join(body)}.")
    if rnd.random() < 0.4:
        rules.append("q(x,y) :- q(x,z), e(z,y).")
    return "\n".join(rules)


@pytest.mark.parametrize("seed", range(6))
def test_demand_soundness_property(seed):
    rnd = random.Random(seed)
    src = _random_positive_program(rnd)
    pred = rnd.choice(["p", "q"])
    pattern = "".join(rnd.choice("bf") for _ in range(2))
    t = both_transforms(src, pred, pattern, NO_PROFIT)
    if not t.ok:
        assert t.fallback.code in ("DL405", "DL406", "DL407"), (src, pattern)
        return
    npr = np.random.default_rng(seed)
    edb = {
        "e": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
        "f": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
    }
    seeds = [tuple(s) for s in npr.integers(0, 8, (5, len(t.bound_cols)))]
    problems = verify_rewrite(parse(src), t.program, edb, EngineConfig(**CFG),
                              demand=t, seeds=seeds, device=CPU)
    assert problems == [], (src, pred, pattern, problems)


# -- a fault of the reference that the port shares: the magic-set transform
#    drops an answer on these generator seeds (seed 14708: query q^bb, one row
#    at (0, 0) in the full fixpoint, none demanded) -------------------------------

KNOWN_REFERENCE_FAULT_SEEDS = (14708, 314113013, 4924312)


def _soundness_case(seed):
    """The property test's program, query, EDB and seed rows at ``seed``, and
    the transform (equal in both packages)."""
    rnd = random.Random(seed)
    src = _random_positive_program(rnd)
    pred = rnd.choice(["p", "q"])
    pattern = "".join(rnd.choice("bf") for _ in range(2))
    t = both_transforms(src, pred, pattern, NO_PROFIT)
    assert t.ok, (src, pred, pattern)
    npr = np.random.default_rng(seed)
    edb = {
        "e": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
        "f": npr.integers(0, 6, size=(rnd.randint(1, 10), 2)).astype(np.int32),
    }
    seeds = [tuple(s) for s in npr.integers(0, 8, (5, len(t.bound_cols)))]
    return src, t, edb, seeds


@pytest.mark.parametrize("seed", KNOWN_REFERENCE_FAULT_SEEDS)
def test_demand_soundness_known_reference_fault(seed):
    """Parity where the reference is unsound: both packages demand the same
    answers and report the same missing rows."""
    src, t, edb, seeds = _soundness_case(seed)
    spec_edb = {**edb, t.seed_rel: np.asarray(seeds, np.int32)}
    ref_t = ref_analysis.demand_transform(ref_parse(src), t.query_pred, t.adornment,
                                          ref_analysis.DemandConfig(**NO_PROFIT))
    got = Engine(EngineConfig(**CFG), device=CPU).run(t.program, spec_edb)
    want = RefEngine(RefConfig(**CFG)).run(ref_t.program, spec_edb)
    assert np.array_equal(np.asarray(got[t.answer_rel]), np.asarray(want[t.answer_rel]))
    problems = verify_rewrite(parse(src), t.program, edb, EngineConfig(**CFG),
                              demand=t, seeds=seeds, device=CPU)
    ref_problems = ref_analysis.verify_rewrite(ref_parse(src), ref_t.program, edb,
                                               RefConfig(**CFG), demand=ref_t, seeds=seeds)
    assert problems == ref_problems


@pytest.mark.xfail(strict=True, reason="the magic-set transform of both packages drops an "
                   "answer at these seeds (ROADMAP §C); a repair of both flips this")
@pytest.mark.parametrize("seed", KNOWN_REFERENCE_FAULT_SEEDS)
def test_demand_soundness_at_the_known_fault_seeds(seed):
    src, t, edb, seeds = _soundness_case(seed)
    problems = verify_rewrite(parse(src), t.program, edb, EngineConfig(**CFG),
                              demand=t, seeds=seeds, device=CPU)
    assert problems == [], (src, t.query_pred, t.adornment, problems)
