"""EXPLAIN/ANALYZE on the port: estimates, profiles, the slow-query ring and
the Prometheus exposition, against the reference.

The counterparts of ``test_profile.py`` (all but its three checks of the
``benchmarks`` perf gate, which the port has no counterpart of).  The same
seeded CSDA and TC instances are built by both packages, the port's on the
CPU; estimates must be equal to the reference's, profiles must hold the same
invariants with the same counts, and the metrics must render the same text.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro.core.engine import EngineConfig as RefConfig
from repro.obs.explain import estimate_plan as ref_estimate_plan
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.serve_datalog import DatalogServer as RefServer
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro_torch.core.engine import EngineConfig
from repro_torch.data.program_facts import csda_facts
from repro_torch.obs import TRACER, MetricsRegistry, estimate_plan, estimate_query_rows
from repro_torch.obs.profile import RATIO_BUCKETS, misestimation_ratio
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance, ServerLimits

CPU = "cpu"

CSDA = """
null(x,y) :- nullEdge(x,y).
null(x,y) :- null(x,w), arc(w,y).
"""

TC = """
tc(x,y) :- arc(x,y).
tc(x,y) :- tc(x,z), arc(z,y).
"""


def _csda_instance(n=24, seed=3):
    return MaterializedInstance(CSDA, csda_facts(n, seed=seed),
                                config=EngineConfig(backend="tuple"), device=CPU)


def _ref_csda_instance(n=24, seed=3):
    return RefInstance(CSDA, csda_facts(n, seed=seed), config=RefConfig(backend="tuple"),
                       cache=RefCache())


def _tc_pair(arc):
    edb = {"arc": np.asarray(arc, np.int32)}
    return (MaterializedInstance(TC, edb, config=EngineConfig(backend="tuple"), device=CPU),
            RefInstance(TC, edb, config=RefConfig(backend="tuple"), cache=RefCache()))


def _same_estimate(plan, ref_plan, **kw):
    est, want = estimate_plan(plan, **kw), ref_estimate_plan(ref_plan, **kw)
    assert est.to_json() == want.to_json()
    assert est.render_text() == want.render_text()
    return est


# --------------------------------------------------------------------------
# plan-time estimator
# --------------------------------------------------------------------------


def test_estimate_copy_rule_is_input_size():
    est = _same_estimate(_csda_instance().plan, _ref_csda_instance().plan,
                         sizes={"nullEdge": 7.0, "arc": 50.0}, domain=24)
    copy = next(r for r in est.strata[0].rules if "nullEdge" in r.inputs)
    assert copy.est_rows == pytest.approx(7.0)


def test_estimate_join_uses_independence_assumption():
    inst, ref = _tc_pair([[0, 1], [1, 2]])
    est = _same_estimate(inst.plan, ref.plan, sizes={"arc": 10.0}, domain=20)
    join = next(r for r in est.strata[0].rules if "tc" in r.inputs)
    assert join.inputs["arc"] == pytest.approx(10.0)
    assert join.est_rows <= 20.0 * 20.0
    assert est.stratum(0).recursive and est.stratum(0).est_rows >= 10.0


def test_estimate_recursive_stratum_converges_and_caps():
    inst, ref = _tc_pair([[0, 1]])
    est = _same_estimate(inst.plan, ref.plan, sizes={"arc": 64.0}, domain=8)
    assert 0 < est.strata[0].est_rows <= 64.0
    assert np.isfinite(est.total_cost())


def test_scaled_delta_first_order():
    est = _same_estimate(_csda_instance().plan, _ref_csda_instance().plan,
                         sizes={"nullEdge": 10.0, "arc": 100.0}, domain=50)
    full = est.strata[0].est_rows
    assert est.scaled_delta({"arc": 10.0})[0] == pytest.approx(full * 0.1)
    assert est.scaled_delta({"unrelated": 5.0}) == {}
    assert est.scaled_delta({"arc": 1000.0})[0] == pytest.approx(full)


def test_estimate_query_rows_bounds():
    assert estimate_query_rows(100.0, 10, {}) == pytest.approx(100.0)
    assert estimate_query_rows(100.0, 10, {0: (3, 3)}) == pytest.approx(10.0)
    assert estimate_query_rows(100.0, 10, {0: (2, 6)}) == pytest.approx(50.0)


def test_misestimation_ratio_smoothing():
    assert misestimation_ratio(0, 0) == 1.0
    assert misestimation_ratio(99, 9) == 10.0
    assert misestimation_ratio(9, 99) == 0.1
    assert RATIO_BUCKETS == tuple(sorted(RATIO_BUCKETS))


def test_plan_estimate_renders_and_serialises():
    est, want = _csda_instance().explain(), _ref_csda_instance().explain()
    assert est.to_json() == want.to_json()
    txt = est.render_text()
    assert "stratum 0" in txt and "est_rows≈" in txt and "plan " in txt
    json.dumps(est.to_json())


# --------------------------------------------------------------------------
# ANALYZE: profile assembly
# --------------------------------------------------------------------------


def test_profiled_txn_rule_deltas_sum_to_engine_totals():
    new = np.array([[0, 3], [3, 7]], np.int32)
    srv, ref = DatalogServer(_csda_instance()), RefServer(_ref_csda_instance())
    rid = srv.submit_txn([("insert", "nullEdge", new)], profile=True)
    ref_rid = ref.submit_txn([("insert", "nullEdge", new)], profile=True)
    srv.run()
    ref.run()
    prof, want = srv.profile(rid), ref.profile(ref_rid)
    st = srv.done[rid]
    assert prof.rule_delta_total() == st.derived == want.rule_delta_total()
    assert sum(st.derived_by_stratum.values()) == st.derived
    for sp in prof.strata:
        assert sp.rule_delta_total() == st.derived_by_stratum[sp.index]
        assert sp.actual_rows == st.derived_by_stratum[sp.index]
    assert [(sp.index, sp.actual_rows, sp.est_rows) for sp in prof.strata] == [
        (sp.index, sp.actual_rows, sp.est_rows) for sp in want.strata]
    assert (prof.derived, prof.epoch, prof.kind) == (want.derived, want.epoch, "txn")
    assert all(sp.ratio is None or np.isfinite(sp.ratio) for sp in prof.strata)
    assert f"profile rid={rid}" in prof.render_text()
    json.dumps(prof.to_json())


def test_profiled_query_estimate_vs_actual():
    srv, ref = DatalogServer(_csda_instance()), RefServer(_ref_csda_instance())
    qid, ref_qid = srv.submit_query("null", profile=True), ref.submit_query("null", profile=True)
    srv.run()
    ref.run()
    prof, want = srv.profile(qid), ref.profile(ref_qid)
    assert prof.kind == "query" and prof.rows == len(srv.done[qid]) == want.rows
    assert prof.est_rows == want.est_rows and prof.est_rows > 0
    assert prof.ratio == pytest.approx(misestimation_ratio(prof.rows, prof.est_rows))
    assert 'datalog_misestimation_ratio_count{level="query"} 1' in srv.metrics_prometheus()


def test_concurrent_profiles_do_not_leak_across_requests():
    srv = DatalogServer(_csda_instance())
    tid = srv.submit_txn([("insert", "nullEdge", np.array([[1, 5]], np.int32))],
                         profile=True)
    q1 = srv.submit_query("null", profile=True)
    q2 = srv.submit_query("null", src=0, profile=True)
    srv.run()
    tprof, p1, p2 = srv.profile(tid), srv.profile(q1), srv.profile(q2)
    assert p1.strata == [] and p2.strata == []
    assert (p1.rows, p2.rows) == (len(srv.done[q1]), len(srv.done[q2]))
    names_t = {n.name for root in tprof.roots for n in root.walk()}
    names_q = {n.name for root in p1.roots for n in root.walk()}
    assert "query" not in names_t
    assert "stratum" not in names_q and "rule" not in names_q
    assert tprof.rule_delta_total() == srv.done[tid].derived


def test_profile_requires_opt_in_and_is_bounded():
    srv = DatalogServer(_csda_instance())
    qid = srv.submit_query("null")
    srv.run()
    with pytest.raises(KeyError):
        srv.profile(qid)
    with pytest.raises(KeyError):
        srv.profile(10_000)


def test_profile_off_results_bit_for_bit_unchanged():
    new = np.array([[2, 9], [9, 4]], np.int32)

    def run(profile):
        srv = DatalogServer(_csda_instance())
        tid = srv.submit_txn([("insert", "nullEdge", new)], profile=profile)
        srv.run()
        qid = srv.submit_query("null", profile=profile)
        srv.run()
        return srv.done[qid], srv.done[tid]

    plain_q, plain_t = run(False)
    prof_q, prof_t = run(True)
    np.testing.assert_array_equal(plain_q, prof_q)
    assert (plain_t.derived, plain_t.epoch) == (prof_t.derived, prof_t.epoch)
    assert not TRACER.enabled


# --------------------------------------------------------------------------
# slow-query capture
# --------------------------------------------------------------------------


def test_slow_query_threshold_captures_and_ring_is_bounded():
    srv = DatalogServer(_csda_instance(),
                        limits=ServerLimits(slow_query_threshold=0.0, slow_query_log=2))
    for _ in range(4):
        srv.submit_query("null")
        srv.run()
    slow = srv.slow_queries()
    assert len(slow) == 2
    assert all(p.slow and p.sojourn_seconds > 0.0 for p in slow)
    assert "datalog_slow_queries_total 4" in srv.metrics_prometheus()


def test_no_threshold_means_no_slow_captures():
    srv = DatalogServer(_csda_instance())
    srv.submit_query("null", profile=True)
    srv.run()
    assert srv.slow_queries() == []


def test_high_threshold_profiles_but_does_not_capture():
    srv = DatalogServer(_csda_instance(), limits=ServerLimits(slow_query_threshold=1e9))
    qid = srv.submit_query("null")
    srv.run()
    assert srv.profile(qid).slow is False
    assert srv.slow_queries() == []


def test_limits_validate_slow_query_knobs():
    with pytest.raises(ValueError):
        ServerLimits(slow_query_threshold=-1.0)
    with pytest.raises(ValueError):
        ServerLimits(slow_query_log=0)


# --------------------------------------------------------------------------
# EXPLAIN through the server
# --------------------------------------------------------------------------


def test_server_explain_current_plan_and_candidate_program():
    srv, ref = DatalogServer(_csda_instance()), RefServer(_ref_csda_instance())
    est = srv.explain()
    assert est.actuals and est.to_json() == ref.explain().to_json()
    assert "stratum 0" in srv.explain(text=True)
    cand, ref_cand = srv.explain(TC), ref.explain(TC)
    assert cand.sizes.get("arc", 0) > 0 and cand.strata
    assert cand.to_json() == ref_cand.to_json()
    assert "datalog_explain_requests_total 3" in srv.metrics_prometheus()


# --------------------------------------------------------------------------
# Prometheus exposition
# --------------------------------------------------------------------------


def _both_registries(fill):
    reg, ref = MetricsRegistry(), RefRegistry()
    fill(reg)
    fill(ref)
    text = reg.to_prometheus()
    assert text == ref.to_prometheus()
    return text


def test_prometheus_label_values_are_escaped():
    text = _both_registries(lambda reg: reg.counter(
        "odd_total", "with \\ and\nnewline", labels={"who": 'a"b\\c\nd'}).inc())
    assert '{who="a\\"b\\\\c\\nd"}' in text
    assert "# HELP odd_total with \\\\ and\\nnewline" in text
    assert "\n\n" not in text


def test_prometheus_nonfinite_values_render_spec_spellings():
    def fill(reg):
        reg.gauge("inf_gauge").set(float("inf"))
        reg.gauge("ninf_gauge").set(float("-inf"))
        reg.gauge("nan_gauge").set(float("nan"))

    text = _both_registries(fill)
    assert "inf_gauge +Inf" in text and "ninf_gauge -Inf" in text
    assert "nan_gauge NaN" in text


def test_histogram_inf_bucket_and_sum_count_consistency():
    def fill(reg):
        h = reg.histogram("h_seconds", buckets=(1.0, 2.0))
        for v in (0.5, 1.5, 99.0):
            h.observe(v)

    text = _both_registries(fill)
    assert 'h_seconds_bucket{le="+Inf"} 3' in text
    assert "h_seconds_count 3" in text and "h_seconds_sum 101" in text
