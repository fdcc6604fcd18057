"""The static-analysis front end: ``repro_torch.analysis`` against
``repro.analysis``.

The counterparts of ``test_analysis.py``.  Every program goes through both
analyzers and the reports must be equal: each diagnostic's code, severity,
message, span and rule index, the rewritten program's text, the pass set,
the config fingerprints and the admission fingerprints.  The serving
surfaces (``PlanCache`` admission, ``DatalogServer.lint``, the analysis
metrics) run on the CPU, and the CLI's text and ``--json`` output over
``examples/datalog/*.dl`` must equal the reference's.  Also pins that each
ported package re-exports the reference's public names.
"""

import glob
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as ref_analysis
from repro.analysis.__main__ import run as ref_cli
from repro.core import Engine as RefEngine
from repro.core.analyzer import analyze as ref_analyze
from repro.core.parser import DatalogSyntaxError as RefSyntaxError
from repro.core.parser import parse as ref_parse
from repro.serve_datalog import DatalogServer as RefServer
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro.serve_datalog import RequestError as RefRequestError
from repro.serve_datalog.plan_cache import ADMISSION_CONFIG as REF_ADMISSION
from repro_torch import analysis
from repro_torch.analysis.__main__ import run as cli
from repro_torch.analysis.diagnostics import severity_of
from repro_torch.analysis.passes import stratification_diagnostics
from repro_torch.core import Engine
from repro_torch.core.analyzer import analyze
from repro_torch.core.parser import DatalogSyntaxError, parse
from repro_torch.serve_datalog import DatalogServer, MaterializedInstance, RequestError
from repro_torch.serve_datalog.plan_cache import ADMISSION_CONFIG, PlanCache, fingerprint

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(glob.glob(str(ROOT / "examples" / "datalog" / "*.dl")))
CPU = "cpu"


def diag_key(d):
    """Everything a diagnostic says: code, severity, message, span, rule."""
    return (d.code, d.severity, d.message, repr(d.span), d.rule_index, repr(d.rule))


def both_reports(source, ref_config=None, port_config=None, **kw):
    """Analyze ``source`` with both packages; assert the reports are equal."""
    ref = ref_analysis.analyze_program(
        source, ref_config or ref_analysis.DEFAULT_CONFIG, **kw)
    port = analysis.analyze_program(source, port_config or analysis.DEFAULT_CONFIG, **kw)
    assert [diag_key(d) for d in port.diagnostics] == [diag_key(d) for d in ref.diagnostics]
    assert port.to_json() == ref.to_json()
    assert port.pass_times.keys() == ref.pass_times.keys()
    assert repr(port.rewritten) == repr(ref.rewritten)
    return ref, port


# -- per-code minimal triggers ----------------------------------------------

MINIMAL = {
    "DL001": "p(x :- q(x).",
    "DL002": "p(x) :- q(y).",
    "DL003": "p(x) :- e(x), !f(y).",
    "DL004": "p(x) :- e(x), y < 3.",
    "DL005": "p(x) :- e(x), e(x,y).",
    "DL006": "p(x) :- e(x), !q(x). q(x) :- e(x), !p(x).",
    "DL007": "c(x, SUM(y)) :- e(x,y). c(x, SUM(y)) :- c(x,y), e(x,y).",
    "DL008": "p(_) :- e(x).",
    "DL101": "p(x) :- e(x,y).",
    "DL102": "p(x,y) :- e(x,x), f(y,y).",
    "DL104": "p(x) :- e(x). p(y) :- e(y).",
    "DL105": "p(x) :- e(x). p(x) :- e(x), f(x).",
    "DL106": "p(x) :- e(x), 1 == 2.",
}


@pytest.mark.parametrize("code", sorted(MINIMAL))
def test_minimal_program_fires_code(code):
    _ref, port = both_reports(MINIMAL[code])
    assert code in port.codes()


def test_dl103_requires_explicit_outputs():
    src = "p(x) :- e(x). q(x) :- e(x)."
    _ref, port = both_reports(src)
    assert "DL103" not in port.codes()
    _ref, port = both_reports(src, outputs=("p",))
    assert "DL103" in port.codes()
    assert [r.head_pred for r in port.rewritten.rules] == ["p"]


def test_dl201_explains_eligibility_both_ways():
    for src, verdict in (("tc(x,y) :- e(x,y). tc(x,y) :- tc(x,z), e(z,y).", "TC-shaped"),
                         ("r(y) :- s(y). r(y) :- r(x), e(x,y).", "not eligible")):
        _ref, port = both_reports(src)
        [d] = [d for d in port.diagnostics if d.code == "DL201"]
        assert verdict in d.message


def test_lint_program_returns_diagnostics_without_raising():
    src = "p(x) :- q(y). r(x) :- e(x,y)."
    want = ref_analysis.lint_program(src)
    got = analysis.lint_program(src)
    assert [diag_key(d) for d in got] == [diag_key(d) for d in want]
    assert {d.code for d in got} >= {"DL002", "DL101"}


def test_every_code_documented_and_typed():
    assert analysis.CODES == ref_analysis.CODES
    assert (analysis.ERROR, analysis.WARNING, analysis.INFO) == (
        ref_analysis.ERROR, ref_analysis.WARNING, ref_analysis.INFO)
    for code in analysis.CODES:
        sev = {"0": "error", "1": "warning"}.get(code[2], "info")
        assert severity_of(code) == sev


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: os.path.basename(p))
def test_examples_suite_is_clean(path):
    _ref, port = both_reports(open(path).read())
    assert not port.errors and not port.warnings
    assert not [d for d in port.diagnostics if d.code.startswith("DL3")]


# -- spans & compat shims ----------------------------------------------------


def test_parser_spans_point_at_tokens():
    src = "a(x,y) :- e(x,y).\n\nb(x,y) :-\n    e(x,z), e(z,y)."
    prog, ref = parse(src), ref_parse(src)
    assert (prog.rules[0].span.line, prog.rules[0].span.col) == (1, 1)
    second_atom = prog.rules[1].atoms[1]
    assert (second_atom.span.line, second_atom.span.col) == (4, 13)
    for r, w in zip(prog.rules, ref.rules):
        assert repr(r.span) == repr(w.span)
        assert [repr(a.span) for a in r.atoms] == [repr(a.span) for a in w.atoms]


def test_syntax_error_carries_location():
    src = "p(x)\n  :- q(x."
    with pytest.raises(DatalogSyntaxError) as got:
        parse(src)
    with pytest.raises(RefSyntaxError) as want:
        ref_parse(src)
    assert got.value.lineno == want.value.lineno == 2
    assert repr(got.value.span) == repr(want.value.span)
    assert got.value.args == want.value.args
    both_reports(src)


def test_spans_do_not_change_fingerprints():
    spanned = parse("p(x) :- e(x).")
    bare = parse("p(x) :-\n\n  e(x).")
    assert fingerprint(spanned) == fingerprint(bare) == fingerprint("p(x) :- e(x).")


@pytest.mark.parametrize(
    "src,match",
    [
        ("p(x) :- q(y).", "unsafe rule"),
        ("p(x) :- e(x), !f(y).", "unsafe negation"),
        ("p(x) :- e(x), y < 3.", "unsafe comparison"),
        ("p(_) :- e(x).", "unsafe rule"),
        ("p(x) :- e(x), e(x,y).", "arity mismatch for"),
    ],
)
def test_compat_shims_raise_historical_messages(src, match):
    with pytest.raises(ValueError, match=match) as got:
        parse(src)
    with pytest.raises(ValueError) as want:
        ref_parse(src)
    assert str(got.value) == str(want.value)


def test_analyze_still_raises_unstratifiable():
    src = "p(x) :- e(x), !q(x). q(x) :- e(x), !p(x)."
    with pytest.raises(ValueError, match="unstratifiable") as got:
        analyze(parse(src, validate=False))
    with pytest.raises(ValueError) as want:
        ref_analyze(ref_parse(src, validate=False))
    assert str(got.value) == str(want.value)


def test_negative_cycle_witness_in_message():
    """Two negative cycles, one of them through a three-predicate path: each
    DL006 witness, and the first one ``analyze`` raises, equal the
    reference's."""
    src = (
        "a(x) :- e(x), !c(x). "
        "b(x) :- a(x). "
        "c(x) :- b(x). "
        "p(x) :- e(x), !q(x). "
        "q(x) :- e(x), r(x). "
        "r(x) :- p(x), !a(x)."
    )
    got = stratification_diagnostics(parse(src, validate=False))
    want = ref_analysis.passes.stratification_diagnostics(ref_parse(src, validate=False))
    assert [diag_key(d) for d in got] == [diag_key(d) for d in want]
    assert [d.code for d in got] == ["DL006", "DL006"]
    assert "a -> b -> c -[negated]-> a" in got[0].message
    assert "p -> r -> q -[negated]-> p" in got[1].message
    with pytest.raises(ValueError, match="negative cycle") as err:
        analyze(parse(src, validate=False))
    with pytest.raises(ValueError) as ref_err:
        ref_analyze(ref_parse(src, validate=False))
    assert str(err.value) == str(ref_err.value)
    both_reports(src)


# -- wildcards ---------------------------------------------------------------


def test_wildcard_in_head_rejected_with_dedicated_code():
    _ref, port = both_reports("p(_, x) :- e(x).")
    assert [d.code for d in port.errors] == ["DL008"]
    assert "wildcard" in port.errors[0].message


def test_multiple_body_wildcards_do_not_unify():
    edb = {"t": np.array([[0, 1, 2], [1, 5, 5], [2, 7, 8]], np.int32)}
    out = Engine(device=CPU).run("p(x) :- t(x, _, _).", edb)
    want = RefEngine().run("p(x) :- t(x, _, _).", edb)
    np.testing.assert_array_equal(out["p"], want["p"])
    assert sorted(r[0] for r in out["p"]) == [0, 1, 2]


# -- admission wiring --------------------------------------------------------


def test_plan_cache_rejects_with_diagnostics():
    cache = PlanCache()
    with pytest.raises(RequestError) as got:
        cache.get("p(x) :- q(y).")
    with pytest.raises(RefRequestError) as want:
        RefCache().get("p(x) :- q(y).")
    assert got.value.rid == -1
    assert str(got.value) == str(want.value)
    assert [diag_key(d) for d in got.value.diagnostics] == [
        diag_key(d) for d in want.value.diagnostics]
    assert any(d.code == "DL002" for d in got.value.diagnostics)
    assert cache.stats()["plans"] == 0


def test_plan_cache_syntax_rejection():
    with pytest.raises(RequestError, match="rejected") as got:
        PlanCache().get("p(x :- q(x).")
    with pytest.raises(RefRequestError) as want:
        RefCache().get("p(x :- q(x).")
    assert str(got.value) == str(want.value)


def test_bypass_path_wraps_validate_error():
    with pytest.raises(RequestError, match="rejected") as got:
        PlanCache().get(parse("p(x) :- q(y).", validate=False), analysis=None)
    with pytest.raises(RefRequestError) as want:
        RefCache().get(ref_parse("p(x) :- q(y).", validate=False), analysis=None)
    assert str(got.value) == str(want.value)


def test_admission_plans_the_rewritten_program():
    src = """
    null(x,y) :- nullEdge(x,y).
    null(x,y) :- null(x,w), arc(w,y).
    null(a,b) :- nullEdge(a,b).
    null(x,y) :- nullEdge(x,y), 1 == 2.
    """
    cache, ref_cache = PlanCache(), RefCache()
    plan, ref_plan = cache.get(src), ref_cache.get(src)
    assert len(plan.program.rules) == 2
    assert plan.fingerprint == ref_plan.fingerprint
    assert repr(plan.program) == repr(ref_plan.program)
    assert [diag_key(d) for d in plan.report.diagnostics] == [
        diag_key(d) for d in ref_plan.report.diagnostics]
    assert {d.code for d in plan.report.diagnostics} >= {"DL301", "DL302"}
    again = cache.get(repr(plan.program))
    assert again.fingerprint == plan.fingerprint
    # the duplicated base rule of TC: the fingerprint the manifests carry
    dup = "tc(x,y) :- arc(x,y).\ntc(x,y) :- arc(x,y).\ntc(x,y) :- tc(x,z), arc(z,y)."
    assert cache.get(dup).fingerprint == ref_cache.get(dup).fingerprint == "49712c469be1343d"
    assert cache.get(dup, analysis=None).fingerprint == "4c66f4deaed03640"


def test_analysis_config_participates_in_cache_key():
    src = "p(x) :- e(x). p(y) :- e(y)."
    cache, ref_cache = PlanCache(), RefCache()
    rewritten = cache.get(src)
    raw = cache.get(src, analysis=analysis.AnalysisConfig(rewrite=analysis.NO_REWRITES))
    ref_raw = ref_cache.get(
        src, analysis=ref_analysis.AnalysisConfig(rewrite=ref_analysis.NO_REWRITES))
    ref_rewritten = ref_cache.get(src)
    assert len(rewritten.program.rules) == 1 and len(raw.program.rules) == 2
    assert (rewritten.fingerprint, raw.fingerprint) == (
        ref_rewritten.fingerprint, ref_raw.fingerprint)
    assert rewritten.fingerprint != raw.fingerprint
    assert cache.stats() == ref_cache.stats()
    assert cache.stats()["plans"] == 2


def test_rewrite_config_fingerprints_differ():
    pairs = [
        (analysis.RewriteConfig(), ref_analysis.RewriteConfig()),
        (analysis.NO_REWRITES, ref_analysis.NO_REWRITES),
        (analysis.RewriteConfig(outputs=("tc",)), ref_analysis.RewriteConfig(outputs=("tc",))),
        (analysis.DEFAULT_CONFIG, ref_analysis.DEFAULT_CONFIG),
        (analysis.AnalysisConfig(rewrite=analysis.NO_REWRITES, lint=False),
         ref_analysis.AnalysisConfig(rewrite=ref_analysis.NO_REWRITES, lint=False)),
        (ADMISSION_CONFIG, REF_ADMISSION),
    ]
    for port, ref in pairs:
        assert repr(port) == repr(ref)
        assert port.fingerprint() == ref.fingerprint()
    assert len({port.fingerprint() for port, _ in pairs}) == len(pairs)


def test_server_lint_and_metrics():
    edb = {"e": np.array([[0, 1], [1, 2]], np.int32)}
    prog = "tc(x,y) :- e(x,y). tc(x,y) :- tc(x,z), e(z,y)."
    srv = DatalogServer(MaterializedInstance(prog, edb, cache=PlanCache(), device=CPU))
    ref = RefServer(RefInstance(prog, edb, cache=RefCache()))
    for source in (None, "p(x) :- q(y)."):
        got, want = srv.lint(source), ref.lint(source)
        assert [diag_key(d) for d in got] == [diag_key(d) for d in want]
        assert any(d.code == ("DL201" if source is None else "DL002") for d in got)
    m, ref_m = srv.metrics(), ref.metrics()
    for key in ("datalog_lint_requests_total", "datalog_admission_rewrites",
                *(f'datalog_admission_diagnostics{{severity="{s}"}}'
                  for s in ("error", "warning", "info"))):
        assert m[key] == ref_m[key], key
    assert m["datalog_lint_requests_total"] == 2.0
    assert m['datalog_admission_diagnostics{severity="error"}'] == 0.0


def test_instance_rejects_invalid_program():
    with pytest.raises(RequestError) as got:
        MaterializedInstance("p(x) :- q(y).", {"q": np.array([[1]], np.int32)}, device=CPU)
    with pytest.raises(RefRequestError) as want:
        RefInstance("p(x) :- q(y).", {"q": np.array([[1]], np.int32)})
    assert str(got.value) == str(want.value)


def test_admission_pass_times_recorded():
    plan, ref_plan = PlanCache().get("p(x) :- e(x)."), RefCache().get("p(x) :- e(x).")
    assert {"safety", "arity", "rewrite"} <= set(plan.report.pass_times)
    assert plan.report.pass_times.keys() == ref_plan.report.pass_times.keys()


# -- CLI ---------------------------------------------------------------------


def both_cli(argv, capsys):
    """Run both CLIs on ``argv``: (exit code, stdout), equal in both."""
    code = cli(argv)
    out = capsys.readouterr().out
    ref_code = ref_cli(argv)
    ref_out = capsys.readouterr().out
    assert (code, out) == (ref_code, ref_out)
    return code, out


def test_cli_clean_examples_exit_zero(capsys):
    code, out = both_cli(["--strict", *EXAMPLES], capsys)
    assert code == 0 and "0 error(s)" in out
    code, out = both_cli(["--json", *EXAMPLES], capsys)
    assert code == 0 and len(json.loads(out)) == len(EXAMPLES)


def test_cli_error_exit_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.dl"
    bad.write_text("p(x) :- q(y).\n")
    assert both_cli([str(bad)], capsys)[0] == 1
    code, out = both_cli(["--json", str(bad)], capsys)
    payload = json.loads(out)
    assert code == 1 and payload[0]["ok"] is False
    assert payload[0]["diagnostics"][0]["line"] == 1


def test_cli_strict_promotes_warnings(tmp_path, capsys):
    warny = tmp_path / "warn.dl"
    warny.write_text("p(x) :- e(x,y).\n")
    assert both_cli([str(warny)], capsys)[0] == 0
    assert both_cli(["--strict", str(warny)], capsys)[0] == 1
    assert both_cli(["--no-lint", "--strict", str(warny)], capsys)[0] == 0


def test_cli_show_rewritten(tmp_path, capsys):
    f = tmp_path / "r.dl"
    f.write_text("p(x) :- e(x). p(y) :- e(y).\n")
    code, out = both_cli(["--show-rewritten", str(f)], capsys)
    assert code == 0 and "--- rewritten ---" in out
    code, out = both_cli(["--show-rewritten", "--no-rewrite", str(f)], capsys)
    assert out.split("--- rewritten ---")[1].count("p(") == 2


def test_cli_runs_as_a_module_on_the_host():
    """``python -m repro_torch.analysis`` with JAX and ``repro`` blocked: the
    text output over the examples equals the reference's."""
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'networkx', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['x', '--strict', *sys.argv[1:]]\n"
        "runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, *EXAMPLES], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    ref = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--strict", *EXAMPLES],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert ref.returncode == 0, ref.stderr
    assert out.stdout == ref.stdout
    assert "python -m repro_torch.analysis" in analysis.__main__.build_parser().format_usage()


# -- the packages' public names ------------------------------------------------

#: the distributed layer's JAX-only name, which has no counterpart:
#: ``shard_map`` (each rank is a process that runs its shard's code)
UNPORTED = {
    "distributed": {"shard_map"},
}


@pytest.mark.parametrize("package", ["core", "obs", "relational", "data", "analysis",
                                     "serve_datalog", "persist", "loadgen", "optim", "train",
                                     "distributed", "models.recsys", "models.transformer",
                                     "models.gnn", "configs", "launch"])
def test_exports_cover_the_reference(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    if not hasattr(ref, "__all__"):             # a namespace package: compare modules
        ref_mods = {m.name for m in pkgutil.iter_modules(ref.__path__)}
        port_mods = {m.name for m in pkgutil.iter_modules(port.__path__)}
        want = ref_mods - UNPORTED.get(package, set())
        assert want <= port_mods, sorted(want - port_mods)
        return
    want = set(ref.__all__) - UNPORTED.get(package, set())
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name
