"""Analyzer orchestration: parse → error passes → lints → rewrites.

:func:`analyze_program` is the one entry point the CLI, the test suite,
and the serving admission path (``PlanCache``) all share.  Per-pass wall
time is recorded in ``AnalysisReport.pass_times`` and emitted as
``analysis.pass`` tracer spans (:mod:`repro_torch.obs`), so admission cost shows
up in the same Chrome-trace timeline as evaluation.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.analysis.diagnostics import AnalysisReport, Diagnostic
from repro_torch.analysis.passes import (
    arity_diagnostics,
    cross_product_diagnostics,
    duplicate_diagnostics,
    pbme_diagnostics,
    safety_diagnostics,
    singleton_diagnostics,
    stratification_diagnostics,
    subsumed_diagnostics,
    unreachable_diagnostics,
    unsatisfiable_diagnostics,
)
from repro_torch.analysis.rewrites import (
    DEFAULT_REWRITES,
    RewriteConfig,
    rewrite_program,
)
from repro_torch.core.ast import Program
from repro_torch.obs import get_tracer


@dataclass(frozen=True)
class AnalysisConfig:
    """One admission-policy knob bundle.

    ``rewrite`` selects the semantics-preserving rewrites applied before
    planning; ``lint`` turns the DL1xx warning passes on/off (errors
    always run); ``explain_pbme`` adds the DL201 eligibility explainer;
    ``explain_demand`` adds the DL202 demand-specialization explainer
    (one info per IDB predicate: can a first-column-bound point query
    specialize it — see ``repro_torch.analysis.demand``).  The fingerprint
    participates in the :class:`PlanCache` key, so two admissions under
    different configs never share a cache slot.
    """

    rewrite: RewriteConfig = field(default_factory=lambda: DEFAULT_REWRITES)
    lint: bool = True
    explain_pbme: bool = True
    explain_demand: bool = True

    def fingerprint(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()[:8]


DEFAULT_CONFIG = AnalysisConfig()


def _timed(
    report: AnalysisReport, name: str, fn: Callable[[], list[Diagnostic]]
) -> list[Diagnostic]:
    t0 = time.perf_counter()
    with get_tracer().span(f"analysis.{name}", "analysis"):
        diags = fn()
    report.pass_times[name] = time.perf_counter() - t0
    report.extend(diags)
    return diags


def analyze_program(
    source: "str | Program",
    config: AnalysisConfig = DEFAULT_CONFIG,
    *,
    outputs: "tuple[str, ...] | None" = None,
    engine_config=None,
) -> AnalysisReport:
    """Full analysis of ``source`` (Datalog text or a parsed ``Program``).

    Never raises on a bad program — syntax errors come back as ``DL001``,
    semantic errors as the other ``DL0xx`` codes.  ``report.rewritten``
    holds the program the planner should consume (``None`` iff errors).
    ``outputs`` feeds both DL103 reachability linting and, merged into
    ``config.rewrite.outputs``, reachability-based dead-rule elimination.
    """
    from dataclasses import replace as _replace

    report = AnalysisReport(source=source if isinstance(source, str) else None)

    if isinstance(source, str):
        from repro_torch.core.parser import DatalogSyntaxError, parse

        t0 = time.perf_counter()
        try:
            with get_tracer().span("analysis.parse", "analysis"):
                program = parse(source, validate=False)
        except DatalogSyntaxError as e:
            report.pass_times["parse"] = time.perf_counter() - t0
            msg = e.args[0] if e.args else str(e)
            report.diagnostics.append(Diagnostic("DL001", msg, span=e.span))
            return report
        report.pass_times["parse"] = time.perf_counter() - t0
    else:
        program = source
    report.program = program

    rw = config.rewrite
    if outputs is not None:
        rw = _replace(rw, outputs=tuple(outputs))

    # error passes — always on
    _timed(report, "safety", lambda: safety_diagnostics(program))
    _timed(report, "arity", lambda: arity_diagnostics(program))
    if not report.errors:
        # stratification only makes sense once arities/safety hold
        _timed(report, "stratification", lambda: stratification_diagnostics(program))

    # lint passes — warnings, never block
    if config.lint:
        _timed(report, "singleton", lambda: singleton_diagnostics(program))
        _timed(report, "cross_product", lambda: cross_product_diagnostics(program))
        _timed(report, "unreachable", lambda: unreachable_diagnostics(program, rw.outputs))
        _timed(report, "duplicate", lambda: duplicate_diagnostics(program))
        _timed(report, "subsumed", lambda: subsumed_diagnostics(program))
        _timed(report, "unsatisfiable", lambda: unsatisfiable_diagnostics(program))

    if report.errors:
        return report

    # rewrites — only valid programs
    t0 = time.perf_counter()
    with get_tracer().span("analysis.rewrite", "analysis"):
        rewritten, rw_diags = rewrite_program(program, rw)
    report.pass_times["rewrite"] = time.perf_counter() - t0
    report.extend(rw_diags)
    report.rewritten = rewritten

    if config.explain_pbme:
        _timed(
            report,
            "pbme_explain",
            lambda: pbme_diagnostics(rewritten, engine_config),
        )

    if config.explain_demand:
        from repro_torch.analysis.demand import demand_diagnostics

        _timed(
            report,
            "demand_explain",
            lambda: demand_diagnostics(rewritten),
        )
    return report


def lint_program(
    source: "str | Program",
    config: AnalysisConfig = DEFAULT_CONFIG,
    *,
    outputs: "tuple[str, ...] | None" = None,
) -> list[Diagnostic]:
    """Diagnostics only (no rewrite output) — the ``srv.lint`` surface."""
    return analyze_program(source, config, outputs=outputs).diagnostics
