"""Compiled-plan cache: parse/stratify once, keep the reference's warmth record.

Serving traffic repeats the same program over and over (every update batch
and every query hits the same stratification, the same delta-variant groups,
the same relational ops at the same capacity buckets).  Adaptive Recursive
Query Optimization (arXiv 2312.04282) motivates reusing plans across
repeated executions; here the plan is

* the *logical* plan — parsed :class:`Program`, :class:`Stratification` and
  per-stratum semi-naïve variant groups, cached by program fingerprint in an
  LRU; and
* the *physical* plan — PyTorch runs eagerly, so there is nothing to trace
  or cache: materialization itself runs the same sort, dedup, merge and
  select ops on the instance's device before the first request.
  :meth:`PlanCache.warm` only records each (program fingerprint, capacity
  bucket, arity, domain) as the reference's tracing does, so
  ``stats()["warmed_buckets"]`` equals the reference's.

**Admission.**  Every program is admitted through the static analyzer
(:mod:`repro_torch.analysis`) under :data:`ADMISSION_CONFIG`, as the
reference's is: a program with an error diagnostic is rejected, and the
analyzer's *rewritten* program is the one planned and fingerprinted, so the
fingerprints (and the snapshot manifests that carry them) equal the
reference's.  ``analysis=None`` admits by validation alone.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from repro_torch.analysis import AnalysisConfig, AnalysisReport, analyze_program
from repro_torch.core.analyzer import Stratification, analyze
from repro_torch.core.ast import Program
from repro_torch.core.seminaive import RuleVariant, delta_variants
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL
from repro_torch.serve_datalog.errors import RequestError

# Admission default: full error + lint passes, semantics-preserving
# rewrites on, no PBME/demand explainers (those re-run whole-program
# probes; ``lint`` requests get them instead).
ADMISSION_CONFIG = AnalysisConfig(explain_pbme=False, explain_demand=False)


def fingerprint(program: Program | str) -> str:
    """Stable fingerprint of a program's canonical (parsed-AST) form.

    Source text is parsed first so the same program fingerprints identically
    whether passed as text or as a :class:`Program` — whitespace, rule
    formatting, and argument form all normalize away.  Equal to the
    reference's fingerprint of the same program.
    """
    if isinstance(program, str):
        from repro_torch.core.parser import parse

        program = parse(program)
    return hashlib.sha1(repr(program).encode()).hexdigest()[:16]


@dataclass
class CompiledPlan:
    """Logical plan: everything derivable from the program text alone.

    ``program`` (and ``fingerprint``) are the analyzer's *rewritten*
    program — the one actually planned and evaluated.  Because every
    rewrite is idempotent, re-admitting a rewritten program (e.g. a
    snapshot manifest's ``program_source`` on warm start) maps to the
    same fingerprint.  ``report`` carries the admission diagnostics
    (``None`` when analysis was bypassed).
    """

    fingerprint: str
    program: Program
    strat: Stratification
    delta_groups: list[dict[str, list[RuleVariant]]] = field(repr=False)
    report: AnalysisReport | None = field(default=None, repr=False)

    def groups_for(self, stratum_index: int) -> dict[str, list[RuleVariant]]:
        return self.delta_groups[stratum_index]

    def explain(
        self,
        sizes: dict[str, float] | None = None,
        domain: int = 0,
        modes: dict[int, str] | None = None,
        actuals: dict[str, int] | None = None,
    ):
        """EXPLAIN this plan: per-rule/per-stratum cost and cardinality
        estimates (:class:`repro_torch.obs.explain.PlanEstimate`).  Pure —
        touches no device state."""
        from repro_torch.obs.explain import estimate_plan

        return estimate_plan(
            self, sizes=sizes, domain=domain, modes=modes, actuals=actuals
        )


def _select_rows(
    rows: torch.Tensor, lov: list[int], hiv: list[int], mask: tuple
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point/range selection over a padded tuple table.

    ``mask[i]`` marks column ``i`` as constrained to ``[lov[i], hiv[i]]``
    (point queries have ``lov == hiv``); matches are compacted to the front
    preserving sort order (a stable sort of the ``~valid`` flags).
    """
    valid = rows[:, 0] != SENTINEL
    for i, constrained in enumerate(mask):
        if constrained:
            valid &= (rows[:, i] >= lov[i]) & (rows[:, i] <= hiv[i])
    kept = torch.where(valid[:, None], rows, SENTINEL)
    order = torch.argsort(~valid, stable=True)
    return kept[order], valid.sum()


class PlanCache:
    """LRU of :class:`CompiledPlan` + warmed-op bookkeeping.

    One :func:`default_cache` instance is shared process-wide; pass a private
    ``PlanCache`` to isolate tenants.  ``select`` is safe to call from reader
    threads while a writer updates the instance — it touches only its
    arguments.
    """

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._plans: OrderedDict[str, CompiledPlan] = OrderedDict()
        # demand-specialized plans, keyed by (source fingerprint, adornment,
        # analysis + demand config fingerprints) — see get_demand
        self._demand: OrderedDict[str, tuple] = OrderedDict()
        # (fp, bucket, arity, domain, device): the reference keys by the
        # first four; the device keeps a CPU warm-up from counting for CUDA
        self._warmed: set[tuple[str, int, int, int, str]] = set()
        self.hits = 0
        self.misses = 0

    # -- logical plans -----------------------------------------------------

    def get(
        self,
        program: Program | str,
        analysis: AnalysisConfig | None = ADMISSION_CONFIG,
    ) -> CompiledPlan:
        """Admit ``program``: analyze, rewrite, stratify, cache.

        The static analyzer runs on every cache miss; a program with any
        ``DL0xx`` error diagnostic is rejected with a :class:`RequestError`
        carrying the full diagnostic list and is never cached.  What gets
        planned (and fingerprinted) is the analyzer's rewritten program,
        so the LRU key pairs the *source* fingerprint with the analysis
        config's — two admissions under different rewrite configs never
        share a slot.  ``analysis=None`` bypasses the analyzer
        (validate-only admission); plain ``ValueError`` from validation
        still surfaces as a structured :class:`RequestError`.
        """
        with _TRACE.span("plan_cache.get", "serve") as sp:
            if isinstance(program, str):
                from repro_torch.core.parser import DatalogSyntaxError, parse

                try:
                    program = parse(program, validate=False)
                except DatalogSyntaxError as e:
                    raise RequestError(
                        -1, f"program rejected: {e.args[0]}"
                    ) from e
            source_fp = fingerprint(program)
            key = f"{source_fp}:{analysis.fingerprint() if analysis else 'raw'}"
            if key in self._plans:
                self.hits += 1
                self._plans.move_to_end(key)
                sp.set(fingerprint=self._plans[key].fingerprint, hit=True)
                return self._plans[key]
            self.misses += 1
            report: AnalysisReport | None = None
            if analysis is not None:
                report = analyze_program(program, analysis)
                if not report.ok:
                    first = report.errors[0]
                    raise RequestError(
                        -1,
                        f"program rejected by static analysis "
                        f"({len(report.errors)} error(s), first: "
                        f"{first.render()})",
                        diagnostics=report.diagnostics,
                    )
                program = report.rewritten
            fp = fingerprint(program)
            sp.set(fingerprint=fp, hit=False)
            try:
                strat = analyze(program)
            except ValueError as e:
                # unreachable when the analyzer ran (it mirrors these
                # checks), load-bearing for the bypass path
                raise RequestError(-1, f"program rejected: {e}") from e
            plan = CompiledPlan(
                fp,
                program,
                strat,
                [delta_variants(s) for s in strat.strata],
                report=report,
            )
            self._plans[key] = plan
            while len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
            return plan

    def get_demand(
        self,
        program: Program | str,
        query_pred: str,
        pattern: str,
        analysis: AnalysisConfig | None = ADMISSION_CONFIG,
        demand_config=None,
        *,
        sizes: dict[str, float] | None = None,
        domain: int = 0,
    ) -> tuple[CompiledPlan, "object"]:
        """Admit a demand-specialized plan for ``query_pred^pattern``.

        Returns ``(plan, transform)``.  Specialized plans are keyed by
        ``(source fingerprint, adornment, analysis config, demand
        config)`` so the same program specialized for different binding
        patterns — or under different SIP strategies — never shares a
        slot.  When the transform *falls back* (``transform.ok`` is
        False: unstratifiable, unprofitable, unseedable — a coded
        ``DL4xx`` info diagnostic, never an error) the returned plan is
        the ordinary :meth:`get` plan of the unspecialized program.
        ``sizes``/``domain`` feed the profitability estimate and are
        *not* part of the key: profitability is decided at first
        admission and revisited only when the entry is evicted.
        """
        from repro_torch.analysis.demand import DEFAULT_DEMAND, demand_transform

        dconf = demand_config if demand_config is not None else DEFAULT_DEMAND
        base = self.get(program, analysis=analysis)
        key = (
            f"{base.fingerprint}:{query_pred}^{pattern}"
            f":{analysis.fingerprint() if analysis else 'raw'}"
            f":{dconf.fingerprint()}"
        )
        if key in self._demand:
            self.hits += 1
            self._demand.move_to_end(key)
            return self._demand[key]
        self.misses += 1
        with _TRACE.span(
            "plan_cache.get_demand", "serve",
            query=f"{query_pred}^{pattern}",
        ) as sp:
            transform = demand_transform(
                base.program, query_pred, pattern, dconf,
                sizes=sizes, domain=domain,
            )
            if transform.ok:
                plan = self.get(transform.program, analysis=None)
            else:
                plan = base
            sp.set(ok=transform.ok)
        entry = (plan, transform)
        self._demand[key] = entry
        while len(self._demand) > self.capacity:
            self._demand.popitem(last=False)
        return entry

    # -- physical plans ----------------------------------------------------

    def warm(
        self,
        plan: CompiledPlan,
        domain: int,
        buckets: tuple[int, ...] = (128, 256),
        *,
        device: torch.device | str,
    ) -> int:
        """Record each (IDB arity, capacity bucket) of ``plan`` as warm on
        ``device``, where the reference pre-traces its executables.

        Eager PyTorch has no executables to prepare, so this runs no device
        work.  Returns the number of (bucket, arity) pairs newly recorded (0
        on a fully warm cache).
        """
        with _TRACE.span(
            "plan_cache.warm", "serve",
            fingerprint=plan.fingerprint, buckets=list(buckets),
        ) as sp:
            arities = {plan.strat.pred_arity(p) for p in plan.strat.idb} | {
                plan.program.arity_of(p) for p in plan.strat.edb
            }
            fresh = {
                (plan.fingerprint, bucket, arity, domain, str(torch.device(device)))
                for arity in arities
                for bucket in buckets
            } - self._warmed
            self._warmed |= fresh
            sp.set(traced=len(fresh))
            return len(fresh)

    def select(
        self, rows: torch.Tensor, where: dict[int, int | tuple[int, int]]
    ) -> tuple[torch.Tensor, int]:
        """Bound-column selection: ``(rows with matches first, count)``."""
        arity = rows.shape[1]
        lov = [0] * arity
        hiv = [0] * arity
        mask = [False] * arity
        for col, bound in where.items():
            if not 0 <= col < arity:
                raise IndexError(f"column {col} out of range for arity {arity}")
            lo, hi = bound if isinstance(bound, tuple) else (bound, bound)
            lov[col], hiv[col], mask[col] = int(lo), int(hi), True
        out, count = _select_rows(rows, lov, hiv, tuple(mask))
        return out, int(count)

    def stats(self) -> dict:
        return {
            "plans": len(self._plans),
            "demand_plans": len(self._demand),
            "hits": self.hits,
            "misses": self.misses,
            "warmed_buckets": len(self._warmed),
        }


_DEFAULT: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide cache: all instances/servers share its plans."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanCache()
    return _DEFAULT
