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

**Admission.**  The reference admits programs through its static analyzer
with semantics-preserving rewrites by default.  That analyzer is not ported
yet (ROADMAP.md item A9), so the port admits by validation alone — the
reference's ``analysis=None`` — and that is its default; any other
``analysis`` raises ``NotImplementedError``.  The rewrites preserve every IDB
bit for bit, so the relations equal the reference's under its default.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from repro_torch.core.analyzer import Stratification, analyze
from repro_torch.core.ast import Program
from repro_torch.core.seminaive import RuleVariant, delta_variants
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL
from repro_torch.serve_datalog.errors import RequestError

#: Where admission analysis, lint and demand specialization are queued.
ANALYSIS_ITEM = (
    "the static analyzer (admission rewrites, lint, demand transformation) is "
    "not ported yet: ROADMAP.md item A9"
)


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
    """Logical plan: everything derivable from the program text alone (the
    reference's admission ``report`` waits for the analyzer, item A9)."""

    fingerprint: str
    program: Program
    strat: Stratification
    delta_groups: list[dict[str, list[RuleVariant]]] = field(repr=False)

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
        # (fp, bucket, arity, domain, device): the reference keys by the
        # first four; the device keeps a CPU warm-up from counting for CUDA
        self._warmed: set[tuple[str, int, int, int, str]] = set()
        self.hits = 0
        self.misses = 0

    # -- logical plans -----------------------------------------------------

    def get(self, program: Program | str, analysis=None) -> CompiledPlan:
        """Admit ``program``: parse, validate, stratify, cache.

        ``analysis`` must be ``None`` (validate-only admission, the
        reference's ``analysis=None``): the analyzer is not ported yet.
        ``ValueError`` from validation surfaces as a structured
        :class:`RequestError`.
        """
        if analysis is not None:
            raise NotImplementedError(ANALYSIS_ITEM)
        with _TRACE.span("plan_cache.get", "serve") as sp:
            if isinstance(program, str):
                from repro_torch.core.parser import DatalogSyntaxError, parse

                try:
                    program = parse(program, validate=False)
                except DatalogSyntaxError as e:
                    raise RequestError(
                        -1, f"program rejected: {e.args[0]}"
                    ) from e
            fp = fingerprint(program)
            key = f"{fp}:raw"
            if key in self._plans:
                self.hits += 1
                self._plans.move_to_end(key)
                sp.set(fingerprint=fp, hit=True)
                return self._plans[key]
            self.misses += 1
            sp.set(fingerprint=fp, hit=False)
            try:
                strat = analyze(program)
            except ValueError as e:
                raise RequestError(-1, f"program rejected: {e}") from e
            plan = CompiledPlan(
                fp, program, strat, [delta_variants(s) for s in strat.strata]
            )
            self._plans[key] = plan
            while len(self._plans) > self.capacity:
                self._plans.popitem(last=False)
            return plan

    def get_demand(self, *args, **kwargs):
        """Demand-specialized plans need the port's demand transformation."""
        raise NotImplementedError(ANALYSIS_ITEM)

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
            "demand_plans": 0,
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
