"""EXPLAIN: plan-time cost and cardinality estimates per rule/stratum.

The estimator mirrors the classic System R recipe over a compiled Datalog
plan: every rule body is costed as a left-deep join of its atoms under the
independence assumption — each join variable shared with the already-joined
prefix contributes a ``1/domain`` selectivity, constants and repeated
variables select ``1/domain`` within their atom, and comparison predicates
apply the textbook ``1/3`` (range) / ``1/domain`` (equality) factors.
Recursive strata run the same per-rule estimate to an *analytic* fixpoint
(iterate the size estimates until they stop growing, capped at
``domain^arity``) — a cardinality-space mirror of semi-naïve evaluation.

Everything here is duck-typed over the plan objects (``CompiledPlan`` /
``Stratification`` / ``Rule`` / ``Atom``) rather than importing them:
``repro_torch.obs`` is stdlib-only by design, and the serving layer passes its
own plan in.  The numbers are *heuristics* — their purpose is to be
compared against actuals (``repro_torch.obs.profile``), and the misestimation
ratio is itself the signal that adaptive evaluation consumes.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field


#: Selectivity of a comparison predicate, by operator (System R defaults).
_CMP_SELECTIVITY = {"<": 1 / 3, "<=": 1 / 3, ">": 1 / 3, ">=": 1 / 3}

#: Estimated semi-naïve iterations for a recursive stratum: the expected
#: diameter of a sparse random graph is O(log n), and PBME's incremental
#: frontier converges in the same order — ``est_iterations`` is
#: ``ceil(log2(domain)) + 1`` either way.
def _est_iterations(domain: int) -> int:
    return max(2, math.ceil(math.log2(max(domain, 2))) + 1)


@dataclass
class RuleEstimate:
    """Plan-time estimate for one rule: output rows and join work."""

    pred: str                       # head predicate
    rule: str                       # source form, for rendering
    est_rows: float                 # estimated derived tuples per evaluation
    est_cost: float                 # sum of intermediate join cardinalities
    inputs: dict[str, float] = field(default_factory=dict)  # body pred → size used

    def to_json(self) -> dict:
        return {
            "pred": self.pred,
            "rule": self.rule,
            "est_rows": self.est_rows,
            "est_cost": self.est_cost,
            "inputs": dict(self.inputs),
        }


@dataclass
class StratumEstimate:
    """Plan-time estimate for one stratum of the evaluation order."""

    index: int
    preds: tuple[str, ...]
    mode: str                       # predicted evaluation mode
    recursive: bool
    est_iterations: int
    est_rows: float                 # estimated tuples the stratum derives
    est_cost: float
    rules: list[RuleEstimate] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "preds": list(self.preds),
            "mode": self.mode,
            "recursive": self.recursive,
            "est_iterations": self.est_iterations,
            "est_rows": self.est_rows,
            "est_cost": self.est_cost,
            "rules": [r.to_json() for r in self.rules],
        }


@dataclass
class PlanEstimate:
    """The annotated plan tree ``srv.explain()`` returns.

    ``sizes`` holds the relation cardinalities the estimate was computed
    from (EDB actuals plus estimated IDB sizes); ``actuals``, when the plan
    is materialized, the current true IDB counts — the renderer shows both
    so a glance reveals where the heuristics are wrong.
    """

    fingerprint: str
    domain: int
    sizes: dict[str, float] = field(default_factory=dict)
    strata: list[StratumEstimate] = field(default_factory=list)
    actuals: dict[str, int] = field(default_factory=dict)

    def stratum(self, index: int) -> StratumEstimate | None:
        for s in self.strata:
            if s.index == index:
                return s
        return None

    def est_rows_for(self, pred: str) -> float:
        return self.sizes.get(pred, 0.0)

    def total_cost(self) -> float:
        return sum(s.est_cost for s in self.strata)

    def scaled_delta(self, delta_rows: dict[str, float]) -> dict[int, float]:
        """First-order delta estimate per stratum for an incremental update.

        An update that changes ``delta_rows[rel]`` tuples of its inputs is
        expected to re-derive roughly the same *fraction* of each dependent
        stratum's rows (the linearization the FlowLog operators assume):
        ``est_delta = est_rows × max_rel(Δrel / |rel|)``.  Strata none of
        whose inputs changed get no entry.
        """
        out: dict[int, float] = {}
        changed = dict(delta_rows)
        for s in self.strata:
            refs = {p for r in s.rules for p in r.inputs}
            touched = refs & set(changed)
            if not touched:
                continue
            frac = max(
                changed[p] / max(self.sizes.get(p, 1.0), 1.0) for p in touched
            )
            est = s.est_rows * min(frac, 1.0)
            out[s.index] = est
            # the stratum's own output becomes a changed input downstream
            for p in s.preds:
                changed[p] = max(changed.get(p, 0.0), est)
        return out

    # -- renderers ---------------------------------------------------------

    def render_text(self) -> str:
        """Annotated plan tree, one line per stratum/rule."""
        lines = [
            f"plan {self.fingerprint} domain={self.domain} "
            f"est_cost={_fmt(self.total_cost())}"
        ]
        for i, s in enumerate(self.strata):
            last_s = i == len(self.strata) - 1
            tag = "recursive" if s.recursive else "base"
            iters = f" est_iters≈{s.est_iterations}" if s.recursive else ""
            act = ""
            acts = [self.actuals[p] for p in s.preds if p in self.actuals]
            if acts:
                act = f" act={sum(acts)}"
            lines.append(
                f"{'└─' if last_s else '├─'} stratum {s.index} "
                f"[{s.mode}, {tag}]{iters} "
                f"est_rows≈{_fmt(s.est_rows)}{act} cost≈{_fmt(s.est_cost)}"
            )
            bar = "   " if last_s else "│  "
            for j, r in enumerate(s.rules):
                last_r = j == len(s.rules) - 1
                inputs = " ".join(
                    f"{k}={_fmt(v)}" for k, v in sorted(r.inputs.items())
                )
                lines.append(
                    f"{bar}{'└─' if last_r else '├─'} {r.rule}  "
                    f"est≈{_fmt(r.est_rows)} [{inputs}]"
                )
        return "\n".join(lines)

    def to_json(self) -> dict:
        doc = {
            "fingerprint": self.fingerprint,
            "domain": self.domain,
            "sizes": dict(self.sizes),
            "est_cost": self.total_cost(),
            "strata": [s.to_json() for s in self.strata],
        }
        if self.actuals:
            doc["actuals"] = dict(self.actuals)
        json.dumps(doc)       # the contract: always JSON-serialisable
        return doc


def _fmt(v: float) -> str:
    if v != v or v in (float("inf"), float("-inf")):
        return str(v)
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.3g}"


def _term_names(atom) -> list[str | None]:
    """Variable name per atom position (None for constants/wildcards)."""
    out: list[str | None] = []
    for t in atom.terms:
        name = getattr(t, "name", None)
        out.append(name if name and name != "_" else None)
    return out


def estimate_rule(rule, sizes: dict[str, float], domain: int) -> RuleEstimate:
    """Left-deep join estimate for one rule body (independence assumption)."""
    d = max(float(domain), 1.0)
    bound: set[str] = set()
    card = 1.0
    cost = 0.0
    inputs: dict[str, float] = {}
    for atom in rule.atoms:
        size = max(float(sizes.get(atom.pred, d)), 0.0)
        inputs[atom.pred] = size
        if atom.negated:
            # anti-join: keep the prefix cardinality (an upper bound — a
            # tighter estimate needs the negated relation's density)
            continue
        names = _term_names(atom)
        sel = 1.0
        seen: set[str] = set()
        for name in names:
            if name is None:
                sel /= d            # constant: one of ``domain`` values
            elif name in seen:
                sel /= d            # repeated var within the atom
            else:
                seen.add(name)
        join_vars = seen & bound
        card = card * size * sel / (d ** len(join_vars))
        bound |= seen
        cost += card                # work ∝ intermediate result sizes
    for cmp_ in getattr(rule, "comparisons", ()):
        op = getattr(cmp_, "op", None)
        if op == "==":
            card /= d
        elif op == "!=":
            card *= 1.0 - 1.0 / d
        else:
            card *= _CMP_SELECTIVITY.get(op, 1.0)
    head_arity = len(rule.head_terms)
    card = min(max(card, 0.0), d ** head_arity)    # projection/distinct cap
    return RuleEstimate(
        pred=rule.head_pred,
        rule=repr(rule),
        est_rows=card,
        est_cost=max(cost, card),
        inputs=inputs,
    )


def estimate_plan(
    plan,
    sizes: dict[str, float] | None = None,
    domain: int = 0,
    modes: dict[int, str] | None = None,
    actuals: dict[str, int] | None = None,
    max_rounds: int = 16,
) -> PlanEstimate:
    """Estimate every rule/stratum of a compiled plan.

    ``plan`` duck-types ``CompiledPlan`` (``fingerprint``, ``strat`` with
    ``strata``/``pred_arity``); ``sizes`` maps relation → row count (EDB
    actuals — unknown relations default to ``domain``); ``modes`` maps
    stratum index → predicted evaluation mode (``bitmatrix``/``tuple``/
    ``dense_set``/``dense_agg``; defaults to ``tuple``).  Strata are
    processed in evaluation order so upstream IDB estimates feed
    downstream rules.
    """
    strat = plan.strat
    if domain <= 0:
        domain = max(
            [1] + [int(v) for v in (sizes or {}).values() if v == v]
        )
    d = max(float(domain), 1.0)
    est_sizes: dict[str, float] = {
        k: float(v) for k, v in (sizes or {}).items()
    }
    modes = modes or {}
    out = PlanEstimate(
        fingerprint=getattr(plan, "fingerprint", "?"),
        domain=int(domain),
        actuals=dict(actuals or {}),
    )
    for stratum in strat.strata:
        cap = {
            p: d ** strat.pred_arity(p) for p in stratum.preds
        }
        # seed this stratum's preds at 0 — rules referencing them before
        # any estimate exists (recursion) see the running estimate
        for p in stratum.preds:
            est_sizes.setdefault(p, 0.0)
        rule_ests: list[RuleEstimate] = []
        rounds = max_rounds if stratum.recursive else 1
        for _ in range(rounds):
            rule_ests = [
                estimate_rule(r, est_sizes, domain) for r in stratum.rules
            ]
            grew = False
            for p in stratum.preds:
                new = min(
                    sum(e.est_rows for e in rule_ests if e.pred == p), cap[p]
                )
                if new > est_sizes[p] * 1.01 + 1e-9:
                    grew = True
                est_sizes[p] = max(est_sizes[p], new)
            if not grew:
                break
        est_rows = sum(est_sizes[p] for p in stratum.preds)
        out.strata.append(
            StratumEstimate(
                index=stratum.index,
                preds=tuple(stratum.preds),
                mode=modes.get(stratum.index, "tuple"),
                recursive=bool(stratum.recursive),
                est_iterations=(
                    _est_iterations(int(domain)) if stratum.recursive else 1
                ),
                est_rows=est_rows,
                est_cost=sum(e.est_cost for e in rule_ests)
                * (_est_iterations(int(domain)) if stratum.recursive else 1),
                rules=rule_ests,
            )
        )
    out.sizes = est_sizes
    return out


def estimate_query_rows(
    table_rows: float, domain: int, bounds: dict[int, object] | None
) -> float:
    """Selection-cardinality estimate for one point/range query.

    Point bounds select ``1/domain`` of the table; range bounds
    ``(hi - lo + 1)/domain`` — the uniform-distribution assumption.
    """
    d = max(float(domain), 1.0)
    est = max(float(table_rows), 0.0)
    for bound in (bounds or {}).values():
        if isinstance(bound, tuple):
            lo, hi = bound
            est *= min(max(float(hi) - float(lo) + 1.0, 0.0) / d, 1.0)
        else:
            est /= d
    return est
