"""Analysis passes: safety/arity/stratification errors and lint warnings.

This module is the *single source of truth* for the program-level checks.
``repro_torch.core.ast`` keeps its historical raise-on-first-error API
(``Rule.check_safety`` / ``Program.validate``) as thin compat shims over
the error passes here, so the engine and the diagnostics front-end can
never disagree about what is valid.

Every pass is a pure function ``Program -> list[Diagnostic]`` (or
``Rule -> list[Diagnostic]`` for the per-rule safety pass) with no
side effects; the orchestrator in :mod:`repro_torch.analysis.linter` times and
sequences them.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.analyzer import (
    dependency_edges,
    dependency_graph,
    negative_cycle_witness,
    strongly_connected_components,
)
from repro_torch.core.ast import Agg, Atom, Const, Program, Rule, Var

# --------------------------------------------------------------------------
# error passes (DL0xx) — mirrored by the ast.py compat shims
# --------------------------------------------------------------------------


def rule_safety_diagnostics(rule: Rule, rule_index: int | None = None) -> list[Diagnostic]:
    """Range restriction / safety for one rule: DL008, DL002, DL003, DL004.

    Emission order matches the historical ``check_safety`` raise order
    (head vars, then negated atoms, then comparisons) so the compat shim
    raises the same first message it always did.
    """
    out: list[Diagnostic] = []
    bound = {v for a in rule.positive_atoms for v in a.vars()}
    for t in rule.head_terms:
        if isinstance(t, Var) and t.name == "_":
            out.append(
                Diagnostic(
                    "DL008",
                    f"unsafe rule (wildcard _ in head position): {rule}",
                    rule=rule,
                    rule_index=rule_index,
                )
            )
    for v in rule.head_vars():
        if v.name != "_" and v not in bound:
            out.append(
                Diagnostic(
                    "DL002",
                    f"unsafe rule (head var {v} unbound): {rule}",
                    rule=rule,
                    rule_index=rule_index,
                )
            )
    for a in rule.atoms:
        if a.negated:
            for v in a.vars():
                if v not in bound:
                    out.append(
                        Diagnostic(
                            "DL003",
                            f"unsafe negation (var {v} unbound): {rule}",
                            span=a.span or rule.span,
                            rule=rule,
                            rule_index=rule_index,
                        )
                    )
    for c in rule.comparisons:
        for v in c.vars():
            if v not in bound:
                out.append(
                    Diagnostic(
                        "DL004",
                        f"unsafe comparison (var {v} unbound): {rule}",
                        span=c.span or rule.span,
                        rule=rule,
                        rule_index=rule_index,
                    )
                )
    return out


def safety_diagnostics(program: Program) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        out.extend(rule_safety_diagnostics(r, rule_index=i))
    return out


def arity_diagnostics(program: Program) -> list[Diagnostic]:
    """DL005: every predicate used with one arity everywhere.

    Iteration order (per rule: body atoms, then head) matches the
    historical ``Program.validate`` so the compat shim raises the same
    first message.
    """
    out: list[Diagnostic] = []
    arities: dict[str, int] = {}
    for i, r in enumerate(program.rules):
        for a in r.atoms:
            if arities.setdefault(a.pred, a.arity) != a.arity:
                out.append(
                    Diagnostic(
                        "DL005",
                        f"arity mismatch for {a.pred}",
                        span=a.span or r.span,
                        rule=r,
                        rule_index=i,
                    )
                )
        ha = len(r.head_terms)
        if arities.setdefault(r.head_pred, ha) != ha:
            out.append(
                Diagnostic(
                    "DL005",
                    f"arity mismatch for {r.head_pred}",
                    rule=r,
                    rule_index=i,
                )
            )
    return out


def stratification_diagnostics(program: Program) -> list[Diagnostic]:
    """DL006 (negation inside an SCC, with the negative cycle as witness)
    and DL007 (recursive non-MIN/MAX aggregate).  Message text matches the
    ``analyzer.analyze`` raises."""
    index = {id(r): i for i, r in enumerate(program.rules)}
    edges = dependency_edges(program)
    out: list[Diagnostic] = []
    # SCC order does not show: the diagnostics are sorted by (rule, code)
    for comp in strongly_connected_components(dependency_graph(program)):
        pred_set = set(comp)
        rules = [r for r in program.rules if r.head_pred in pred_set]
        recursive = any(a.pred in pred_set for r in rules for a in r.atoms)
        for r in rules:
            for a in r.atoms:
                if a.negated and a.pred in pred_set:
                    witness = negative_cycle_witness(edges, r.head_pred, a.pred)
                    out.append(
                        Diagnostic(
                            "DL006",
                            f"unstratifiable negation: {a.pred} negated "
                            f"within its own stratum in rule {r} "
                            f"(negative cycle: {witness})",
                            span=a.span or r.span,
                            rule=r,
                            rule_index=index[id(r)],
                        )
                    )
        if recursive:
            for r in rules:
                for t in r.head_terms:
                    if isinstance(t, Agg) and t.op not in ("MIN", "MAX"):
                        out.append(
                            Diagnostic(
                                "DL007",
                                f"recursive aggregate {t.op} unsupported "
                                f"(only MIN/MAX converge unconditionally): {r}",
                                rule=r,
                                rule_index=index[id(r)],
                            )
                        )
    out.sort(key=lambda d: (d.rule_index if d.rule_index is not None else 0, d.code))
    return out


# --------------------------------------------------------------------------
# lint passes (DL1xx)
# --------------------------------------------------------------------------


def singleton_diagnostics(program: Program) -> list[Diagnostic]:
    """DL101: a named variable that occurs exactly once in its rule.

    A body-only singleton joins nothing and projects nothing — it is a
    wildcard spelled like a variable, which usually means a typo'd join.
    """
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        counts: dict[str, int] = {}

        def bump(v: Var) -> None:
            if v.name != "_":
                counts[v.name] = counts.get(v.name, 0) + 1

        for t in r.head_terms:
            if isinstance(t, Var):
                bump(t)
            elif isinstance(t, Agg):
                for v in t.arg.vars:
                    bump(v)
        for b in r.body:
            if isinstance(b, Atom):
                for t in b.terms:
                    if isinstance(t, Var):
                        bump(t)
            else:
                for t in (b.lhs, b.rhs):
                    if isinstance(t, Var):
                        bump(t)
        for name, n in counts.items():
            if n == 1:
                out.append(
                    Diagnostic(
                        "DL101",
                        f"variable {name} occurs only once in rule: {r} "
                        "(replace with `_` if intentional)",
                        rule=r,
                        rule_index=i,
                    )
                )
    return out


def cross_product_diagnostics(program: Program) -> list[Diagnostic]:
    """DL102: positive body atoms whose variable-sharing graph is
    disconnected — the join degenerates to a Cartesian product."""
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        atoms = r.positive_atoms
        if len(atoms) < 2:
            continue
        # union-find over the atoms: an edge where two share a variable
        parent = list(range(len(atoms)))

        def root(j: int) -> int:
            while parent[j] != j:
                parent[j] = parent[parent[j]]
                j = parent[j]
            return j

        for j, a in enumerate(atoms):
            for k in range(j + 1, len(atoms)):
                if set(a.vars()) & set(atoms[k].vars()):
                    parent[root(j)] = root(k)
        ncomp = sum(1 for j in range(len(atoms)) if root(j) == j)
        if ncomp > 1:
            out.append(
                Diagnostic(
                    "DL102",
                    f"cross-product body ({ncomp} disconnected atom groups): {r}",
                    rule=r,
                    rule_index=i,
                )
            )
    return out


def _needed_preds(program: Program, outputs: Iterable[str]) -> set[str]:
    """Backward closure of ``outputs`` over rule dependencies."""
    needed = set(outputs)
    changed = True
    while changed:
        changed = False
        for r in program.rules:
            if r.head_pred in needed:
                for a in r.atoms:
                    if a.pred not in needed:
                        needed.add(a.pred)
                        changed = True
    return needed


def unreachable_diagnostics(
    program: Program, outputs: Iterable[str] | None
) -> list[Diagnostic]:
    """DL103: rules whose head cannot contribute to any requested output.

    Only meaningful with an explicit output set — a served program answers
    queries against *any* IDB, so without ``outputs`` every rule is live.
    """
    if not outputs:
        return []
    needed = _needed_preds(program, outputs)
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        if r.head_pred not in needed:
            out.append(
                Diagnostic(
                    "DL103",
                    f"rule unreachable from outputs "
                    f"{sorted(set(outputs))}: {r}",
                    rule=r,
                    rule_index=i,
                )
            )
    return out


def canonical_rule(rule: Rule) -> tuple:
    """Structural key of a rule with variables renamed by first occurrence.

    Two rules with equal keys are identical up to variable renaming
    (spans never participate).  Wildcards all map to ``_`` — they never
    unify, so their identity is irrelevant.
    """
    mapping: dict[str, str] = {}

    def ren(v: Var) -> str:
        if v.name == "_":
            return "_"
        return mapping.setdefault(v.name, f"v{len(mapping)}")

    def term(t) -> tuple:
        if isinstance(t, Var):
            return ("v", ren(t))
        if isinstance(t, Const):
            return ("c", t.value)
        assert isinstance(t, Agg)
        return ("agg", t.op, tuple(ren(v) for v in t.arg.vars), t.arg.const)

    head = (rule.head_pred, tuple(term(t) for t in rule.head_terms))
    body: list[tuple] = []
    for b in rule.body:
        if isinstance(b, Atom):
            body.append(("atom", b.pred, b.negated, tuple(term(t) for t in b.terms)))
        else:
            body.append(("cmp", b.op, term(b.lhs), term(b.rhs)))
    return (head, tuple(body))


def duplicate_diagnostics(program: Program) -> list[Diagnostic]:
    """DL104: a rule textually identical (up to variable renaming) to an
    earlier one."""
    seen: dict[tuple, int] = {}
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        key = canonical_rule(r)
        if key in seen:
            out.append(
                Diagnostic(
                    "DL104",
                    f"duplicate of rule #{seen[key]}: {r}",
                    rule=r,
                    rule_index=i,
                )
            )
        else:
            seen[key] = i
    return out


def subsumed_diagnostics(program: Program) -> list[Diagnostic]:
    """DL105: rule A whose body is a strict superset of rule B's (same
    canonical head) — every A-derivation is already a B-derivation.

    Purely syntactic under per-rule canonical renaming, hence
    conservative: it misses subsumptions that need a non-identity variable
    mapping, and never false-positives.
    """
    keys = [canonical_rule(r) for r in program.rules]
    out: list[Diagnostic] = []
    for i, (hi, bi) in enumerate(keys):
        body_i = set(bi)
        if len(body_i) != len(bi):
            continue  # repeated body items: set view would be lossy
        for j, (hj, bj) in enumerate(keys):
            if i == j or hi != hj:
                continue
            body_j = set(bj)
            if body_j < body_i:
                out.append(
                    Diagnostic(
                        "DL105",
                        f"rule subsumed by more general rule #{j}: "
                        f"{program.rules[i]}",
                        rule=program.rules[i],
                        rule_index=i,
                    )
                )
                break
    return out


_CMP_EVAL = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def unsatisfiable_reason(rule: Rule) -> str | None:
    """Why the rule's body can never hold, or ``None`` if it might."""
    for c in rule.comparisons:
        if isinstance(c.lhs, Const) and isinstance(c.rhs, Const):
            if not _CMP_EVAL[c.op](c.lhs.value, c.rhs.value):
                return f"comparison {c} is always false"
        elif c.lhs == c.rhs and c.op in ("!=", "<", ">"):
            return f"comparison {c} is always false"
    pos = {(a.pred, a.terms) for a in rule.positive_atoms}
    for a in rule.atoms:
        if a.negated and (a.pred, a.terms) in pos:
            return f"body requires both {a.pred}{a.terms!r} and its negation"
    return None


def unsatisfiable_diagnostics(program: Program) -> list[Diagnostic]:
    """DL106: bodies containing an always-false constraint."""
    out: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        reason = unsatisfiable_reason(r)
        if reason is not None:
            out.append(
                Diagnostic(
                    "DL106",
                    f"unsatisfiable body ({reason}): {r}",
                    rule=r,
                    rule_index=i,
                )
            )
    return out


# --------------------------------------------------------------------------
# explainers (DL2xx)
# --------------------------------------------------------------------------


def pbme_diagnostics(program: Program, engine_config=None) -> list[Diagnostic]:
    """DL201: per-stratum PBME bit-matrix eligibility with the reason.

    Uses :func:`repro_torch.core.bitmatrix.explain_eligibility` — the exact gate
    the engine applies — with the memory gate skipped (``domain=None``;
    static analysis runs before any data exists).  Requires a valid
    program (call only when there are no DL0xx errors).
    """
    from repro_torch.core.analyzer import analyze
    from repro_torch.core.bitmatrix import explain_eligibility
    from repro_torch.core.engine import EngineConfig

    config = engine_config if engine_config is not None else EngineConfig()
    index = {id(r): i for i, r in enumerate(program.rules)}
    out: list[Diagnostic] = []
    for stratum in analyze(program).strata:
        plan, reason = explain_eligibility(stratum, None, config)
        verdict = "eligible" if plan is not None else "not eligible"
        rule = stratum.rules[0]
        out.append(
            Diagnostic(
                "DL201",
                f"stratum {stratum.index} ({', '.join(stratum.preds)}): "
                f"{verdict} for PBME bit-matrix evaluation — {reason}",
                rule=rule,
                rule_index=index.get(id(rule)),
            )
        )
    return out
