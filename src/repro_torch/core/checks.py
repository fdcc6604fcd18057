"""Program-level safety and arity checks behind ``Program.validate``.

Each check returns coded :class:`Diagnostic` records in the order the
reference front end emits them, so ``Rule.check_safety`` and
``Program.validate`` raise the same first ``ValueError`` message.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.ast import Program, Rule, Var


@dataclass(frozen=True)
class Diagnostic:
    code: str
    message: str


def rule_safety_diagnostics(rule: Rule) -> list[Diagnostic]:
    """Range restriction / safety for one rule: DL008, DL002, DL003, DL004.

    Order: head wildcards, unbound head vars, negated atoms, comparisons.
    """
    out: list[Diagnostic] = []
    bound = {v for a in rule.positive_atoms for v in a.vars()}
    for t in rule.head_terms:
        if isinstance(t, Var) and t.name == "_":
            out.append(
                Diagnostic("DL008", f"unsafe rule (wildcard _ in head position): {rule}")
            )
    for v in rule.head_vars():
        if v.name != "_" and v not in bound:
            out.append(
                Diagnostic("DL002", f"unsafe rule (head var {v} unbound): {rule}")
            )
    for a in rule.atoms:
        if a.negated:
            for v in a.vars():
                if v not in bound:
                    out.append(
                        Diagnostic("DL003", f"unsafe negation (var {v} unbound): {rule}")
                    )
    for c in rule.comparisons:
        for v in c.vars():
            if v not in bound:
                out.append(
                    Diagnostic("DL004", f"unsafe comparison (var {v} unbound): {rule}")
                )
    return out


def arity_diagnostics(program: Program) -> list[Diagnostic]:
    """DL005: every predicate used with one arity everywhere.

    Per rule: body atoms first, then the head.
    """
    out: list[Diagnostic] = []
    arities: dict[str, int] = {}
    for r in program.rules:
        for a in r.atoms:
            if arities.setdefault(a.pred, a.arity) != a.arity:
                out.append(
                    Diagnostic("DL005", f"arity mismatch for {a.pred}")
                )
        ha = len(r.head_terms)
        if arities.setdefault(r.head_pred, ha) != ha:
            out.append(
                Diagnostic("DL005", f"arity mismatch for {r.head_pred}")
            )
    return out
