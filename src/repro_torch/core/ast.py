"""Datalog AST: terms, atoms, rules, programs (paper §3).

Supports the paper's full language fragment: positive Datalog, stratified
negation, aggregation (MIN/MAX/SUM/COUNT/AVG) in heads — including
*recursive* aggregation — plus comparison predicates (``x != y``) and
arithmetic inside aggregate arguments (``MIN(d1+d2)``, SSSP).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    """Source location (1-based line/col) of a rule or body item.

    Attached by the parser; never part of equality/hash/repr, so two
    occurrences of the same rule at different locations still compare (and
    fingerprint) identically.
    """

    line: int
    col: int

    def __repr__(self) -> str:
        return f"{self.line}:{self.col}"


@dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Const:
    value: int

    def __repr__(self) -> str:
        return str(self.value)


Term = Var | Const

WILDCARD = Var("_")

AGG_OPS = ("MIN", "MAX", "SUM", "COUNT", "AVG")
CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class Expr:
    """Linear integer expression: sum of vars + constant (``d1+d2``, ``0``)."""

    vars: tuple[Var, ...] = ()
    const: int = 0

    def __repr__(self) -> str:
        parts = [v.name for v in self.vars]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)


@dataclass(frozen=True)
class Agg:
    """Aggregate head term, e.g. ``MIN(d1+d2)`` or ``COUNT(y)``."""

    op: str
    arg: Expr

    def __post_init__(self) -> None:
        if self.op not in AGG_OPS:
            raise ValueError(f"unknown aggregate {self.op}")

    def __repr__(self) -> str:
        return f"{self.op}({self.arg})"


HeadTerm = Var | Const | Agg


@dataclass(frozen=True)
class Atom:
    """``R(t1, ..., tk)``; ``negated`` marks ``!R(...)`` body atoms."""

    pred: str
    terms: tuple[Term, ...]
    negated: bool = False
    span: Span | None = field(default=None, compare=False)

    @property
    def arity(self) -> int:
        return len(self.terms)

    def vars(self) -> tuple[Var, ...]:
        seen: dict[Var, None] = {}
        for t in self.terms:
            if isinstance(t, Var) and t is not WILDCARD and t.name != "_":
                seen.setdefault(t)
        return tuple(seen)

    def __repr__(self) -> str:
        neg = "!" if self.negated else ""
        return f"{neg}{self.pred}({', '.join(map(repr, self.terms))})"


@dataclass(frozen=True)
class Cmp:
    """Comparison predicate between two terms, e.g. ``x != y``."""

    op: str
    lhs: Term
    rhs: Term
    span: Span | None = field(default=None, compare=False)

    def __post_init__(self) -> None:
        if self.op not in CMP_OPS:
            raise ValueError(f"unknown comparison {self.op}")

    def vars(self) -> tuple[Var, ...]:
        return tuple(t for t in (self.lhs, self.rhs) if isinstance(t, Var))

    def __repr__(self) -> str:
        return f"{self.lhs} {self.op} {self.rhs}"


BodyItem = Atom | Cmp


@dataclass(frozen=True)
class Rule:
    head_pred: str
    head_terms: tuple[HeadTerm, ...]
    body: tuple[BodyItem, ...]
    span: Span | None = field(default=None, compare=False)

    @property
    def atoms(self) -> tuple[Atom, ...]:
        return tuple(b for b in self.body if isinstance(b, Atom))

    @property
    def comparisons(self) -> tuple[Cmp, ...]:
        return tuple(b for b in self.body if isinstance(b, Cmp))

    @property
    def positive_atoms(self) -> tuple[Atom, ...]:
        return tuple(a for a in self.atoms if not a.negated)

    @property
    def has_aggregate(self) -> bool:
        return any(isinstance(t, Agg) for t in self.head_terms)

    def head_vars(self) -> tuple[Var, ...]:
        out: dict[Var, None] = {}
        for t in self.head_terms:
            if isinstance(t, Var):
                out.setdefault(t)
            elif isinstance(t, Agg):
                for v in t.arg.vars:
                    out.setdefault(v)
        return tuple(out)

    def check_safety(self) -> None:
        """All head vars (and negated/comparison vars) bound by positive atoms.

        The checks live in :mod:`repro_torch.core.checks` as coded
        diagnostics (DL002/DL003/DL004/DL008); this method raises a
        ``ValueError`` with the first error diagnostic's message.
        """
        from repro_torch.core.checks import rule_safety_diagnostics

        for diag in rule_safety_diagnostics(self):
            raise ValueError(diag.message)

    def __repr__(self) -> str:
        head = f"{self.head_pred}({', '.join(map(repr, self.head_terms))})"
        return f"{head} :- {', '.join(map(repr, self.body))}."


@dataclass
class Program:
    rules: list[Rule] = field(default_factory=list)

    @property
    def idb_preds(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.rules:
            seen.setdefault(r.head_pred)
        return list(seen)

    @property
    def edb_preds(self) -> list[str]:
        idb = set(self.idb_preds)
        seen: dict[str, None] = {}
        for r in self.rules:
            for a in r.atoms:
                if a.pred not in idb:
                    seen.setdefault(a.pred)
        return list(seen)

    def arity_of(self, pred: str) -> int:
        for r in self.rules:
            if r.head_pred == pred:
                # aggregate heads: stored arity is number of head terms
                return len(r.head_terms)
            for a in r.atoms:
                if a.pred == pred:
                    return a.arity
        raise KeyError(pred)

    def validate(self) -> None:
        """Raise ``ValueError`` on the first safety or arity violation.

        Raises on the first coded diagnostic of
        :mod:`repro_torch.core.checks` (see :meth:`Rule.check_safety`).
        """
        for r in self.rules:
            r.check_safety()
        from repro_torch.core.checks import arity_diagnostics

        for diag in arity_diagnostics(self):
            raise ValueError(diag.message)

    def __repr__(self) -> str:
        return "\n".join(map(repr, self.rules))
