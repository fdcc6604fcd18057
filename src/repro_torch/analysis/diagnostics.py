"""Structured diagnostics for the Datalog static-analysis front-end.

Every finding the analyzer can produce carries a stable code (``DL...``),
a severity, a human-readable message, and — when known — the offending
rule and its source :class:`~repro_torch.core.ast.Span`.  The code catalog is
documented in ``docs/analysis.md``; codes are append-only so tools (CI
gates, editor integrations) can match on them across versions.

Severity bands:

* ``DL0xx`` — **errors**: the program is rejected at admission.
* ``DL1xx`` — **warnings**: almost certainly a bug, but evaluable.
* ``DL2xx`` — **info**: explanations (e.g. PBME eligibility).
* ``DL3xx`` — **info**: semantics-preserving rewrites that were applied.
* ``DL4xx`` — **info**: demand-transformation decisions and fallbacks
  (adornment/SIP choices, magic-set rewrite outcomes — see
  ``repro_torch.analysis.demand``).  A fallback is a *decision*, never an
  error: the query is served from the full materialization instead.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from repro_torch.core.ast import Rule, Span

ERROR = "error"
WARNING = "warning"
INFO = "info"

SEVERITIES = (ERROR, WARNING, INFO)

# Stable code catalog (append-only; see docs/analysis.md).
CODES: dict[str, str] = {
    "DL001": "syntax error",
    "DL002": "unbound head variable (unsafe rule)",
    "DL003": "unbound variable in negated atom (unsafe negation)",
    "DL004": "unbound variable in comparison (unsafe comparison)",
    "DL005": "inconsistent predicate arity",
    "DL006": "unstratifiable negation (negative cycle)",
    "DL007": "recursive aggregate that may not converge",
    "DL008": "wildcard in head position",
    "DL101": "singleton variable (occurs exactly once)",
    "DL102": "cross-product body (disconnected join graph)",
    "DL103": "unreachable rule (cannot contribute to any output)",
    "DL104": "duplicate rule (identical up to variable renaming)",
    "DL105": "subsumed rule (body is a superset of another rule's)",
    "DL106": "unsatisfiable body (always-false constraint)",
    "DL201": "PBME bit-matrix eligibility",
    "DL202": "demand-specialization eligibility",
    "DL301": "rewrite: dead rule eliminated",
    "DL302": "rewrite: duplicate rule removed",
    "DL303": "rewrite: constant folded/propagated",
    "DL304": "rewrite: body atoms reordered",
    "DL400": "demand transform applied (adornment + magic-set rewrite)",
    "DL401": "predicate ineligible for demand specialization",
    "DL402": "binding not propagated through negation",
    "DL403": "binding lost through aggregation",
    "DL404": "SIP decision (sideways information passing)",
    "DL405": "demand fallback: transform fails stratification/safety re-check",
    "DL406": "demand fallback: transform estimated unprofitable",
    "DL407": "demand fallback: binding pattern cannot seed a magic predicate",
    "DL408": "atom demanded with all-free adornment (computed in full)",
}


def severity_of(code: str) -> str:
    band = code[2] if len(code) == 5 and code.startswith("DL") else ""
    if band == "0":
        return ERROR
    if band == "1":
        return WARNING
    return INFO


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding.

    ``rule`` is excluded from equality so reports can be de-duplicated on
    (code, message, span) without hashing whole AST nodes.
    """

    code: str
    message: str
    severity: str = ""
    span: Span | None = None
    rule: Rule | None = field(default=None, compare=False)
    rule_index: int | None = None

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code}")
        if not self.severity:
            object.__setattr__(self, "severity", severity_of(self.code))
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity}")
        if self.span is None and self.rule is not None:
            object.__setattr__(self, "span", self.rule.span)

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def render(self, filename: str | None = None) -> str:
        loc = ""
        if self.span is not None:
            loc = f"{self.span.line}:{self.span.col}: "
        prefix = f"{filename}:" if filename else ""
        return f"{prefix}{loc}{self.severity}[{self.code}]: {self.message}"

    def to_dict(self) -> dict:
        d: dict = {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
        }
        if self.span is not None:
            d["line"] = self.span.line
            d["col"] = self.span.col
        if self.rule_index is not None:
            d["rule_index"] = self.rule_index
        if self.rule is not None:
            d["rule"] = repr(self.rule)
        return d

    def __repr__(self) -> str:
        return self.render()


@dataclass
class AnalysisReport:
    """Everything one analyzer run produced.

    ``rewritten`` is the semantics-preserving rewrite of ``program`` under
    the run's :class:`~repro_torch.analysis.rewrites.RewriteConfig` — ``None``
    when the program had errors (nothing safe to rewrite) or when rewrites
    were disabled.
    """

    source: str | None = None
    program: object | None = None          # Program | None (None on DL001)
    rewritten: object | None = None        # Program | None
    diagnostics: list[Diagnostic] = field(default_factory=list)
    pass_times: dict[str, float] = field(default_factory=dict)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def by_severity(self, severity: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> list[Diagnostic]:
        return self.by_severity(ERROR)

    @property
    def warnings(self) -> list[Diagnostic]:
        return self.by_severity(WARNING)

    @property
    def infos(self) -> list[Diagnostic]:
        return self.by_severity(INFO)

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> list[str]:
        return [d.code for d in self.diagnostics]

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self.diagnostics)

    def render(self, filename: str | None = None, *, min_severity: str = INFO) -> str:
        keep = {
            ERROR: (ERROR,),
            WARNING: (ERROR, WARNING),
            INFO: SEVERITIES,
        }[min_severity]
        lines = [d.render(filename) for d in self.diagnostics if d.severity in keep]
        n_err, n_warn = len(self.errors), len(self.warnings)
        lines.append(f"{n_err} error(s), {n_warn} warning(s)")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "rewritten": repr(self.rewritten) if self.rewritten is not None else None,
        }

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)
