"""Static-analysis front-end for the Datalog engine.

Three layers over the :mod:`repro_torch.core` AST:

1. **Diagnostics** (:mod:`repro_torch.analysis.diagnostics`) — structured
   findings with stable ``DL...`` codes, severities, and source spans.
2. **Passes** (:mod:`repro_torch.analysis.passes`) — safety/arity/
   stratification errors (the single source of truth behind
   ``Program.validate``) plus lint warnings and the PBME explainer.
3. **Rewrites** (:mod:`repro_torch.analysis.rewrites`) — semantics-preserving
   program transformations (dead-rule elimination, dedup, constant
   folding, join reordering), verified bit-for-bit against the
   unoptimized fixpoint.
4. **Demand transformation** (:mod:`repro_torch.analysis.demand`) — adornment
   under a configurable SIP strategy plus the magic-set rewrite, turning
   bound queries into specialized programs that derive only the demanded
   slice; unsupported shapes fall back with coded ``DL4xx`` diagnostics.

``python -m repro_torch.analysis file.dl`` runs the linter from the command
line (``--adorn pred^bf`` prints the adorned + magic program); the
serving layer runs :func:`analyze_program` at admission (see
``repro_torch.serve_datalog.plan_cache``).
"""

from repro_torch.analysis.demand import (
    DEFAULT_DEMAND,
    AdornedRule,
    DemandConfig,
    DemandTransform,
    adorn_program,
    demand_diagnostics,
    demand_transform,
)
from repro_torch.analysis.diagnostics import (
    CODES,
    ERROR,
    INFO,
    WARNING,
    AnalysisReport,
    Diagnostic,
)
from repro_torch.analysis.linter import (
    DEFAULT_CONFIG,
    AnalysisConfig,
    analyze_program,
    lint_program,
)
from repro_torch.analysis.rewrites import (
    DEFAULT_REWRITES,
    NO_REWRITES,
    RewriteConfig,
    rewrite_program,
    verify_rewrite,
)

__all__ = [
    "AdornedRule",
    "AnalysisConfig",
    "AnalysisReport",
    "CODES",
    "DEFAULT_CONFIG",
    "DEFAULT_DEMAND",
    "DEFAULT_REWRITES",
    "DemandConfig",
    "DemandTransform",
    "Diagnostic",
    "ERROR",
    "INFO",
    "NO_REWRITES",
    "RewriteConfig",
    "WARNING",
    "adorn_program",
    "analyze_program",
    "demand_diagnostics",
    "demand_transform",
    "lint_program",
    "rewrite_program",
    "verify_rewrite",
]
