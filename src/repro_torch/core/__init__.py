"""The RecStep engine on PyTorch.

Public API::

    from repro_torch.core import parse, Engine, EngineConfig
    program = parse("tc(x,y) :- arc(x,y). tc(x,y) :- tc(x,z), arc(z,y).")
    result = Engine(EngineConfig(), device="cuda").run(program, {"arc": edges})
"""

from repro_torch.core.ast import Atom, Rule, Program, Var, Const, Agg, Cmp
from repro_torch.core.parser import parse
from repro_torch.core.analyzer import analyze, Stratification
from repro_torch.core.engine import Engine, EngineConfig, EvalStats
from repro_torch.core.versioned_store import Snapshot, VersionedStore

__all__ = [
    "Snapshot",
    "VersionedStore",
    "Atom",
    "Rule",
    "Program",
    "Var",
    "Const",
    "Agg",
    "Cmp",
    "parse",
    "analyze",
    "Stratification",
    "Engine",
    "EngineConfig",
    "EvalStats",
]
