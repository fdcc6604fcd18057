"""Semantics-preserving program rewrites.

Each rewrite is independently flaggable via :class:`RewriteConfig` and
reports what it did as ``DL3xx`` info diagnostics.  The pipeline order is
fixed — fold → dedup → dead → reorder — because folding can expose
duplicates, and both can expose dead rules; the whole pipeline is
idempotent (``rewrite(rewrite(p)) == rewrite(p)``), which the serving
layer relies on: plan fingerprints are taken over the *rewritten* program,
so re-admitting a rewritten program round-trips to the same fingerprint
(snapshot/warm-start compatibility).

Soundness invariant, enforced by the hypothesis property in
``tests/test_analysis_rewrites.py``: for any EDB, the fixpoint of the
rewritten program is bit-for-bit identical to the original's on every
original IDB predicate (a predicate whose rules were all eliminated is
read as empty).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.passes import (
    _needed_preds,
    canonical_rule,
    unsatisfiable_reason,
)
from repro_torch.core.ast import Agg, Atom, Cmp, Const, Expr, Program, Rule, Var


@dataclass(frozen=True)
class RewriteConfig:
    """Which rewrites run; all on by default.

    ``outputs`` gates *reachability-based* dead-rule elimination: without
    an explicit output set every IDB predicate is queryable (the serving
    default), so only unsatisfiable rules are dead.
    """

    fold_constants: bool = True
    dedup: bool = True
    dead_rules: bool = True
    reorder: bool = True
    outputs: tuple[str, ...] | None = None

    def fingerprint(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()[:8]


DEFAULT_REWRITES = RewriteConfig()
NO_REWRITES = RewriteConfig(
    fold_constants=False, dedup=False, dead_rules=False, reorder=False
)


# --------------------------------------------------------------------------
# constant folding / propagation (DL303)
# --------------------------------------------------------------------------


def _subst_term(t, name: str, value: int):
    if isinstance(t, Var) and t.name == name:
        return Const(value)
    return t


def _subst_head_term(t, name: str, value: int):
    if isinstance(t, Agg):
        kept = tuple(v for v in t.arg.vars if v.name != name)
        dropped = len(t.arg.vars) - len(kept)
        if not dropped:
            return t
        return Agg(t.op, Expr(kept, t.arg.const + value * dropped))
    return _subst_term(t, name, value)


def _subst_rule(rule: Rule, name: str, value: int) -> Rule:
    head = tuple(_subst_head_term(t, name, value) for t in rule.head_terms)
    body: list = []
    for b in rule.body:
        if isinstance(b, Atom):
            body.append(
                Atom(
                    b.pred,
                    tuple(_subst_term(t, name, value) for t in b.terms),
                    negated=b.negated,
                    span=b.span,
                )
            )
        else:
            body.append(
                Cmp(
                    b.op,
                    _subst_term(b.lhs, name, value),
                    _subst_term(b.rhs, name, value),
                    span=b.span,
                )
            )
    return Rule(rule.head_pred, head, tuple(body), span=rule.span)


def _cmp_is_true(c: Cmp) -> bool:
    from repro_torch.analysis.passes import _CMP_EVAL

    if isinstance(c.lhs, Const) and isinstance(c.rhs, Const):
        return _CMP_EVAL[c.op](c.lhs.value, c.rhs.value)
    # x == x, x <= x, x >= x hold for every binding of x
    return c.lhs == c.rhs and c.op in ("==", "<=", ">=")


def _fold_rule(rule: Rule) -> tuple[Rule, bool]:
    """Propagate ``var == const`` selections into the rule and drop
    always-true comparisons; returns ``(rule, changed)``.

    Always-*false* comparisons are deliberately left in place — the rule
    is then unsatisfiable and it is the dead-rule pass's job (separately
    flaggable) to eliminate it.
    """
    changed = False
    while True:
        # one var==const selection per pass; substitution can cascade
        binding: tuple[str, int] | None = None
        for c in rule.comparisons:
            if c.op != "==":
                continue
            if isinstance(c.lhs, Var) and c.lhs.name != "_" and isinstance(c.rhs, Const):
                binding = (c.lhs.name, c.rhs.value)
                break
            if isinstance(c.rhs, Var) and c.rhs.name != "_" and isinstance(c.lhs, Const):
                binding = (c.rhs.name, c.lhs.value)
                break
        if binding is None:
            break
        name, value = binding
        body = tuple(
            b
            for b in rule.body
            if not (
                isinstance(b, Cmp)
                and b.op == "=="
                and (
                    (isinstance(b.lhs, Var) and b.lhs.name == name and b.rhs == Const(value))
                    or (isinstance(b.rhs, Var) and b.rhs.name == name and b.lhs == Const(value))
                )
            )
        )
        rule = _subst_rule(
            Rule(rule.head_pred, rule.head_terms, body, span=rule.span), name, value
        )
        changed = True
    kept = tuple(
        b for b in rule.body if not (isinstance(b, Cmp) and _cmp_is_true(b))
    )
    if len(kept) != len(rule.body):
        rule = Rule(rule.head_pred, rule.head_terms, kept, span=rule.span)
        changed = True
    return rule, changed


def _pass_fold(program: Program) -> tuple[Program, list[Diagnostic]]:
    diags: list[Diagnostic] = []
    rules: list[Rule] = []
    for i, r in enumerate(program.rules):
        folded, changed = _fold_rule(r)
        if changed:
            diags.append(
                Diagnostic(
                    "DL303",
                    f"constant selection folded into rule: {r}  ==>  {folded}",
                    rule=r,
                    rule_index=i,
                )
            )
        rules.append(folded)
    return Program(rules), diags


# --------------------------------------------------------------------------
# duplicate elimination (DL302)
# --------------------------------------------------------------------------


def _pass_dedup(program: Program) -> tuple[Program, list[Diagnostic]]:
    seen: dict[tuple, int] = {}
    rules: list[Rule] = []
    diags: list[Diagnostic] = []
    for i, r in enumerate(program.rules):
        key = canonical_rule(r)
        if key in seen:
            diags.append(
                Diagnostic(
                    "DL302",
                    f"duplicate of rule #{seen[key]} removed: {r}",
                    rule=r,
                    rule_index=i,
                )
            )
            continue
        seen[key] = i
        rules.append(r)
    return Program(rules), diags


# --------------------------------------------------------------------------
# dead-rule elimination (DL301)
# --------------------------------------------------------------------------


def _pass_dead(
    program: Program, outputs: tuple[str, ...] | None
) -> tuple[Program, list[Diagnostic]]:
    diags: list[Diagnostic] = []
    rules = list(program.rules)

    # (a) unsatisfiable bodies — removable only while the head predicate
    # keeps another deriving rule, so the program's queryable relation set
    # (and the engine's EDB/IDB split) never changes under rewrite.
    for i, r in enumerate(list(rules)):
        reason = unsatisfiable_reason(r)
        if reason is None:
            continue
        if sum(1 for o in rules if o.head_pred == r.head_pred) < 2:
            continue
        rules.remove(r)
        diags.append(
            Diagnostic(
                "DL301",
                f"dead rule removed ({reason}): {r}",
                rule=r,
                rule_index=i,
            )
        )

    # (b) unreachable from the declared outputs (explicit opt-in only)
    if outputs:
        pruned = Program(rules)
        needed = _needed_preds(pruned, outputs)
        kept: list[Rule] = []
        for r in rules:
            if r.head_pred in needed:
                kept.append(r)
            else:
                diags.append(
                    Diagnostic(
                        "DL301",
                        f"dead rule removed (unreachable from outputs "
                        f"{sorted(set(outputs))}): {r}",
                        rule=r,
                        rule_index=program.rules.index(r),
                    )
                )
        rules = kept
    return Program(rules), diags


# --------------------------------------------------------------------------
# bound-variable-first atom reordering (DL304)
# --------------------------------------------------------------------------


def _const_count(a: Atom) -> int:
    return sum(1 for t in a.terms if isinstance(t, Const))


def _reorder_rule(rule: Rule) -> Rule:
    """Greedy selection-first join order: start from the most-constant
    atom, then repeatedly take the atom sharing the most already-bound
    variables (ties broken by constant count, then source order)."""
    atoms = list(rule.positive_atoms)
    if len(atoms) < 2 or not any(_const_count(a) for a in atoms):
        return rule
    remaining = list(enumerate(atoms))
    ordered: list[Atom] = []
    bound: set[Var] = set()
    while remaining:
        best = max(
            remaining,
            key=lambda ia: (
                len(set(ia[1].vars()) & bound) if ordered else 0,
                _const_count(ia[1]),
                -ia[0],
            ),
        )
        remaining.remove(best)
        ordered.append(best[1])
        bound.update(best[1].vars())
    if ordered == atoms:
        return rule
    rest = tuple(b for b in rule.body if not (isinstance(b, Atom) and not b.negated))
    return Rule(rule.head_pred, rule.head_terms, tuple(ordered) + rest, span=rule.span)


def _pbme_protected_rules(program: Program) -> set[int]:
    """Rules in PBME-shape-matched strata: the TC/SG matcher is
    atom-order-sensitive, so reordering would silently drop the stratum
    off the bit-matrix fast path."""
    from repro_torch.core.analyzer import analyze
    from repro_torch.core.bitmatrix import explain_bitmatrix_stratum
    from repro_torch.core.engine import EngineConfig

    config = EngineConfig()
    protected: set[int] = set()
    index = {id(r): i for i, r in enumerate(program.rules)}
    try:
        strat = analyze(program)
    except ValueError:
        return set(range(len(program.rules)))  # invalid: touch nothing
    for stratum in strat.strata:
        plan, _ = explain_bitmatrix_stratum(stratum, None, config)
        if plan is not None:
            protected.update(index[id(r)] for r in stratum.rules)
    return protected


def _pass_reorder(program: Program) -> tuple[Program, list[Diagnostic]]:
    protected = _pbme_protected_rules(program)
    diags: list[Diagnostic] = []
    rules: list[Rule] = []
    for i, r in enumerate(program.rules):
        if i in protected:
            rules.append(r)
            continue
        reordered = _reorder_rule(r)
        if reordered.body != r.body:
            diags.append(
                Diagnostic(
                    "DL304",
                    f"body atoms reordered (bound-variable-first): {r}  "
                    f"==>  {reordered}",
                    rule=r,
                    rule_index=i,
                )
            )
        rules.append(reordered)
    return Program(rules), diags


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------


def rewrite_program(
    program: Program, config: RewriteConfig = DEFAULT_REWRITES
) -> tuple[Program, list[Diagnostic]]:
    """Apply the enabled rewrites; returns the new program plus one
    ``DL3xx`` info diagnostic per change.  The input must be valid
    (no DL0xx errors); the output is valid by construction."""
    diags: list[Diagnostic] = []
    if config.fold_constants:
        program, d = _pass_fold(program)
        diags.extend(d)
    if config.dedup:
        program, d = _pass_dedup(program)
        diags.extend(d)
    if config.dead_rules:
        program, d = _pass_dead(program, config.outputs)
        diags.extend(d)
    if config.reorder:
        program, d = _pass_reorder(program)
        diags.extend(d)
    return program, diags


def verify_rewrite(
    original: Program,
    rewritten: Program,
    edb: dict,
    engine_config=None,
    *,
    demand=None,
    seeds=(),
    device=None,
) -> list[str]:
    """Run both programs to fixpoint and compare bit-for-bit.

    Returns a list of mismatch descriptions (empty == identical).  A
    predicate the rewrite eliminated entirely reads as empty.  Test/CLI
    helper — O(two full evaluations), never called on the serving path.
    Both programs run on ``device``: CUDA unless given ``"cpu"``.

    With ``demand`` (a :class:`repro_torch.analysis.demand.DemandTransform`;
    ``rewritten`` should be ``demand.program``) the comparison switches to
    the demand contract: the specialized program is evaluated with
    ``demand.seed_rel`` holding one row per binding in ``seeds`` (tuples of
    bound-column values), and for *every* seed the demanded slice of
    ``demand.answer_rel`` must equal the same selection over the
    unspecialized fixpoint of ``demand.query_pred`` — bit for bit.
    """
    import numpy as np

    from repro_torch.core.engine import Engine, EngineConfig

    cfg = engine_config if engine_config is not None else EngineConfig()
    before = Engine(cfg, device=device).run(original, dict(edb))
    problems: list[str] = []

    if demand is not None:
        seed_list = [tuple(int(v) for v in s) for s in seeds]
        seed_rows = np.asarray(seed_list, np.int32).reshape(
            len(seed_list), len(demand.bound_cols)
        )
        spec_edb = dict(edb)
        spec_edb[demand.seed_rel] = seed_rows
        after = Engine(replace(cfg), device=device).run(rewritten, spec_edb)
        full = np.asarray(before.get(demand.query_pred))
        sl = after.get(demand.answer_rel)
        sl = (
            np.asarray(sl) if sl is not None
            else np.empty((0,) + full.shape[1:], full.dtype)
        )
        for seed in seed_rows:
            def select(rows: np.ndarray) -> set:
                keep = np.ones(len(rows), bool)
                for col, val in zip(demand.bound_cols, seed):
                    keep &= rows[:, col] == val
                return {tuple(int(x) for x in r) for r in rows[keep]}
            want, got = select(full), select(sl)
            if want != got:
                problems.append(
                    f"{demand.query_pred}^{demand.adornment} @ "
                    f"{tuple(int(v) for v in seed)}: {len(want)} rows in the "
                    f"full fixpoint vs {len(got)} demanded "
                    f"(symmetric difference {len(want ^ got)})"
                )
        return problems

    after = Engine(replace(cfg), device=device).run(rewritten, dict(edb))
    for pred in original.idb_preds:
        b = np.asarray(before.get(pred))
        a = after.get(pred)
        a = np.asarray(a) if a is not None else np.empty((0,) + b.shape[1:], b.dtype)
        bs = {tuple(int(x) for x in row) for row in b}
        as_ = {tuple(int(x) for x in row) for row in a}
        if bs != as_:
            problems.append(
                f"{pred}: {len(bs)} rows before vs {len(as_)} after "
                f"(symmetric difference {len(bs ^ as_)})"
            )
    return problems
