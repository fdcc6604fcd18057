"""Demand transformation: adornment + magic-set rewrite for bound queries.

A serving workload is dominated by *bound* point queries — ``tc(src=3, ?)``
needs only the tuples reachable from source 3, yet a materialized instance
pays the full fixpoint up front.  The magic-sets family of static program
specializations (Bancilhon/Beeri/Ramakrishnan/Ullman; BigDatalog shows it
composing with parallel recursive evaluation) rewrites the program so the
fixpoint derives exactly the demanded slice:

1. **Adornment** (:func:`adorn_program`): the query's binding pattern — one
   ``b`` (bound) or ``f`` (free) per column, e.g. ``tc^bf`` — is propagated
   through rule bodies under a configurable sideways-information-passing
   (SIP) strategy.  Every decision is recorded as a source-located ``DL4xx``
   diagnostic: ineligible predicates (``DL401``/``DL403``), bindings dropped
   at negation (``DL402``), the SIP order chosen per rule (``DL404``), and
   atoms demanded with no binding at all (``DL408``).

2. **Magic-set rewrite** (:func:`demand_transform`): each adorned predicate
   ``p^a`` gets a magic predicate ``__m_a__p`` holding the demanded bound
   values, guarded rule variants ``p__a(...) :- __m_a__p(bound...), body``,
   and one magic rule per demanded body atom.  The demand *seed* enters
   through a plain EDB relation ``__s_a__q`` (one row per queried binding)
   so a serving instance can add new demands through the ordinary Δ
   machinery (``seminaive.ingest_variants``) — the resumable semi-naïve
   loop, MVCC epochs, and the WAL are untouched.

3. **Verification + fallback**: the transformed program is re-checked by
   the *existing* safety/arity/stratification passes; a transform that
   fails them (negation can make magic unstratifiable), that cannot seed
   (no bound column), or that ``repro_torch.obs.explain`` estimates unprofitable
   *falls back* with a coded info diagnostic (``DL405``/``DL407``/
   ``DL406``) — the caller serves from the full materialization, never a
   request error.  :func:`repro_torch.analysis.rewrites.verify_rewrite` checks
   the demanded slice of the specialized fixpoint bit-for-bit against the
   selection over the unspecialized one.

The serving integration lives in ``repro_torch.serve_datalog`` (``PlanCache.
get_demand``, ``MaterializedInstance.specialize``, ``submit_query(...,
on_demand=True)``) — see ``docs/analysis.md`` § Demand transformation and
``docs/serving_api.md`` § On-demand queries.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.ast import Agg, Atom, Const, Program, Rule, Var

SIP_STRATEGIES = ("left-to-right", "bound-first")


@dataclass(frozen=True)
class DemandConfig:
    """Knobs for the demand transformation.

    ``sip`` selects the sideways-information-passing strategy:
    ``left-to-right`` adorns body atoms in textual order (the written join
    order is the information flow); ``bound-first`` greedily picks the
    positive atom with the largest fraction of bound argument positions
    next (ties break textual).  ``profitability`` gates the transform on a
    :func:`repro_torch.obs.explain.estimate_plan` cost comparison when relation
    sizes are known (serving passes the live EDB counts); an estimated
    cost at or above ``profitability_margin`` × the original plan's cost
    falls back with ``DL406``.  The margin defaults *above* 1 because the
    estimator's independence assumptions cannot see the one benefit magic
    sets exist for — the analytic fixpoint saturates a magic predicate to
    the whole domain, so a profitable specialization typically estimates
    *slightly above* the full plan (guard-rule bookkeeping) while a
    harmful one estimates far above it (new strata with superlinear
    blowup).  The gate therefore rejects clear regressions, not ties.
    ``explain_sip`` emits one ``DL404`` diagnostic per adorned rule (the
    full SIP record — verbose, on by default because demand analysis is
    never on the per-query hot path).  The fingerprint participates in
    demand-plan cache keys.
    """

    sip: str = "left-to-right"
    profitability: bool = True
    profitability_margin: float = 2.0
    explain_sip: bool = True

    def __post_init__(self) -> None:
        if self.sip not in SIP_STRATEGIES:
            raise ValueError(
                f"unknown SIP strategy {self.sip!r}; pick from {SIP_STRATEGIES}"
            )

    def fingerprint(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()[:8]


DEFAULT_DEMAND = DemandConfig()


def check_pattern(program: Program, query_pred: str, pattern: str) -> None:
    """Raise ``ValueError`` unless ``pattern`` is a valid adornment of
    ``query_pred`` — a usage error (the CLI maps it to exit 2), as opposed
    to the transform's own coded-diagnostic fallbacks."""
    if query_pred not in program.idb_preds:
        raise ValueError(
            f"unknown IDB predicate {query_pred!r}; "
            f"program defines {sorted(program.idb_preds)}"
        )
    arity = program.arity_of(query_pred)
    if len(pattern) != arity or not set(pattern) <= {"b", "f"}:
        raise ValueError(
            f"bad binding pattern {pattern!r} for {query_pred}/{arity}: "
            f"need {arity} chars from 'b'/'f'"
        )


def magic_name(pred: str, adornment: str) -> str:
    return f"__m_{adornment}__{pred}"


def seed_name(pred: str, adornment: str) -> str:
    return f"__s_{adornment}__{pred}"


def adorned_name(pred: str, adornment: str) -> str:
    return f"{pred}__{adornment}"


def _bound_positions(adornment: str) -> tuple[int, ...]:
    return tuple(i for i, c in enumerate(adornment) if c == "b")


@dataclass
class AdornedRule:
    """One source rule specialized for one head adornment."""

    pred: str
    adornment: str
    rule: Rule                       # the original rule (source span intact)
    guarded: Rule                    # magic-guarded, atoms renamed apart
    magic_rules: list[Rule] = field(default_factory=list)


@dataclass
class DemandTransform:
    """The result of :func:`demand_transform` — applied or fallen back.

    When ``ok``, ``program`` is the specialized program: seed rule + magic
    rules + guarded adorned rules + full (unspecialized) rules for
    predicates the binding could not reach.  ``seed_rel`` is the EDB
    relation demand seeds are inserted into (arity = number of bound
    columns, in ascending column order) and ``answer_rel`` the adorned
    relation holding the demanded slice of ``query_pred``.  When
    ``fallback`` is set the transform was *not* applied — ``program`` is
    the original program and the fallback diagnostic says why (``DL4xx``,
    info severity: a decision, never an error).
    """

    query_pred: str
    adornment: str
    program: Program
    seed_rel: str
    answer_rel: str
    bound_cols: tuple[int, ...]
    diagnostics: list[Diagnostic] = field(default_factory=list)
    adorned: list[AdornedRule] = field(default_factory=list)
    full_preds: tuple[str, ...] = ()
    fallback: Diagnostic | None = None

    @property
    def ok(self) -> bool:
        return self.fallback is None

    @property
    def magic_rules(self) -> list[Rule]:
        seen: set[str] = set()
        out: list[Rule] = []
        for ar in self.adorned:
            for r in ar.magic_rules:
                if repr(r) not in seen:
                    seen.add(repr(r))
                    out.append(r)
        return out

    def render(self) -> str:
        """Human-readable adorned + magic program (the EXPLAIN surface)."""
        lines = [
            f"demand {self.query_pred}^{self.adornment}"
            + ("" if self.ok else "  [FALLBACK]")
        ]
        if self.fallback is not None:
            lines.append(f"  fallback: {self.fallback.render()}")
            return "\n".join(lines)
        lines.append(
            f"  seed {self.seed_rel}/{len(self.bound_cols)} "
            f"-> answer {self.answer_rel}"
        )
        lines.append("  adorned rules:")
        for ar in self.adorned:
            lines.append(f"    {ar.guarded}")
        magic = self.magic_rules
        if magic:
            lines.append("  magic rules:")
            for r in magic:
                lines.append(f"    {r}")
        if self.full_preds:
            lines.append(
                "  computed in full: " + ", ".join(sorted(self.full_preds))
            )
        for d in self.diagnostics:
            if d.code != "DL404":
                lines.append(f"  {d.render()}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "query": f"{self.query_pred}^{self.adornment}",
            "ok": self.ok,
            "seed_rel": self.seed_rel,
            "answer_rel": self.answer_rel,
            "bound_cols": list(self.bound_cols),
            "adorned_rules": [repr(ar.guarded) for ar in self.adorned],
            "magic_rules": [repr(r) for r in self.magic_rules],
            "full_preds": sorted(self.full_preds),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "fallback": self.fallback.to_dict() if self.fallback else None,
        }


# --------------------------------------------------------------------------
# adornment
# --------------------------------------------------------------------------


def _sip_order(rule: Rule, bound0: set[str], strategy: str) -> list:
    """Body items in SIP order: positive atoms first (the binding carriers),
    negated atoms and comparisons after (they never bind new variables)."""
    positives = [b for b in rule.body if isinstance(b, Atom) and not b.negated]
    rest = [b for b in rule.body if not (isinstance(b, Atom) and not b.negated)]
    if strategy == "left-to-right":
        return positives + rest
    # bound-first: greedily maximize the bound-argument fraction
    bound = set(bound0)
    ordered: list[Atom] = []
    remaining = list(positives)
    while remaining:
        def score(a: Atom) -> float:
            if not a.terms:
                return 1.0
            n = sum(
                1 for t in a.terms
                if isinstance(t, Const)
                or (isinstance(t, Var) and t.name != "_" and t.name in bound)
            )
            return n / len(a.terms)
        best = max(remaining, key=lambda a: (score(a), -remaining.index(a)))
        remaining.remove(best)
        ordered.append(best)
        bound |= {v.name for v in best.vars()}
    return ordered + rest


def _atom_adornment(atom: Atom, bound: set[str]) -> str:
    out = []
    for t in atom.terms:
        if isinstance(t, Const):
            out.append("b")
        elif isinstance(t, Var) and t.name != "_" and t.name in bound:
            out.append("b")
        else:
            out.append("f")
    return "".join(out)


def _ineligible_preds(program: Program) -> dict[str, str]:
    """IDB predicates the transform cannot specialize, with the reason.

    Aggregate heads are the one structural blocker: a MIN/MAX/SUM winner
    depends on the *whole* group, so guarding the rule by a magic predicate
    on non-group columns could change which tuples compete.  Such
    predicates are computed in full instead.
    """
    out: dict[str, str] = {}
    for r in program.rules:
        if r.has_aggregate and r.head_pred not in out:
            out[r.head_pred] = "aggregate head"
    return out


def adorn_program(
    program: Program,
    query_pred: str,
    pattern: str,
    config: DemandConfig = DEFAULT_DEMAND,
) -> tuple[list[AdornedRule], set[str], list[Diagnostic]]:
    """Propagate ``query_pred``'s binding pattern through the program.

    Returns ``(adorned_rules, full_preds, diagnostics)``: the magic-guarded
    rule variants for every reachable (predicate, adornment) pair, the IDB
    predicates that must be computed unspecialized (ineligible, demanded
    all-free, or referenced under negation), and one ``DL4xx`` diagnostic
    per decision.  Raises ``ValueError`` on an unknown predicate or a
    malformed pattern (usage errors); never raises on program *shape* —
    those become ``full_preds`` entries with diagnostics.
    """
    check_pattern(program, query_pred, pattern)
    idb = set(program.idb_preds)
    ineligible = _ineligible_preds(program)
    rules_of: dict[str, list[Rule]] = {}
    for r in program.rules:
        rules_of.setdefault(r.head_pred, []).append(r)

    diags: list[Diagnostic] = []
    full: set[str] = set()
    adorned: list[AdornedRule] = []
    done: set[tuple[str, str]] = set()
    worklist: list[tuple[str, str]] = []

    def demand_full(pred: str) -> None:
        """Mark ``pred`` (and transitively its body IDB preds) unspecialized."""
        stack = [pred]
        while stack:
            p = stack.pop()
            if p in full:
                continue
            full.add(p)
            for r in rules_of.get(p, []):
                for a in r.atoms:
                    if a.pred in idb:
                        stack.append(a.pred)

    def demand(pred: str, adn: str, site: Atom | None, rule: Rule | None) -> str:
        """Demand ``pred`` under ``adn``; returns the body-atom name to use
        (adorned rename, or the original name when computed in full)."""
        if pred in ineligible:
            if pred not in full:
                diags.append(Diagnostic(
                    "DL401",
                    f"{pred} has an {ineligible[pred]}: cannot specialize — "
                    f"computed in full",
                    rule=rules_of[pred][0],
                ))
                if "b" in adn:
                    diags.append(Diagnostic(
                        "DL403",
                        f"binding {pred}^{adn} lost through aggregation "
                        f"({ineligible[pred]})",
                        rule=rule if rule is not None else rules_of[pred][0],
                    ))
            demand_full(pred)
            return pred
        if "b" not in adn:
            if pred not in full:
                diags.append(Diagnostic(
                    "DL408",
                    f"{pred} demanded with all-free adornment "
                    f"{pred}^{adn}: no binding to push — computed in full",
                    span=site.span if site is not None else None,
                    rule=rule,
                ))
            demand_full(pred)
            return pred
        if (pred, adn) not in done:
            done.add((pred, adn))
            worklist.append((pred, adn))
        return adorned_name(pred, adn)

    demand(query_pred, pattern, None, None)

    while worklist:
        pred, adn = worklist.pop(0)
        bound_pos = _bound_positions(adn)
        for rule in rules_of.get(pred, []):
            bound0 = {
                t.name
                for i in bound_pos
                for t in [rule.head_terms[i]]
                if isinstance(t, Var) and t.name != "_"
            }
            order = _sip_order(rule, bound0, config.sip)
            bound = set(bound0)
            new_body: list = []
            magic_rules: list[Rule] = []
            sip_record: list[str] = []
            guard = Atom(
                magic_name(pred, adn),
                tuple(rule.head_terms[i] for i in bound_pos),
            )
            # prefix of the *rewritten* body usable in magic-rule bodies:
            # the guard plus every positive atom processed so far, plus
            # comparisons already fully bound (negations are skipped — an
            # over-approximated magic set is still sound)
            prefix: list = [guard]
            for item in order:
                if isinstance(item, Atom) and not item.negated:
                    a_adn = _atom_adornment(item, bound)
                    if item.pred in idb:
                        new_pred = demand(item.pred, a_adn, item, rule)
                        sip_record.append(f"{item.pred}^{a_adn}")
                        if new_pred != item.pred:
                            m_head = Atom(
                                magic_name(item.pred, a_adn),
                                tuple(
                                    item.terms[i]
                                    for i in _bound_positions(a_adn)
                                ),
                            )
                            m_rule = Rule(
                                m_head.pred, m_head.terms,
                                tuple(prefix), span=None,
                            )
                            if not _is_trivial_magic(m_rule):
                                magic_rules.append(m_rule)
                        item = Atom(
                            new_pred, item.terms, span=item.span
                        )
                    else:
                        sip_record.append(f"{item.pred}(edb)")
                    new_body.append(item)
                    prefix.append(item)
                    bound |= {v.name for v in item.vars()}
                elif isinstance(item, Atom):         # negated
                    if item.pred in idb:
                        diags.append(Diagnostic(
                            "DL402",
                            f"binding not propagated through negation: "
                            f"!{item.pred} computed in full",
                            span=item.span,
                            rule=rule,
                        ))
                        demand_full(item.pred)
                    new_body.append(item)
                else:                                # comparison
                    new_body.append(item)
                    if all(v.name in bound for v in item.vars()):
                        prefix.append(item)
            guarded = Rule(
                adorned_name(pred, adn),
                rule.head_terms,
                (guard, *new_body),
                span=rule.span,
            )
            if config.explain_sip:
                diags.append(Diagnostic(
                    "DL404",
                    f"SIP[{config.sip}] {pred}^{adn}: "
                    + (" -> ".join(sip_record) if sip_record else "(facts only)"),
                    rule=rule,
                ))
            adorned.append(AdornedRule(pred, adn, rule, guarded, magic_rules))
    return adorned, full, diags


# --------------------------------------------------------------------------
# magic-set rewrite
# --------------------------------------------------------------------------


def _is_trivial_magic(rule: Rule) -> bool:
    """``m(x) :- m(x).`` — a self-demand that derives nothing new."""
    return (
        len(rule.body) == 1
        and isinstance(rule.body[0], Atom)
        and rule.body[0].pred == rule.head_pred
        and rule.body[0].terms == rule.head_terms
        and not rule.body[0].negated
    )


def demand_transform(
    program: Program,
    query_pred: str,
    pattern: str,
    config: DemandConfig = DEFAULT_DEMAND,
    *,
    sizes: dict[str, float] | None = None,
    domain: int = 0,
) -> DemandTransform:
    """Adorn + magic-rewrite ``program`` for ``query_pred^pattern``.

    Never raises on program shape: a transform that cannot apply comes back
    with ``fallback`` set to the coded diagnostic (``DL405`` stratification/
    safety, ``DL406`` unprofitable, ``DL407`` unseedable) and ``program``
    unchanged.  Raises ``ValueError`` only for usage errors (unknown
    predicate, malformed pattern).  ``sizes``/``domain`` feed the
    profitability estimate (EDB row counts; omit to skip the gate).
    """
    check_pattern(program, query_pred, pattern)

    def fallen(diag: Diagnostic, extra: list[Diagnostic]) -> DemandTransform:
        return DemandTransform(
            query_pred=query_pred,
            adornment=pattern,
            program=program,
            seed_rel=seed_name(query_pred, pattern),
            answer_rel=adorned_name(query_pred, pattern),
            bound_cols=_bound_positions(pattern),
            diagnostics=[*extra, diag],
            fallback=diag,
        )

    if "b" not in pattern:
        return fallen(Diagnostic(
            "DL407",
            f"{query_pred}^{pattern} has no bound column: nothing to seed "
            f"a magic predicate with — serving from the full materialization",
        ), [])

    adorned, full, diags = adorn_program(program, query_pred, pattern, config)

    if query_pred in full:
        reason = _ineligible_preds(program).get(query_pred, "no usable binding")
        return fallen(Diagnostic(
            "DL407",
            f"{query_pred}^{pattern} cannot be specialized ({reason}): "
            f"serving from the full materialization",
        ), diags)

    # synthesized names must not collide with the source program's
    taken = set(program.idb_preds) | set(program.edb_preds)
    new_names = {seed_name(query_pred, pattern)}
    for ar in adorned:
        new_names.add(adorned_name(ar.pred, ar.adornment))
        new_names.add(magic_name(ar.pred, ar.adornment))
    clash = sorted(taken & new_names)
    if clash:
        return fallen(Diagnostic(
            "DL405",
            f"demand transform would shadow existing predicate(s) "
            f"{clash}: falling back to the full materialization",
        ), diags)

    # assemble: seed rule, magic rules (deduped), guarded rules, full rules
    seed_rel = seed_name(query_pred, pattern)
    bound_cols = _bound_positions(pattern)
    seed_vars = tuple(Var(f"s{i}") for i in range(len(bound_cols)))
    rules: list[Rule] = [Rule(
        magic_name(query_pred, pattern), seed_vars,
        (Atom(seed_rel, seed_vars),), span=None,
    )]
    seen_magic: set[str] = set()
    for ar in adorned:
        for m in ar.magic_rules:
            if _is_trivial_magic(m) or repr(m) in seen_magic:
                continue
            seen_magic.add(repr(m))
            rules.append(m)
    rules.extend(ar.guarded for ar in adorned)
    emitted: set[int] = set()
    for r in program.rules:
        if r.head_pred in full and id(r) not in emitted:
            emitted.add(id(r))
            rules.append(r)
    transformed = Program(rules)

    # re-run the existing error passes on the transformed program — magic
    # guards can create new negative cycles the source program did not have
    from repro_torch.analysis.passes import (
        arity_diagnostics,
        safety_diagnostics,
        stratification_diagnostics,
    )

    errors = [
        d
        for check in (safety_diagnostics, arity_diagnostics,
                      stratification_diagnostics)
        for d in check(transformed)
        if d.is_error
    ]
    if errors:
        return fallen(Diagnostic(
            "DL405",
            f"transformed program fails re-check "
            f"({errors[0].code}: {errors[0].message}): "
            f"falling back to the full materialization",
        ), diags)

    if config.profitability and sizes:
        from repro_torch.core.analyzer import analyze
        from repro_torch.obs.explain import estimate_plan

        @dataclass
        class _PlanLike:
            fingerprint: str
            strat: object

        base_cost = estimate_plan(
            _PlanLike("demand-base", analyze(program)),
            sizes=dict(sizes), domain=domain,
        ).total_cost()
        spec_sizes = dict(sizes)
        spec_sizes[seed_rel] = 1.0          # one demanded binding
        spec_cost = estimate_plan(
            _PlanLike("demand-spec", analyze(transformed)),
            sizes=spec_sizes, domain=domain,
        ).total_cost()
        if spec_cost >= base_cost * config.profitability_margin:
            return fallen(Diagnostic(
                "DL406",
                f"specialized plan estimated unprofitable "
                f"(est {spec_cost:.3g} vs full {base_cost:.3g}): "
                f"falling back to the full materialization",
            ), diags)

    diags.append(Diagnostic(
        "DL400",
        f"demand transform {query_pred}^{pattern} applied: "
        f"{len(adorned)} adorned rule(s), {len(seen_magic)} magic rule(s), "
        f"{len(full)} predicate(s) in full; seed {seed_rel} "
        f"-> answer {adorned_name(query_pred, pattern)}",
    ))
    return DemandTransform(
        query_pred=query_pred,
        adornment=pattern,
        program=transformed,
        seed_rel=seed_rel,
        answer_rel=adorned_name(query_pred, pattern),
        bound_cols=bound_cols,
        diagnostics=diags,
        adorned=adorned,
        full_preds=tuple(sorted(full)),
    )


# --------------------------------------------------------------------------
# the DL202 eligibility explainer (lint surface)
# --------------------------------------------------------------------------


def demand_diagnostics(
    program: Program, config: DemandConfig = DEFAULT_DEMAND
) -> list[Diagnostic]:
    """One ``DL202`` info per IDB predicate: can the canonical point-query
    pattern (first column bound) specialize it, and if not, why not.

    The sibling of the ``DL201`` PBME explainer — surfaced by
    ``srv.lint()`` and the CLI so operators can see which relations
    ``on_demand=True`` queries will actually specialize.
    """
    out: list[Diagnostic] = []
    probe = replace(config, profitability=False, explain_sip=False)
    first_rule = {r.head_pred: r for r in reversed(program.rules)}
    for pred in program.idb_preds:
        arity = program.arity_of(pred)
        pattern = "b" + "f" * (arity - 1) if arity else ""
        try:
            t = demand_transform(program, pred, pattern, probe)
        except ValueError as e:                  # pragma: no cover — guarded
            out.append(Diagnostic(
                "DL202", f"{pred}^{pattern} not eligible: {e}",
                rule=first_rule.get(pred),
            ))
            continue
        if t.ok:
            msg = (
                f"{pred}^{pattern} eligible for demand specialization: "
                f"{len(t.adorned)} adorned rule(s), "
                f"{len(t.magic_rules)} magic rule(s)"
                + (
                    f"; in full: {', '.join(sorted(t.full_preds))}"
                    if t.full_preds else ""
                )
            )
        else:
            msg = (
                f"{pred}^{pattern} not eligible: {t.fallback.message}"
            )
        out.append(Diagnostic("DL202", msg, rule=first_rule.get(pred)))
    return out
