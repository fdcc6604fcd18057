"""Semi-naïve delta rewriting (paper §3.2), incl. non-linear & mutual recursion.

For a rule whose body holds k atoms of the current stratum, emit k variants —
variant i reads atom i from Δ (previous iteration's new facts) and every other
stratum atom from the full current relation.  Rules with no stratum atom in
the body are *base rules*, evaluated once at iteration 0.  The union of all
variants deriving one IDB is evaluated as a single fused program (UIE).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.analyzer import Stratum
from repro_torch.core.ast import Atom, Rule

#: Prefix naming the ∇R (deleted-tuples) delta view of a relation.  Never a
#: real predicate: rederive rules read it through the engine's explicit-Δ
#: precedence in ``_view_for`` without the store ever holding such a relation.
NABLA = "__nabla__"


@dataclass(frozen=True)
class RuleVariant:
    rule: Rule
    delta_idx: int | None          # body-atom index read from Δ; None = base rule

    def __repr__(self) -> str:
        mark = f" [Δ@{self.delta_idx}]" if self.delta_idx is not None else " [base]"
        return repr(self.rule) + mark


def delta_variants(stratum: Stratum) -> dict[str, list[RuleVariant]]:
    """IDB pred → variants (UIE groups: all variants of one head together)."""
    groups: dict[str, list[RuleVariant]] = {p: [] for p in stratum.preds}
    pred_set = set(stratum.preds)
    for rule in stratum.rules:
        rec_positions = [
            i
            for i, a in enumerate(rule.atoms)
            if a.pred in pred_set and not a.negated
        ]
        if not stratum.recursive or not rec_positions:
            groups[rule.head_pred].append(RuleVariant(rule, None))
        else:
            for i in rec_positions:
                groups[rule.head_pred].append(RuleVariant(rule, i))
    return groups


def ingest_variants(stratum: Stratum, changed: set[str]) -> dict[str, list[RuleVariant]]:
    """Delta rewriting against *external* changes (incremental maintenance).

    ``changed`` names relations outside the stratum (EDB or upstream IDBs)
    that just gained facts.  For every positive occurrence of a changed
    relation, emit a variant reading that atom from the external Δ and every
    other atom from the full (already-updated) relation: any derivation using
    at least one new fact is covered by the variant whose Δ atom is one of the
    new facts it uses, and duplicates are absorbed by dedup + set-difference.
    The results, set-differenced against the stored IDB, seed ΔR for the
    resumed semi-naïve loop.
    """
    groups: dict[str, list[RuleVariant]] = {p: [] for p in stratum.preds}
    for rule in stratum.rules:
        for i, atom in enumerate(rule.atoms):
            if not atom.negated and atom.pred in changed:
                groups[rule.head_pred].append(RuleVariant(rule, i))
    return groups


def deletion_variants(
    stratum: Stratum, deleted: set[str]
) -> dict[str, list[RuleVariant]]:
    """Delta rewriting for the DRed *over-deletion* pass.

    ``deleted`` names relations (external ∇ seeds or stratum preds whose
    tuples were over-deleted last round) that just *lost* facts.  For every
    positive occurrence of a deleted relation, emit a variant reading that
    atom from the ∇ view and every other atom from the full **pre-deletion**
    relation: a derivation dies only if it used at least one deleted fact, and
    every such derivation is covered by the variant whose ∇ atom is one of the
    deleted facts it used.  The derived heads form the next over-deletion
    frontier (an over-approximation — surviving alternate derivations are
    restored by the re-derivation pass).

    The variant *enumeration* is the same one-variant-per-occurrence rewrite
    as :func:`ingest_variants` — only the Δ-view contents (∇ = deleted
    tuples) and the evaluation state (pre-deletion ``store_old``) differ,
    and both of those are the caller's choice.
    """
    return ingest_variants(stratum, deleted)


def rederive_seed_variants(
    stratum: Stratum, changed: set[str], nabla_preds
) -> dict[str, list[RuleVariant]]:
    """Seed groups for DRed pass 2 — one unified per-stratum visit.

    Combines :func:`ingest_variants` for externally-grown relations (a
    transaction's inserted side) with ∇-guarded re-derivation variants
    (:func:`rederive_rule`) for every over-deleted head in ``nabla_preds``.
    The engine evaluates both seed sets in the same iteration-0 pass and
    resumes ONE semi-naïve loop — which is what lets a mixed insert/retract
    transaction traverse a stratum once instead of paying an ingest pass
    and a DRed pass separately.
    """
    groups = (
        ingest_variants(stratum, changed)
        if changed
        else {p: [] for p in stratum.preds}
    )
    for pred in nabla_preds:
        for rule in stratum.rules_for(pred):
            groups[pred].append(RuleVariant(rederive_rule(rule), 0))
    return groups


def rederive_rule(rule: Rule) -> Rule:
    """The DRed *re-derivation* variant of ``rule``.

    Prepends a guard atom ``__nabla__head(head_terms)`` to the body: joined
    first (the engine reads it from the ∇ delta view), it restricts the whole
    evaluation to over-deleted head tuples, so re-derivation costs scale with
    ``|∇R| × join fan-out`` instead of a full naive re-evaluation of the rule.
    A tuple survives iff some rule body still derives it from the
    post-deletion state — exactly what the guarded join produces.
    """
    guard = Atom(NABLA + rule.head_pred, rule.head_terms)
    return Rule(rule.head_pred, rule.head_terms, (guard,) + rule.body)
