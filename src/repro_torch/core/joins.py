"""Sort-merge join plans: the device replacement for hash joins.

A rule body is evaluated as a left-deep sequence of binding-table ⋈ atom
steps.  Each step probes the binding table's key column into the atom's
relation *sorted by the join column* (the sorted table is the "index"; probing
is two `searchsorted`s — no hash build).  Match expansion is the vectorized
offsets+searchsorted trick with an exact, host-chosen output capacity (the
counts pass is the paper's `analyze()` — OOF's lightweight statistics).

Join-order selection is re-done **every iteration** from live relation counts
(OOF at plan level): delta atom first, then greedily the atom sharing a
variable with the bound set, tie-broken by smallest current count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.ast import Atom, Cmp, Const, Rule, Var
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import (
    SENTINEL,
    compact_key,
    expand_matches,
    lexsort_rows,
    searchsorted_rows,
)


@dataclass
class Bindings:
    """Intermediate join result: one column per bound variable."""

    cols: dict[Var, torch.Tensor]   # each int32[capacity]
    valid: torch.Tensor             # bool[capacity]
    count: int                      # host-side number of valid rows (≤ capacity)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def _mask(valid: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, col, SENTINEL)


def _apply_local_filters(atom: Atom, cols: list[torch.Tensor]) -> torch.Tensor:
    """Constants and repeated variables *within* one atom."""
    valid = torch.ones(cols[0].shape, dtype=torch.bool, device=cols[0].device)
    seen: dict[Var, int] = {}
    for pos, term in enumerate(atom.terms):
        if isinstance(term, Const):
            valid &= cols[pos] == term.value
        elif isinstance(term, Var) and term.name != "_":
            if term in seen:
                valid &= cols[pos] == cols[seen[term]]
            else:
                seen[term] = pos
    return valid


def init_bindings(atom: Atom, rows: torch.Tensor, count: int) -> Bindings:
    """First atom: select+project the relation into a binding table."""
    cols = [rows[:, i] for i in range(rows.shape[1])]
    valid = _apply_local_filters(atom, cols) & (cols[0] != SENTINEL)
    out: dict[Var, torch.Tensor] = {}
    for pos, term in enumerate(atom.terms):
        if isinstance(term, Var) and term.name != "_" and term not in out:
            out[term] = _mask(valid, cols[pos])
    return Bindings(out, valid, count)


def join_counts(
    bindings: Bindings,
    probe_key: torch.Tensor,
    build_key: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counts pass: per-probe-row match ranges (lo, counts), int32."""
    lo, hi = searchsorted_rows(build_key, probe_key)
    counts = torch.where(bindings.valid & (probe_key != SENTINEL), hi - lo, 0)
    return lo, counts


def join_materialize(
    bindings: Bindings,
    atom: Atom,
    build_rows: torch.Tensor,
    lo: torch.Tensor,
    counts: torch.Tensor,
    out_capacity: int,
) -> Bindings:
    """Expansion pass: gather matched (probe, build) pairs and extend bindings."""
    probe_idx, build_idx, valid = expand_matches(lo, counts, out_capacity)
    total = int(counts.sum())
    build_idx = torch.clamp(build_idx, max=build_rows.shape[0] - 1)

    t_cols = [build_rows[build_idx, i] for i in range(build_rows.shape[1])]
    valid &= _apply_local_filters(atom, t_cols)

    out: dict[Var, torch.Tensor] = {
        v: col[probe_idx] for v, col in bindings.cols.items()
    }
    for pos, term in enumerate(atom.terms):
        if isinstance(term, Var) and term.name != "_":
            if term in out:
                valid &= out[term] == t_cols[pos]     # shared non-key var
            else:
                out[term] = t_cols[pos]
    out = {v: _mask(valid, c) for v, c in out.items()}
    return Bindings(out, valid, total)


_CMP = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def apply_comparison(bindings: Bindings, cmp: Cmp) -> Bindings:
    def val(term):
        if isinstance(term, Const):
            return torch.tensor(term.value, dtype=torch.int32, device=bindings.valid.device)
        return bindings.cols[term]

    valid = bindings.valid & _CMP[cmp.op](val(cmp.lhs), val(cmp.rhs))
    cols = {v: _mask(valid, c) for v, c in bindings.cols.items()}
    return Bindings(cols, valid, bindings.count)


def membership(
    probe_rows: torch.Tensor, table_rows: torch.Tensor, domain: int
) -> torch.Tensor:
    """``bool[n_probe]``: is each probe tuple present in the table?

    Compact-key fast path (CCK) when the domain allows, else the universal
    concat-lexsort membership (any arity, any domain).  Traced as a
    ``membership`` device span whose ``path`` is ``"key"`` or ``"scan"``.
    """
    pk = compact_key(probe_rows, domain)
    tk = compact_key(table_rows, domain)
    path = "key" if pk is not None and tk is not None else "scan"
    with _TRACE.device_span(
        "membership", "engine", device=probe_rows.device, path=path,
        rows=probe_rows.shape[0] + table_rows.shape[0],
    ):
        if path == "key":
            lo, hi = searchsorted_rows(tk, pk)
            return (hi > lo) & (pk != SENTINEL)
        return _scan_membership(probe_rows, table_rows)


def _scan_membership(probe_rows: torch.Tensor, table_rows: torch.Tensor) -> torch.Tensor:
    """:func:`membership` without a compact key: one lexsort of both tables
    and two ``cummax`` scans."""
    # universal: tag sources, lexsort, member iff equal adjacent row from table
    n_p, n_t = probe_rows.shape[0], table_rows.shape[0]
    dev = probe_rows.device
    rows = torch.cat([table_rows, probe_rows], dim=0)
    src = torch.cat(
        [
            torch.zeros(n_t, dtype=torch.int32, device=dev),
            torch.ones(n_p, dtype=torch.int32, device=dev),
        ]
    )
    tagged = torch.cat([rows, src[:, None]], dim=1)
    order = lexsort_rows(tagged)
    srt = tagged[order]
    same_as_prev = torch.cat(
        [
            torch.zeros(1, dtype=torch.bool, device=dev),
            (srt[1:, :-1] == srt[:-1, :-1]).all(dim=1),
        ]
    )
    # a row's equal-run holds a table row at or before it iff the last table
    # row seen so far starts no earlier than the run (segmented scan by cummax)
    idx = torch.arange(srt.shape[0], device=dev)
    from_table = srt[:, -1] == 0
    last_table = torch.cummax(torch.where(from_table, idx, -1), 0).values
    run_start = torch.cummax(torch.where(same_as_prev, 0, idx), 0).values
    is_member_sorted = (last_table >= run_start) & (srt[:, -1] == 1)
    member = torch.empty_like(is_member_sorted)
    member[order] = is_member_sorted
    return member[n_t:] & (probe_rows[:, 0] != SENTINEL)


def antijoin(
    bindings: Bindings, atom: Atom, table_rows: torch.Tensor, domain: int
) -> Bindings:
    """Stratified negation: drop binding rows whose atom tuple is in the table."""
    cols = []
    for term in atom.terms:
        if isinstance(term, Const):
            cols.append(
                torch.full(bindings.valid.shape, term.value, dtype=torch.int32,
                           device=bindings.valid.device)
            )
        else:
            cols.append(bindings.cols[term])
    probe = torch.where(bindings.valid[:, None], torch.stack(cols, dim=1), SENTINEL)
    member = membership(probe, table_rows, domain)
    valid = bindings.valid & ~member
    out = {v: _mask(valid, c) for v, c in bindings.cols.items()}
    return Bindings(out, valid, bindings.count)


def order_atoms(
    atoms: list[Atom],
    delta_idx: int | None,
    sizes: dict[int, int],
    oof: bool = True,
) -> list[int]:
    """OOF join ordering from live stats: Δ first, then greedy shared-var,
    smallest-relation tie-break.  With ``oof=False``: textual order."""
    pos_idx = [i for i, a in enumerate(atoms) if not a.negated]
    if not oof:
        if delta_idx is not None:
            return [delta_idx] + [i for i in pos_idx if i != delta_idx]
        return pos_idx
    remaining = set(pos_idx)
    order: list[int] = []
    if delta_idx is not None:
        order.append(delta_idx)
        remaining.discard(delta_idx)
    else:
        first = min(remaining, key=lambda i: sizes.get(i, 1 << 30))
        order.append(first)
        remaining.discard(first)
    bound: set[Var] = set(atoms[order[0]].vars())
    while remaining:
        connected = [i for i in remaining if set(atoms[i].vars()) & bound]
        pool = connected or list(remaining)
        nxt = min(pool, key=lambda i: sizes.get(i, 1 << 30))
        order.append(nxt)
        remaining.discard(nxt)
        bound |= set(atoms[nxt].vars())
    return order


def project_head(rule: Rule, bindings: Bindings) -> tuple[torch.Tensor, torch.Tensor]:
    """Project bound variables onto plain (non-aggregate) head terms."""
    cols = []
    for term in rule.head_terms:
        if isinstance(term, Const):
            cols.append(
                torch.where(bindings.valid, term.value, SENTINEL).to(torch.int32)
            )
        elif isinstance(term, Var):
            cols.append(bindings.cols[term])
        else:
            raise ValueError("aggregate heads handled by aggregates.groupby_aggregate")
    rows = torch.where(bindings.valid[:, None], torch.stack(cols, dim=1), SENTINEL)
    return rows, bindings.valid
