"""Sorted-table primitives: the device replacement for hash tables.

RecStep's FAST-DEDUP builds a latch-free chaining hash table over a *Compact
Concatenated Key* (CCK): the tuple packed into a single machine word, used both
as the key and as its own hash.  We keep the CCK idea (pack the tuple into one
word when the active domain allows) but swap the container: **sort +
adjacent-unique**, the bulk dedup/lookup primitive of a data-parallel device.

Relations are ``int32[capacity, arity]`` with valid rows in ``[0, count)`` and
pad rows filled with ``SENTINEL`` so that a full-table sort keeps padding at
the end.  Every sort here is stable, so equal keys keep their input order.
"""

from __future__ import annotations

import torch

# Largest int32.  All domain values must be < SENTINEL.
SENTINEL = 2**31 - 1


def compact_key(rows: torch.Tensor, domain: int) -> torch.Tensor | None:
    """Pack an ``int32[n, k]`` tuple table into a single ``int32[n]`` key.

    Returns ``None`` when ``domain ** arity`` does not fit in 31 bits — the
    caller falls back to lexicographic multi-key sorting, mirroring the
    paper's note that the CCK applies when attribute widths are small.
    Padding rows map to SENTINEL (all-SENTINEL rows stay maximal).
    """
    arity = rows.shape[1]
    if arity == 1:
        return rows[:, 0]
    if domain <= 0 or domain ** arity >= SENTINEL:
        return None
    key = rows[:, 0]
    for c in range(1, arity):
        key = key * domain + rows[:, c]       # pads wrap; remapped below
    is_pad = (rows == SENTINEL).any(dim=1)
    return torch.where(is_pad, SENTINEL, key)


def lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows lexicographically (first column primary).

    A chain of stable argsorts from the last column to the first.
    """
    order = torch.arange(rows.shape[0], device=rows.device)
    for c in range(rows.shape[1] - 1, -1, -1):
        order = order[torch.argsort(rows[order, c], stable=True)]
    return order


def argsort_rows(rows: torch.Tensor, domain: int) -> torch.Tensor:
    """Lexicographic row order: one stable sort of the compact key when the
    domain allows (FAST-DEDUP's CCK), else :func:`lexsort_rows`."""
    key = compact_key(rows, domain)
    if key is None:
        return lexsort_rows(rows)
    return torch.argsort(key, stable=True)


def sort_rows(rows: torch.Tensor, domain: int = 0) -> torch.Tensor:
    """Sort a tuple table lexicographically, pads last."""
    return rows[argsort_rows(rows, domain)]


def unique_mask(sorted_rows: torch.Tensor) -> torch.Tensor:
    """``bool[n]`` marking the first occurrence of each distinct valid row.

    Input must be row-sorted.  Padding rows (all-SENTINEL) are masked out.
    """
    neq_prev = (sorted_rows[1:] != sorted_rows[:-1]).any(dim=1)
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=sorted_rows.device), neq_prev]
    )
    return first & (sorted_rows[:, 0] != SENTINEL)


def searchsorted_rows(
    sorted_key: torch.Tensor, probe_key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 ranges of ``probe_key`` values within ``sorted_key``."""
    sorted_key = sorted_key.contiguous()
    lo = torch.searchsorted(sorted_key, probe_key, out_int32=True)
    hi = torch.searchsorted(sorted_key, probe_key, right=True, out_int32=True)
    return lo, hi


def expand_matches(
    lo: torch.Tensor, counts: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized join-match expansion.

    Given per-probe match ranges ``[lo, lo+counts)`` in the build side,
    produce for each output slot ``t`` in ``[0, capacity)``:
      * ``probe_idx[t]``  — which probe row produced slot t,
      * ``build_idx[t]``  — which build row it matched,
      * ``valid[t]``      — slot holds a real match (t < total).
    Standard offsets+searchsorted expansion; ``int32`` throughout.
    """
    offsets = torch.cumsum(counts, 0, dtype=torch.int32)        # inclusive
    total = offsets[-1] if counts.numel() else torch.zeros((), dtype=torch.int32)
    slots = torch.arange(capacity, dtype=torch.int32, device=counts.device)
    probe_idx = torch.searchsorted(offsets, slots, right=True, out_int32=True)
    probe_idx = torch.clamp(probe_idx, max=counts.shape[0] - 1)
    excl = offsets[probe_idx] - counts[probe_idx]                # exclusive offset
    build_idx = lo[probe_idx] + (slots - excl)
    valid = slots < total
    # Zero invalid slots so gathers stay in bounds; callers mask them.
    build_idx = torch.where(valid, build_idx, 0)
    probe_idx = torch.where(valid, probe_idx, 0)
    return probe_idx, build_idx, valid
