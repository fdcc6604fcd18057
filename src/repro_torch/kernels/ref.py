"""Plain PyTorch versions of the hand-written kernels (the correctness contract).

Packed bit matrices are ``int32[rows, words]``: bit j of word w is column
32w + j, the reference's uint32 layout reinterpreted as signed words (a numpy
``uint32`` array crosses over with ``arr.view(np.int32)``).  Bit 31 is a real
column, so every shift here is followed by a mask.

``bitmm_plain`` unpacks to ``{0,1}`` float32 and multiplies.  Each output
entry counts matching bits, at most K < 2**24, so float32 holds it exactly;
TF32 keeps the {0,1} inputs exact and accumulates in float32 as well, so the
result is exact with or without ``allow_tf32``.

``edges_to_bitmatrix_plain`` and ``bitmatrix_to_rows_plain`` convert between
(row, col) pairs and a packed n × n matrix through a dense ``bool[n, n]``.

``gather_sum_plain`` is the embedding-bag / ELL SpMM row sum, in float32.

``dense_agg_update_plain`` is one round of the dense MIN/MAX table's update,
each buffer scattered with ``scatter_reduce``.
"""

from __future__ import annotations

import torch

WORD = 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def unpack_bits(packed: torch.Tensor, m: int | None = None) -> torch.Tensor:
    """int32[n, w] → bool[n, m] (``m`` defaults to 32·w)."""
    n, w = packed.shape
    bits = (packed[:, :, None] >> _shifts(packed.device)) & 1
    out = bits.reshape(n, w * WORD).to(torch.bool)
    return out[:, :m] if m is not None else out


def pack_bits(dense: torch.Tensor) -> torch.Tensor:
    """bool[n, m] → int32[n, ceil(m/32)], zero bits past column m.

    Words are summed in int64 (bit 31 alone is 2**31) and cast down, which
    wraps to the same 32 bits.
    """
    n, m = dense.shape
    pad = (-m) % WORD
    if pad:
        dense = torch.cat([dense, dense.new_zeros((n, pad))], dim=1)
    d = dense.reshape(n, -1, WORD).to(torch.int64)
    return (d << _shifts(dense.device).to(torch.int64)).sum(dim=-1).to(torch.int32)


def edges_to_bitmatrix_plain(edges: torch.Tensor, n: int) -> torch.Tensor:
    """int32[m, 2] edge list (on the target device) → packed int32[n, ceil(n/32)]."""
    dense = torch.zeros((n, n), dtype=torch.bool, device=edges.device)
    dense[edges[:, 0].long(), edges[:, 1].long()] = True
    return pack_bits(dense)


def bitmatrix_to_rows_plain(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Set bits as ``int32[count, 2]`` (row, col) pairs in lexicographic order."""
    return torch.nonzero(unpack_bits(packed, n)).to(torch.int32)


def bitmm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ⊛ B over the OR-AND semiring on packed operands.

    a: int32[M, ceil(K/32)], b: int32[K, Nw] → int32[M, Nw].  A's bits at
    columns ≥ K are ignored.
    """
    k, nw = b.shape
    af = unpack_bits(a, k).to(torch.float32)
    bf = unpack_bits(b).to(torch.float32)
    return pack_bits((af @ bf) > 0.0)


def bitmm_fused_delta_plain(
    a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One PBME iteration: Δ' = (A⊛B) & ~M;  M' = M | Δ'."""
    delta = bitmm_plain(a, b) & ~m
    return delta, m | delta


def gather_sum_plain(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k x[idx[b, k]] over idx ≥ 0: idx int32[B, K], x [N, D] → [B, D].

    Rows are summed in float32 and cast to ``x.dtype`` once.  A bag holding
    an id ≥ N is NaN in every column, as ``jnp.take``'s fill mode makes it in
    the reference's ``embedding_bag``; no row past N − 1 is read.
    """
    n = x.shape[0]
    rows = x[idx.clamp(0, n - 1).long()].float()                  # [B, K, D]
    out = torch.where((idx >= 0)[..., None], rows, 0.0).sum(dim=1)
    out = torch.where((idx >= n).any(dim=1)[:, None], float("nan"), out)
    return out.to(x.dtype)


def dense_agg_update_plain(
    values: torch.Tensor, op: str, buffers
) -> tuple[torch.Tensor, torch.Tensor, int, int, int]:
    """One round of a MIN/MAX table: each buffer ``(keys, vals, valid)`` in
    turn, valid keys clamped to ``[0, n)``, invalid slots sent to key 0 with
    the absent value.  Returns ``(values', Δ, candidates, count, delta_count)``:
    Δ the union of every buffer's improvements, ``candidates`` the valid
    slots, ``count`` the keys present."""
    from repro_torch.relational.sort import SENTINEL   # repro_torch.relational imports this module

    n = values.shape[0]
    absent = SENTINEL if op == "MIN" else -SENTINEL
    delta = torch.zeros(n, dtype=torch.bool, device=values.device)
    candidates = 0
    for candidate_keys, candidate_vals, valid in buffers:
        keys = torch.where(valid, torch.clamp(candidate_keys, 0, n - 1), 0).long()
        vals = torch.where(valid, candidate_vals, absent).to(torch.int32)
        best = torch.full((n,), absent, dtype=torch.int32, device=values.device)
        if op == "MIN":
            best = best.scatter_reduce(0, keys, vals, "amin", include_self=True)
            improved = best < values
            values = torch.minimum(values, best)
        else:
            best = best.scatter_reduce(0, keys, vals, "amax", include_self=True)
            improved = best > values
            values = torch.maximum(values, best)
        delta = delta | improved
        candidates += int(valid.sum())
    return values, delta, candidates, int((values != absent).sum()), int(delta.sum())
