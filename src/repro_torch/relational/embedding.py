"""EmbeddingBag and sampled softmax: the recsys hot path as relational ops.

A bag lookup is a join with the embedding table followed by a SUM aggregate.
The dense, unweighted sum, which the two-tower serving path runs, goes to
the hand-written gather-sum kernel
(:func:`repro_torch.kernels.gather_sum.gather_sum`); every other form
(ragged bags, weights, ``mode="mean"``) is torch ops.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gather_sum import gather_sum
from repro_torch.relational.segment import segment_sum


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``max(ids, 0)``; NaN rows where an id is ≥ N
    (``jnp.take``'s fill mode, which the reference relies on)."""
    n = table.shape[0]
    rows = table[ids.clamp(0, n - 1).long()]
    return torch.where((ids >= n)[:, None], float("nan"), rows)


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    bag_ids: torch.Tensor | None = None,
    *,
    num_bags: int | None = None,
    weights: torch.Tensor | None = None,
    mode: str = "sum",
) -> torch.Tensor:
    """Ragged multi-hot lookup.

    Two layouts:
      * dense   — ``indices`` is ``int32[num_bags, K]`` (pad = -1); bag_ids None.
      * ragged  — ``indices`` is ``int32[nnz]`` with ``bag_ids int32[nnz]``.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: unknown mode {mode!r}")
    if bag_ids is None:
        if weights is None and mode == "sum":
            return gather_sum(indices, table)
        num_bags, k = indices.shape
        flat = indices.reshape(-1)
        valid = flat >= 0
        rows = torch.where(valid[:, None], _take(table, flat), 0.0)
        if weights is not None:
            rows = rows * weights.reshape(-1)[:, None]
        out = rows.reshape(num_bags, k, -1).sum(dim=1)
        if mode == "mean":
            cnt = valid.reshape(num_bags, k).sum(dim=1).clamp_min(1)
            out = out / cnt[:, None]
        return out
    if num_bags is None:
        raise ValueError("embedding_bag: the ragged layout needs num_bags")
    valid = indices >= 0
    rows = torch.where(valid[:, None], _take(table, indices), 0.0)
    if weights is not None:
        rows = rows * weights[:, None]
    out = segment_sum(rows, bag_ids, num_bags)
    if mode == "mean":
        cnt = segment_sum(valid.to(rows.dtype), bag_ids, num_bags)
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def sampled_softmax_loss(
    query: torch.Tensor,
    item: torch.Tensor,
    *,
    log_q: torch.Tensor | None = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al., RecSys'19).

    ``query`` and ``item`` are ``[B, D]`` normalized tower outputs; positives
    are the diagonal; every other in-batch item is a sampled negative whose
    logit is corrected by its sampling log-probability ``log_q``.
    """
    logits = query @ item.T / temperature                  # [B, B]
    if log_q is not None:
        logits = logits - log_q[None, :]
    logz = torch.logsumexp(logits, dim=1)
    return (logz - logits.diagonal()).mean()
