"""Segment aggregation: the message-passing / group-by primitive on torch.

A Datalog rule ``h(v, AGG(e)) :- arc(u, v), g(u, e)`` lowers to
gather(g, src) → segment_AGG(dst).  Semantics follow ``jax.ops.segment_*``:
ids outside ``[0, num_segments)`` are dropped, and an empty segment holds the
reduction's identity (0 for sum, −inf / +inf for float max / min, the
dtype's least / greatest value for integers).
"""

from __future__ import annotations

import torch


def _routed(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with the out-of-range ones sent to a spare segment ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _identity(dtype: torch.dtype, largest: bool):
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _scatter(data, segment_ids, num_segments: int, reduce: str, fill):
    ids = _routed(segment_ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                     device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, reduce, include_self=True)[:num_segments]


def segment_sum(data, segment_ids, num_segments: int):
    return _scatter(data, segment_ids, num_segments, "sum", 0)


def segment_max(data, segment_ids, num_segments: int):
    return _scatter(data, segment_ids, num_segments, "amax", _identity(data.dtype, False))


def segment_min(data, segment_ids, num_segments: int):
    return _scatter(data, segment_ids, num_segments, "amin", _identity(data.dtype, True))


def segment_mean(data, segment_ids, num_segments: int):
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype, device=data.device),
                      segment_ids, num_segments)
    cnt = cnt.clamp_min(1)
    if data.dim() > 1:
        cnt = cnt.reshape((-1,) + (1,) * (data.dim() - 1))
    return tot / cnt


def segment_softmax(logits, segment_ids, num_segments: int):
    """Numerically-stable softmax over variable-size segments (edge softmax)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = segment_ids.long()
    exp = torch.exp(logits - seg_max[ids])
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / denom[ids].clamp_min(1e-30)


def degree(segment_ids, num_segments: int):
    return segment_sum(
        torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device),
        segment_ids, num_segments,
    )


def gather_scatter(
    node_feats: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    *,
    edge_weight: torch.Tensor | None = None,
    agg: str = "sum",
) -> torch.Tensor:
    """One relational message-passing step: gather(src) → [×w] → segment(dst)."""
    msgs = node_feats[src.long()]
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None]
    if agg == "sum":
        return segment_sum(msgs, dst, num_nodes)
    if agg == "mean":
        return segment_mean(msgs, dst, num_nodes)
    if agg in ("max", "min"):
        reduce = segment_max if agg == "max" else segment_min
        out = reduce(msgs, dst, num_nodes)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown aggregator {agg!r}")
