"""Shared GNN containers and helpers.

Message passing here is *relational*: gather(src) → combine → segment(dst),
the primitive the Datalog engine's dense aggregates lower to.  All models
consume a :class:`GraphBatch` of static shapes (padded edges, -1
sentinels).  A padded edge is masked, and its ids replaced by 0, before any
tensor is indexed with them: torch raises (on the card, a device-side
assert) where JAX clamps or drops an out-of-range index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.relational.segment import segment_max, segment_mean, segment_sum


class GraphBatch(NamedTuple):
    """Static-shape graph container (-1 edge pads).  Static quantities like
    the number of graphs are derived from shapes (``labels.shape[0]``),
    never stored."""

    node_feat: torch.Tensor            # f32[N, Din]
    senders: torch.Tensor              # int32[E]  (-1 pad)
    receivers: torch.Tensor            # int32[E]
    edge_feat: torch.Tensor | None     # f32[E, De] or None
    pos: torch.Tensor | None           # f32[N, 3] or None
    graph_ids: torch.Tensor | None     # int32[N] for batched small graphs
    labels: torch.Tensor | None        # task-dependent


@dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    arch: str = "gcn"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    d_edge: int = 0
    d_out: int = 7
    aggregator: str = "mean"
    mlp_layers: int = 2
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    # graphcast
    mesh_nodes: int = 0              # 0 → derived from graph size
    n_vars: int = 0
    task: str = "node_class"         # node_class | node_reg | graph_reg
    dtype: str = "float32"


def edge_mask(senders: torch.Tensor) -> torch.Tensor:
    return senders >= 0


def masked_ids(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``ids`` as int64 with the padded edges' entries replaced by 0."""
    return torch.where(mask, ids, 0).long()


def scatter_edges(msgs: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
                  mask: torch.Tensor, agg: str):
    msgs = torch.where(mask[:, None], msgs, 0.0)
    recv = masked_ids(receivers, mask)
    if agg == "sum":
        return segment_sum(msgs, recv, n_nodes)
    if agg == "mean":
        tot = segment_sum(msgs, recv, n_nodes)
        cnt = segment_sum(mask.to(msgs.dtype), recv, n_nodes)
        return tot / cnt.clamp_min(1.0)[:, None]
    if agg == "max":
        big = torch.where(mask[:, None], msgs, float("-inf"))
        out = segment_max(big, recv, n_nodes)
        return torch.where(torch.isfinite(out), out, 0.0)     # empty segments: 0
    raise ValueError(agg)


def graph_pool(x: torch.Tensor, graph_ids: torch.Tensor | None, n_graphs: int, mode="sum"):
    if graph_ids is None:
        return x.sum(0, keepdim=True) if mode == "sum" else x.mean(0, keepdim=True)
    if mode == "sum":
        return segment_sum(x, graph_ids, n_graphs)
    return segment_mean(x, graph_ids, n_graphs)


def resolve_device(device, what: str) -> torch.device:
    """``device``, CUDA when None; raises where CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch's {what} runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU')
    return device
