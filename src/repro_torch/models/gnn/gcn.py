"""GCN (Kipf & Welling, arXiv:1609.02907): H' = σ(D̂^-½ Â D̂^-½ H W).

The normalized SpMM runs on the relational substrate (gather → weighted
segment-sum).  The reference's halo-exchange form (``forward_halo``,
``loss_halo``: ``shard_map`` with ``ppermute``) waits for the port's sharding
rules (ROADMAP A11).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import dense_init
from repro_torch.models.gnn.common import (
    GNNConfig, GraphBatch, edge_mask, masked_ids, resolve_device,
)
from repro_torch.relational.segment import segment_sum


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
    """``w0 … w{L-1}`` drawn from ``generator`` (a fresh one on ``device``
    seeded with 0 when None); ``device=None`` means CUDA."""
    device = resolve_device(device, "GCN")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {f"w{i}": dense_init(generator, dims[i], dims[i + 1], device=device)
            for i in range(len(dims) - 1)}


def _norm_coeffs(g: GraphBatch, n: int):
    mask = edge_mask(g.senders)
    ones = mask.float()
    snd = masked_ids(g.senders, mask)
    rcv = masked_ids(g.receivers, mask)
    deg_out = segment_sum(ones, snd, n) + 1.0      # +1: self loops
    deg_in = segment_sum(ones, rcv, n) + 1.0
    return mask, snd, rcv, torch.rsqrt(deg_out), torch.rsqrt(deg_in)


def forward(params, g: GraphBatch, cfg: GNNConfig):
    n = g.node_feat.shape[0]
    mask, snd, rcv, inv_out, inv_in = _norm_coeffs(g, n)
    x = g.node_feat
    n_layers = len(params)
    coeff = torch.where(mask, inv_out[snd] * inv_in[rcv], 0.0)
    for i in range(n_layers):
        x = x @ params[f"w{i}"]
        agg = segment_sum(x[snd] * coeff[:, None], rcv, n)
        x = agg + x * (inv_in * inv_in)[:, None]   # sym-normalized self loop
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def loss(params, g: GraphBatch, cfg: GNNConfig):
    logits = forward(params, g, cfg).float()
    labels = g.labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    m = (labels >= 0).float()
    return ((logz - gold) * m).sum() / m.sum().clamp_min(1.0)
