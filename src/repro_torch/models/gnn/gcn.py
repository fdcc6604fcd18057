"""GCN (Kipf & Welling, arXiv:1609.02907): H' = σ(D̂^-½ Â D̂^-½ H W).

The normalized SpMM runs on the relational substrate (gather → weighted
segment-sum).  ``forward_halo``/``loss_halo`` are the reference's
halo-exchange partitioned form over the ranks of a mesh.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import grad_psum, ppermute, psum
from repro_torch.distributed.mesh import axes_group, axis_size
from repro_torch.models.common import dense_init, new_generator
from repro_torch.models.gnn.common import (
    GNNConfig, GraphBatch, edge_mask, masked_ids, resolve_device,
)
from repro_torch.relational.segment import segment_sum


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
    """``w0 … w{L-1}`` drawn from ``generator`` (a fresh one on ``device``
    seeded with 0 when None); ``device=None`` means CUDA."""
    device = resolve_device(device, "GCN")
    if generator is None:
        generator = new_generator(device)
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


def _xent_terms(logits, labels):
    """(summed cross-entropy of the labelled nodes, their count)."""
    logits, labels = logits.float(), labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    m = (labels >= 0).float()
    return ((logz - gold) * m).sum(), m.sum()


def loss(params, g: GraphBatch, cfg: GNNConfig):
    total, count = _xent_terms(forward(params, g, cfg), g.labels)
    return total / count.clamp_min(1.0)


# --------------------------------------------------------------------------
# halo-exchange partitioned GCN
# --------------------------------------------------------------------------


def forward_halo(params, g: GraphBatch, cfg: GNNConfig, mesh, dp_axes, halo: int,
                 compute_dtype=None):
    """Spatially-partitioned GCN: nodes block-partitioned over the DP axes;
    each rank exchanges only a fixed-width HALO of boundary rows with its
    ring neighbours along ``dp_axes[-1]`` (two ``ppermute``s) instead of the
    whole node array's gradient all-reduce.

    ``g`` is this rank's part, locally indexed (the reference's contract):
    ``node_feat`` its block of N_loc nodes, ``receivers`` ∈ [0, N_loc),
    ``senders`` ∈ [0, N_loc + 2·halo) where [0, halo) = previous rank's
    tail, [halo, halo+N_loc) = local block, [halo+N_loc, …) = next rank's
    head; -1 pads.  Valid when the partitioner bounds edge cuts by ``halo``.
    Both ends of an edge are normalised by the receiver's degree, which is
    ``forward``'s symmetric normalisation where every edge joins nodes of
    equal degree (a ring lattice).  Returns this rank's logits [N_loc, C]."""
    ring = axes_group(mesh, dp_axes[-1])
    size = axis_size(mesh, dp_axes[-1])
    perm_fwd = [(i, (i + 1) % size) for i in range(size)]
    perm_bwd = [(d, s) for s, d in perm_fwd]
    # replicated weights applied to this rank's nodes: gradients sum over DP
    data = axes_group(mesh, dp_axes)
    ws = [grad_psum(params[f"w{i}"], data) for i in range(len(params))]
    h = g.node_feat
    if compute_dtype is not None:
        h = h.to(compute_dtype)
        ws = [w.to(compute_dtype) for w in ws]
    n_loc = h.shape[0]
    valid = edge_mask(g.senders)
    snd, rcv = masked_ids(g.senders, valid), masked_ids(g.receivers, valid)
    deg = torch.zeros(n_loc, device=h.device).index_add_(0, rcv, valid.float()) + 1.0
    inv = torch.rsqrt(deg)
    for i, w in enumerate(ws):
        h = h @ w
        tail = ppermute(h[-halo:], ring, perm_fwd, tag=0)    # prev → me
        head = ppermute(h[:halo], ring, perm_bwd, tag=1)     # next → me
        hx = torch.cat([tail, h, head])
        msg = torch.where(valid[:, None], hx[snd] * inv[rcv][:, None], 0.0)
        agg = torch.zeros((n_loc, h.shape[1]), dtype=h.dtype, device=h.device).index_add_(
            0, rcv, msg.to(h.dtype))
        h = agg * inv[:, None] + h * (inv * inv)[:, None]
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


def loss_halo(params, g: GraphBatch, cfg: GNNConfig, mesh=None, dp_axes=("data",),
              halo: int = 512, compute_dtype=None):
    """The mean cross-entropy over every rank's labelled nodes, on every
    rank, with the whole gradient of the replicated weights."""
    if mesh is None:
        raise ValueError("loss_halo: pass the mesh whose ranks hold the node blocks")
    logits = forward_halo(params, g, cfg, mesh, dp_axes, halo, compute_dtype)
    total, count = _xent_terms(logits, g.labels)
    data = axes_group(mesh, dp_axes)
    return psum(total, data) / psum(count, data).clamp_min(1.0)
