"""SchNet (Schütt et al., arXiv:1706.08566): continuous-filter convolutions.

cfconv: W(r_ij) = MLP(rbf(‖x_i − x_j‖)) gates gathered neighbor features,
then segment-sums into the center atom — the triplet-free molecular regime.
3 interaction blocks, 300 Gaussian RBFs, 10 Å cutoff, shifted-softplus
activations.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense_init, mlp_apply, mlp_init, new_generator
from repro_torch.models.gnn.common import (
    GNNConfig, GraphBatch, edge_mask, graph_pool, masked_ids, resolve_device,
)
from repro_torch.relational.segment import segment_sum


def ssp(x):
    """Shifted softplus (SchNet's activation).  ``logaddexp(x, 0)`` is
    ``jax.nn.softplus``'s own form; ``F.softplus`` returns x itself above its
    threshold of 20, within 2e-9 of it in float32."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
    """Embedding, output layers and ``n_layers`` interaction blocks, drawn in
    that order from ``generator``; ``device=None`` means CUDA."""
    device = resolve_device(device, "SchNet")
    if generator is None:
        generator = new_generator(device)
    d = cfg.d_hidden
    params = {
        "embed": dense_init(generator, cfg.d_in, d, device=device),
        "out1": dense_init(generator, d, d // 2, device=device),
        "out2": dense_init(generator, d // 2, cfg.d_out, device=device),
    }
    for i in range(cfg.n_layers):
        params[f"filter_{i}"] = mlp_init(generator, (cfg.n_rbf, d, d), device=device)
        params[f"in_{i}"] = dense_init(generator, d, d, device=device)
        params[f"post_{i}"] = mlp_init(generator, (d, d, d), device=device)
    return params


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def forward(params, g: GraphBatch, cfg: GNNConfig):
    n = g.node_feat.shape[0]
    mask = edge_mask(g.senders)
    snd = masked_ids(g.senders, mask)
    rcv = masked_ids(g.receivers, mask)

    pos = g.pos if g.pos is not None else g.node_feat.new_zeros((n, 3))
    # + 1e-9 per component: a zero-length edge (a padded one, 0 → 0) keeps a
    # finite gradient through the norm
    dist = torch.linalg.norm(pos[snd] - pos[rcv] + 1e-9, dim=-1)
    # (the reference also computes filter_0 once here and never reads it)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)

    h = g.node_feat @ params["embed"]
    for i in range(cfg.n_layers):
        filt = mlp_apply(params[f"filter_{i}"], rbf, act=ssp)
        msg = (h @ params[f"in_{i}"])[snd] * filt
        msg = torch.where(mask[:, None], msg, 0.0)
        agg = segment_sum(msg, rcv, n)
        h = h + mlp_apply(params[f"post_{i}"], agg, act=ssp)

    out = ssp(h @ params["out1"]) @ params["out2"]
    if cfg.task == "graph_reg":
        n_graphs = g.labels.shape[0] if g.labels is not None else 1
        return graph_pool(out, g.graph_ids, n_graphs, "sum")
    return out


def loss(params, g: GraphBatch, cfg: GNNConfig):
    pred = forward(params, g, cfg)
    return torch.mean((pred - g.labels) ** 2)
