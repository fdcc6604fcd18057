"""MeshGraphNet (Pfaff et al., arXiv:2010.03409).

Encode-process-decode with 15 message-passing steps; each step updates edges
with MLP(e, h_src, h_dst) and nodes with MLP(h, Σ_in e'), both residual, with
LayerNorm-ed 2-layer MLPs (the paper's exact block).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import (
    layernorm, layernorm_init, mlp_apply, mlp_init, new_generator,
)
from repro_torch.models.gnn.common import (
    GNNConfig, GraphBatch, edge_mask, masked_ids, resolve_device, scatter_edges,
)


def _block_init(generator, d_in: int, d: int, mlp_layers: int, device):
    dims = (d_in,) + (d,) * mlp_layers
    return {"mlp": mlp_init(generator, dims, device=device),
            "ln": layernorm_init(d, device=device)}


def _block_apply(p, x):
    return layernorm(p["ln"], mlp_apply(p["mlp"], x))


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
    """Encoders, ``n_layers`` edge and node blocks and the decoder, drawn in
    that order from ``generator``; ``device=None`` means CUDA."""
    device = resolve_device(device, "MeshGraphNet")
    if generator is None:
        generator = new_generator(device)
    d = cfg.d_hidden
    params = {
        "node_enc": _block_init(generator, cfg.d_in, d, cfg.mlp_layers, device),
        "edge_enc": _block_init(generator, max(cfg.d_edge, 1), d, cfg.mlp_layers, device),
        "decoder": mlp_init(generator, (d, d, cfg.d_out), device=device),
    }
    for i in range(cfg.n_layers):
        params[f"edge_{i}"] = _block_init(generator, 3 * d, d, cfg.mlp_layers, device)
        params[f"node_{i}"] = _block_init(generator, 2 * d, d, cfg.mlp_layers, device)
    return params


def forward(params, g: GraphBatch, cfg: GNNConfig):
    n = g.node_feat.shape[0]
    mask = edge_mask(g.senders)
    snd = masked_ids(g.senders, mask)
    rcv = masked_ids(g.receivers, mask)

    h = _block_apply(params["node_enc"], g.node_feat)
    if g.edge_feat is not None:
        ef = g.edge_feat
    else:
        ef = torch.ones((g.senders.shape[0], 1), dtype=h.dtype, device=h.device)
    e = _block_apply(params["edge_enc"], ef)

    for i in range(cfg.n_layers):
        e_in = torch.cat([e, h[snd], h[rcv]], dim=-1)
        e = e + _block_apply(params[f"edge_{i}"], e_in)
        agg = scatter_edges(e, rcv, n, mask, "sum")
        h = h + _block_apply(params[f"node_{i}"], torch.cat([h, agg], dim=-1))

    return mlp_apply(params["decoder"], h)


def loss(params, g: GraphBatch, cfg: GNNConfig):
    pred = forward(params, g, cfg)
    return torch.mean((pred - g.labels) ** 2)
