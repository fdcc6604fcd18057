"""GraphCast (Lam et al., arXiv:2212.12794), simplified encode-process-decode.

Grid nodes (n_vars weather channels) are encoded onto a coarser mesh through
a bipartite grid→mesh GNN, processed by message-passing layers on the mesh,
and decoded back mesh→grid.  Interaction blocks are MeshGraphNet-style (edge
MLP + node MLP, residual, LayerNorm).  The mesh has n_nodes/4 nodes unless
``cfg.mesh_nodes`` says otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import (
    layernorm, layernorm_init, mlp_apply, mlp_init, new_generator,
)
from repro_torch.models.gnn.common import (
    GNNConfig, GraphBatch, edge_mask, masked_ids, resolve_device, scatter_edges,
)


def _block_init(generator, d_in, d, device, n=2):
    return {"mlp": mlp_init(generator, (d_in,) + (d,) * n, device=device),
            "ln": layernorm_init(d, device=device)}


def _block(p, x):
    return layernorm(p["ln"], mlp_apply(p["mlp"], x))


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
    """Encoders, decoder and ``n_layers`` processor blocks, drawn in that
    order from ``generator``; ``device=None`` means CUDA."""
    device = resolve_device(device, "GraphCast")
    if generator is None:
        generator = new_generator(device)
    d = cfg.d_hidden
    params = {
        "grid_enc": _block_init(generator, cfg.d_in, d, device),
        "mesh_embed": _block_init(generator, 3, d, device),          # mesh node positions
        "g2m_edge": _block_init(generator, 2 * d, d, device),
        "g2m_node": _block_init(generator, 2 * d, d, device),
        "m2g_edge": _block_init(generator, 2 * d, d, device),
        "m2g_node": _block_init(generator, 2 * d, d, device),
        "decoder": mlp_init(generator, (d, d, cfg.d_out), device=device),
    }
    for i in range(cfg.n_layers):
        params[f"proc_edge_{i}"] = _block_init(generator, 3 * d, d, device)
        params[f"proc_node_{i}"] = _block_init(generator, 2 * d, d, device)
    return params


def forward(params, g: GraphBatch, cfg: GNNConfig):
    """``senders``/``receivers`` concatenate three edge sets, [g2m | m2m |
    m2g] at E/4, E/2 and E/4; ids are taken modulo the mesh's or the grid's
    size after the padded edges are masked."""
    n_grid = g.node_feat.shape[0]
    n_mesh = cfg.mesh_nodes or max(n_grid // 4, 1)
    e_total = g.senders.shape[0]
    e_g2m = e_total // 4
    e_m2m = e_total // 2

    mask = edge_mask(g.senders)
    snd = masked_ids(g.senders, mask)
    rcv = masked_ids(g.receivers, mask)

    h_grid = _block(params["grid_enc"], g.node_feat)
    if g.pos is not None:
        mesh_pos = g.pos[:n_mesh]
    else:
        mesh_pos = torch.linspace(0, 1, n_mesh * 3, dtype=torch.float32,
                                  device=h_grid.device).reshape(n_mesh, 3)
    h_mesh = _block(params["mesh_embed"], mesh_pos)

    # --- grid → mesh encoder ---
    s, r, m = snd[:e_g2m], rcv[:e_g2m] % n_mesh, mask[:e_g2m]
    e_in = torch.cat([h_grid[s % n_grid], h_mesh[r]], -1)
    e_f = _block(params["g2m_edge"], e_in)
    agg = scatter_edges(e_f, r, n_mesh, m, "sum")
    h_mesh = h_mesh + _block(params["g2m_node"], torch.cat([h_mesh, agg], -1))

    # --- mesh processor ---
    s = snd[e_g2m:e_g2m + e_m2m] % n_mesh
    r = rcv[e_g2m:e_g2m + e_m2m] % n_mesh
    m = mask[e_g2m:e_g2m + e_m2m]
    e_feat = _block(params["g2m_edge"], torch.cat([h_mesh[s], h_mesh[r]], -1))
    for i in range(cfg.n_layers):
        e_in = torch.cat([e_feat, h_mesh[s], h_mesh[r]], -1)
        e_feat = e_feat + _block(params[f"proc_edge_{i}"], e_in)
        agg = scatter_edges(e_feat, r, n_mesh, m, "sum")
        h_mesh = h_mesh + _block(params[f"proc_node_{i}"], torch.cat([h_mesh, agg], -1))

    # --- mesh → grid decoder ---
    s = snd[e_g2m + e_m2m:] % n_mesh
    r = rcv[e_g2m + e_m2m:] % n_grid
    m = mask[e_g2m + e_m2m:]
    e_in = torch.cat([h_mesh[s], h_grid[r]], -1)
    e_f = _block(params["m2g_edge"], e_in)
    agg = scatter_edges(e_f, r, n_grid, m, "sum")
    h_grid = h_grid + _block(params["m2g_node"], torch.cat([h_grid, agg], -1))

    return mlp_apply(params["decoder"], h_grid)


def loss(params, g: GraphBatch, cfg: GNNConfig):
    pred = forward(params, g, cfg)
    return torch.mean((pred - g.labels) ** 2)
