"""Graph generators: Gn-p (GTgraph-style), RMAT, mesh graphs, molecule batches.

Gn-p and RMAT follow the paper's benchmark setup (§6.2): Gn-p graphs are
dense Erdős–Rényi with p defaulting to 0.001; RMAT-n has n vertices and 10n
directed edges with the standard (0.57, 0.19, 0.19, 0.05) quadrant weights.
"""

from __future__ import annotations

import numpy as np


def gnp_graph(n: int, p: float = 0.001, seed: int = 0) -> np.ndarray:
    """Directed Gn-p edge list int32[m, 2] (no self loops, deduped)."""
    rng = np.random.default_rng(seed)
    m_expect = int(n * n * p)
    # sample edge indices directly (n² can be large but n ≤ ~100k here)
    m = rng.binomial(n * n, p) if n * n < 1 << 62 else m_expect
    flat = rng.choice(n * n, size=m, replace=False) if m < n * n else np.arange(n * n)
    src, dst = flat // n, flat % n
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)
    return np.unique(edges, axis=0)


def rmat_graph(n_log2: int, edge_factor: int = 10, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> np.ndarray:
    """RMAT graph: 2**n_log2 vertices, edge_factor·n directed edges."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        # quadrant choice: a | b | c | d
        right = r >= a + c          # dst high bit
        bottom = ((r >= a) & (r < a + c)) | (r >= a + b + c)
        src = (src << 1) | bottom.astype(np.int64)
        dst = (dst << 1) | right.astype(np.int64)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    keep = edges[:, 0] != edges[:, 1]
    return np.unique(edges[keep], axis=0)


def chain_graph(n: int) -> np.ndarray:
    return np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).astype(np.int32)


def random_graph(n: int, m: int, seed: int = 0, weights: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = np.unique(rng.integers(0, n, size=(m, 2)), axis=0).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if weights:
        w = rng.integers(1, 100, size=len(edges)).astype(np.int32)
        return np.concatenate([edges, w[:, None]], axis=1)
    return edges


def grid_mesh_graph(n_nodes: int, n_edges: int, seed: int = 0):
    """Deterministic synthetic connectivity for mesh GNNs / GraphCast.

    Returns (senders, receivers) int32[n_edges]: a ring lattice plus random
    chords — connected, bounded degree, reproducible.
    """
    rng = np.random.default_rng(seed)
    k = max(n_edges // n_nodes, 1)
    base_s = np.repeat(np.arange(n_nodes), k)
    base_r = (base_s + np.tile(np.arange(1, k + 1), n_nodes)) % n_nodes
    extra = n_edges - len(base_s)
    if extra > 0:
        es = rng.integers(0, n_nodes, size=extra)
        er = rng.integers(0, n_nodes, size=extra)
        senders = np.concatenate([base_s, es])
        receivers = np.concatenate([base_r, er])
    else:
        senders, receivers = base_s[:n_edges], base_r[:n_edges]
    return senders.astype(np.int32), receivers.astype(np.int32)


def batched_molecules(batch: int, n_atoms: int, n_bonds: int, d_feat: int, seed: int = 0):
    """Batched small graphs (``molecule`` shape): block-diagonal edge list."""
    rng = np.random.default_rng(seed)
    senders, receivers, graph_ids = [], [], []
    for g in range(batch):
        s, r = grid_mesh_graph(n_atoms, n_bonds, seed=seed + g)
        senders.append(s + g * n_atoms)
        receivers.append(r + g * n_atoms)
        graph_ids.append(np.full(n_atoms, g, np.int32))
    feats = rng.standard_normal((batch * n_atoms, d_feat)).astype(np.float32)
    pos = rng.standard_normal((batch * n_atoms, 3)).astype(np.float32)
    return (
        feats,
        np.concatenate(senders),
        np.concatenate(receivers),
        np.concatenate(graph_ids),
        pos,
    )
