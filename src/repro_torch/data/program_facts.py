"""Synthetic program-analysis EDBs (paper §6.2: 7 Andersen datasets scaled
from a tiny real program's characteristics; CSPA/CSDA system-program shapes).

Generated with realistic proportions: assignments dominate, loads/stores are
~¼ of assignments, address-of roughly tracks variable count.
"""

from __future__ import annotations

import numpy as np


def _rel(rng, n_vars: int, m: int) -> np.ndarray:
    e = rng.integers(0, n_vars, size=(m, 2), dtype=np.int64).astype(np.int32)
    return np.unique(e, axis=0)


def andersen_facts(scale: int, seed: int = 0) -> tuple[dict[str, np.ndarray], int]:
    """Dataset ``scale`` ∈ 1..7 — n_vars grows geometrically (paper Fig 9b)."""
    rng = np.random.default_rng(seed + scale)
    n_vars = int(60 * (2.2 ** (scale - 1)))
    edb = {
        "addressOf": _rel(rng, n_vars, int(0.8 * n_vars)),
        "assign": _rel(rng, n_vars, int(1.5 * n_vars)),
        "load": _rel(rng, n_vars, int(0.4 * n_vars)),
        "store": _rel(rng, n_vars, int(0.4 * n_vars)),
    }
    return edb, n_vars


def cspa_facts(n_vars: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "assign": _rel(rng, n_vars, int(1.2 * n_vars)),
        "dereference": _rel(rng, n_vars, int(0.9 * n_vars)),
    }


def csda_facts(n_nodes: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Context-sensitive dataflow: long sparse control-flow chains (the
    many-iteration workload where the paper's per-query overhead hurts)."""
    rng = np.random.default_rng(seed)
    # several long chains + sparse cross edges
    n_chains = max(n_nodes // 500, 1)
    chain_len = n_nodes // n_chains
    arcs = []
    for c in range(n_chains):
        base = c * chain_len
        idx = np.arange(base, base + chain_len - 1)
        arcs.append(np.stack([idx, idx + 1], axis=1))
    cross = rng.integers(0, n_nodes, size=(n_nodes // 10, 2))
    arc = np.unique(np.concatenate(arcs + [cross]), axis=0).astype(np.int32)
    null_edge = np.stack(
        [rng.integers(0, n_nodes, n_chains), rng.integers(0, n_nodes, n_chains)],
        axis=1,
    ).astype(np.int32)
    return {"arc": arc, "nullEdge": null_edge}
