"""Input generators, copied from ``repro_torch/data/graphs.py`` (``gnp_graph``)
as of the PR that added the benchmark.  A configuration names one of them by
its function name."""

from __future__ import annotations

import numpy as np


def gnp_graph(n: int, p: float = 0.001, seed: int = 0) -> dict[str, np.ndarray]:
    """Directed Gn-p edge list as ``{"arc": int32[m, 2]}`` (no self loops,
    deduped): the paper's Gn-p graphs (§6.2)."""
    rng = np.random.default_rng(seed)
    m = rng.binomial(n * n, p)
    flat = rng.choice(n * n, size=m, replace=False) if m < n * n else np.arange(n * n)
    src, dst = flat // n, flat % n
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)
    return {"arc": np.unique(edges, axis=0)}


GENERATORS = {"gnp_graph": gnp_graph}
