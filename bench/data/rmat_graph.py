"""The RMAT-n graphs of RecStep (arXiv:1812.03975, section 6): n vertices and
10n directed edges.  A frozen copy of ``repro_torch/data/graphs.py``'s
``rmat_graph``: the same arguments, the same draws and the same edges.  Only
the dedup differs: ``np.unique`` over the int64 key ``src * n + dst`` in
place of ``np.unique(axis=0)`` over the rows, which gives the same sorted
rows in a fraction of the time, since inputs are made inside set-up."""

from __future__ import annotations

import numpy as np


def rmat_graph(n_log2: int, edge_factor: int = 10, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> dict[str, np.ndarray]:
    """Directed RMAT edge list on ``2**n_log2`` vertices from
    ``edge_factor * 2**n_log2`` draws, without self loops, deduplicated and
    sorted: ``{"arc": int32[m, 2]}``."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _level in range(n_log2):
        r = rng.random(m)
        # quadrant choice: a | b | c | d
        right = r >= a + c          # dst high bit
        bottom = ((r >= a) & (r < a + c)) | (r >= a + b + c)
        src <<= 1
        src |= bottom
        dst <<= 1
        dst |= right
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    return {"arc": np.stack([key // n, key % n], axis=1).astype(np.int32)}
