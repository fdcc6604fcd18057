"""RecStep's synthetic program-fact datasets for Andersen's points-to analysis
(arXiv:1812.03975, section 6), dataset ``scale`` of the series of 7.  A
frozen copy of ``repro_torch/data/program_facts.py``'s ``andersen_facts``:
the same arguments, the same draws and the same rows.  It returns the
relations alone, where the port's returns ``(relations, n)``; the
configuration gives ``n`` as its ``nodes``."""

from __future__ import annotations

import numpy as np


def _rel(rng, n_vars: int, m: int) -> np.ndarray:
    e = rng.integers(0, n_vars, size=(m, 2), dtype=np.int64).astype(np.int32)
    return np.unique(e, axis=0)


def andersen_facts(scale: int, seed: int = 0) -> dict[str, np.ndarray]:
    """``addressOf``, ``assign``, ``load`` and ``store`` over
    ``n = int(60 * 2.2 ** (scale - 1))`` variables: 0.8 n, 1.5 n, 0.4 n and
    0.4 n uniform draws of pairs, each relation deduplicated and sorted."""
    rng = np.random.default_rng(seed + scale)
    n_vars = int(60 * (2.2 ** (scale - 1)))
    return {
        "addressOf": _rel(rng, n_vars, int(0.8 * n_vars)),
        "assign": _rel(rng, n_vars, int(1.5 * n_vars)),
        "load": _rel(rng, n_vars, int(0.4 * n_vars)),
        "store": _rel(rng, n_vars, int(0.4 * n_vars)),
    }
