"""A cell's inputs from its configuration and the run's seed.

The configuration's generator draws one fixed instance (its own ``seed``
argument), the deployment the configuration stands for, and the held-out
update rows are one fixed draw from it.  The run's seed relabels its nodes
by a permutation, shuffles each relation's rows and draws the read keys:
every seed gets the same rows, the same updates and the same work, in
another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from bench.harness.spec import ROOT, generator

#: reads drawn ahead of a window; a window that uses more starts again
READ_DRAWS = 1 << 20
#: the seed of the held-out rows' one draw from the instance
HELD_OUT_DRAW = 0


@dataclass
class Inputs:
    edb: dict[str, np.ndarray]       # host int32 rows, as handed to both sides
    n: int                           # the active domain [0, n)
    held: np.ndarray | None = None   # the update relation's held-out rows
    read_keys: np.ndarray | None = None   # READ_DRAWS keys, in request order


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def make(config: dict, traffic: dict, seed: int, root: Path = ROOT) -> Inputs:
    spec = config["edb"]
    raw = generator(spec["generator"], root)(**spec["args"])
    n = config["nodes"]
    rng = rng_of(seed, 0)
    perm = rng.permutation(n).astype(np.int32)
    serve = traffic["kind"] == "serve"
    held = None
    if serve:
        # the same rows for every seed, relabeled: which rows go changes
        # the work of every delete
        held = perm[_held_out(config["serve"]["update"], raw, rng_of(HELD_OUT_DRAW, 1))]
    edb = {}
    for rel, rows in raw.items():
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise ValueError(f"{rel}: node ids outside [0, {n})")
        edb[rel] = np.ascontiguousarray(perm[rows][rng.permutation(len(rows))])
    read_keys = _read_keys(traffic["reads"]["zipf"], n, rng_of(seed, 2)) if serve else None
    return Inputs(edb, n, held, read_keys)


def _held_out(spec: dict, raw: dict[str, np.ndarray], rng) -> np.ndarray:
    """``share`` of the relation's rows, drawn at random."""
    rows = raw[spec["relation"]]
    k = max(1, round(len(rows) * spec["share"]))
    return rows[np.sort(rng.choice(len(rows), size=k, replace=False))]


def _read_keys(zipf: float, n: int, rng) -> np.ndarray:
    """Zipf(``zipf``) over the domain's nodes in a seed-permuted order."""
    keys = rng.permutation(n)
    weights = 1.0 / np.arange(1, n + 1) ** zipf
    return keys[rng.choice(n, size=READ_DRAWS, p=weights / weights.sum())]
