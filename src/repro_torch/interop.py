"""Carry relation state across from the reference package, numpy only.

The reference's per-relation ``to_blocks()`` output, ``{name: (meta,
arrays)}``, is the exchange format: the same dicts and arrays its snapshot
codec writes.  :func:`store_from_reference` builds the port's handles from it
(same rows, counts and capacities), and each handle's ``to_blocks()`` gives
back byte-identical arrays.  A packed PBME matrix crosses as ``uint32`` words
reinterpreted as ``int32``.

:func:`two_tower_from_reference` carries the reference's two-tower
``init_params`` pytree, as numpy arrays, into the port's ``TwoTower``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.relation import DenseAggRelation, DenseSetRelation, TupleRelation
from repro_torch.models.recsys import RecsysConfig, TwoTower

_KINDS = {
    "tuple": TupleRelation,
    "dense_set": DenseSetRelation,
    "dense_agg": DenseAggRelation,
}


def store_from_reference(
    blocks: dict[str, tuple[dict, dict[str, np.ndarray]]], device
) -> dict[str, Any]:
    """``{name: (meta, arrays)}`` → ``{name: handle}`` on ``device``."""
    store = {}
    for name, (meta, arrays) in blocks.items():
        kind = meta.get("kind")
        if kind not in _KINDS:
            raise ValueError(f"unknown relation kind {kind!r} for {name!r}")
        store[name] = _KINDS[kind].from_blocks(name, meta, arrays, device)
    return store


def store_to_blocks(store: dict[str, Any]) -> dict[str, tuple[dict, dict[str, np.ndarray]]]:
    """The inverse of :func:`store_from_reference`."""
    return {name: handle.to_blocks() for name, handle in store.items()}


def bitmatrix_from_reference(words: np.ndarray, device) -> torch.Tensor:
    """Packed ``uint32[n, w]`` → the port's ``int32[n, w]`` (same bits)."""
    return torch.as_tensor(np.ascontiguousarray(words, np.uint32).view(np.int32),
                           device=device)


def bitmatrix_to_reference(packed: torch.Tensor) -> np.ndarray:
    """The port's packed ``int32`` words → ``uint32`` (same bits)."""
    return packed.cpu().numpy().view(np.uint32)


def two_tower_from_reference(params: dict, cfg: RecsysConfig, device) -> TwoTower:
    """The reference's ``init_params(key, cfg)`` pytree (arrays as numpy) →
    a ``TwoTower`` on ``device`` holding the same weights, in the same
    ``[d_in, d_out]`` layout."""
    model = TwoTower(cfg, device=device)
    own = {
        "user_table": model.user_table,
        "item_table": model.item_table,
        **{f"user_mlp.{k}": v for k, v in model.user_mlp.items()},
        **{f"item_mlp.{k}": v for k, v in model.item_mlp.items()},
    }
    given = {
        "user_table": params["user_table"],
        "item_table": params["item_table"],
        **{f"user_mlp.{k}": v for k, v in params["user_mlp"].items()},
        **{f"item_mlp.{k}": v for k, v in params["item_mlp"].items()},
    }
    if own.keys() != given.keys():
        raise ValueError(f"two_tower_from_reference: parameters {sorted(given)}, "
                         f"the config makes {sorted(own)}")
    for name, arr in given.items():
        arr = np.asarray(arr)
        if arr.shape != tuple(own[name].shape):
            raise ValueError(f"two_tower_from_reference: {name} has shape {arr.shape}, "
                             f"the config makes {tuple(own[name].shape)}")
        own[name].data.copy_(torch.tensor(arr, dtype=own[name].dtype))
    return model
