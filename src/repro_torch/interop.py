"""Carry relation state across from the reference package, numpy only.

The reference's per-relation ``to_blocks()`` output, ``{name: (meta,
arrays)}``, is the exchange format: the same dicts and arrays its snapshot
codec writes.  :func:`store_from_reference` builds the port's handles from it
(same rows, counts and capacities), and each handle's ``to_blocks()`` gives
back byte-identical arrays.  A packed PBME matrix crosses as ``uint32`` words
reinterpreted as ``int32``.

:func:`two_tower_from_reference` carries the reference's two-tower
``init_params`` pytree, as numpy arrays, into the port's ``TwoTower``.
:func:`train_state_from_reference` and :func:`train_state_to_reference`
carry a train state (params, AdamW's ``mu``, ``nu`` and ``count``, the
step) across in the reference's tree layout, numpy on the reference's side.
:func:`transformer_params_from_reference` carries the reference's transformer
``init_params`` pytree (numpy leaves, bfloat16 ones included) into the port's
parameter dict, stacked ``layers`` axis and ``prefix`` list as they are.
:func:`gnn_params_from_reference` and :func:`gnn_params_to_reference` carry a
GNN's parameters (any of ``models.gnn.MODELS``) across, and
:func:`graph_batch_from_reference` a ``GraphBatch``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.core.relation import relation_from_blocks
from repro_torch.models.gnn import MODELS as GNN_MODELS
from repro_torch.models.gnn import GNNConfig, GraphBatch
from repro_torch.models.recsys import RecsysConfig, TwoTower
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.transformer import init_params as transformer_init
from repro_torch.train.state import TrainState


def store_from_reference(
    blocks: dict[str, tuple[dict, dict[str, np.ndarray]]], device
) -> dict[str, Any]:
    """``{name: (meta, arrays)}`` → ``{name: handle}`` on ``device``."""
    return {
        name: relation_from_blocks(name, meta, arrays, device)
        for name, (meta, arrays) in blocks.items()
    }


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


def train_state_from_reference(state, device) -> TrainState:
    """The reference's ``TrainState(params, opt, step)`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) → the port's, on ``device``, with the
    same tree paths and dtypes."""
    params, opt, step = state

    def conv(a):
        return torch.tensor(np.asarray(a), device=device)

    return TrainState(tree_map(conv, params), tree_map(conv, opt), conv(step))


def train_state_to_reference(state: TrainState) -> tuple:
    """The inverse: ``(params, opt, step)`` as numpy trees, in the reference's
    layout (``repro.train.TrainState(*out)`` rebuilds its state)."""

    def conv(t):
        return t.detach().cpu().numpy().copy()

    return tree_map(conv, state.params), tree_map(conv, state.opt), conv(state.step)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array → a tensor on ``device``; numpy's bfloat16 (``ml_dtypes``,
    as JAX hands it out) crosses bit for bit through a ``uint16`` view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def transformer_params_from_reference(params, cfg: TransformerConfig, device) -> dict:
    """The reference's transformer ``init_params(key, cfg)`` pytree, leaves as
    numpy (``jax.tree.map(np.asarray, params)``) → the port's parameter dict on
    ``device``, with the same keys, shapes and dtypes."""
    out = tree_map(lambda a: _tensor(a, device), params)
    _same_tree(out, transformer_init(cfg, torch.Generator(), device="meta"), "params",
               "transformer_params_from_reference")
    return out


def _same_tree(got, want, path: str, who: str) -> None:
    """Raise unless ``got`` has ``want``'s keys, list lengths, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise ValueError(f"{who}: {path} has "
                             f"{sorted(got) if isinstance(got, dict) else type(got).__name__}, "
                             f"the config makes {sorted(want)}")
        for key in want:
            _same_tree(got[key], want[key], f"{path}.{key}", who)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"{who}: {path} is not a list of {len(want)} layers")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]", who)
    elif got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{who}: {path} is {got.dtype}{list(got.shape)}, the config makes "
                         f"{want.dtype}{list(want.shape)}")


def _to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def transformer_params_to_reference(params) -> dict:
    """The inverse, as a tree of numpy arrays; a bfloat16 leaf comes back as
    float32 holding the same values (numpy has no bfloat16 of its own)."""
    return tree_map(_to_numpy, params)


def gnn_params_from_reference(params, cfg: GNNConfig, device) -> dict:
    """A reference GNN's ``init_params(key, cfg)`` pytree, leaves as numpy →
    the port's parameter dict for ``cfg.arch`` on ``device``, with the same
    keys, shapes and dtypes."""
    out = tree_map(lambda a: _tensor(a, device), params)
    want = GNN_MODELS[cfg.arch].init_params(cfg, torch.Generator(), device="meta")
    _same_tree(out, want, "params", "gnn_params_from_reference")
    return out


def gnn_params_to_reference(params) -> dict:
    """The inverse, as a tree of numpy arrays."""
    return tree_map(_to_numpy, params)


def graph_batch_from_reference(g, device) -> GraphBatch:
    """A reference ``GraphBatch`` (arrays or numpy, ``None`` fields kept) →
    the port's, its tensors on ``device``."""
    return GraphBatch(*(None if f is None else _tensor(f, device) for f in g))
