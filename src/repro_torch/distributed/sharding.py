"""Sharding rules: DP over (pod, data), TP/EP over model — the reference's
``distributed/sharding.py`` over the port's process-group mesh.

Rules are name+rank based over plain trees of tensors:

* vocab/embedding tables       → vocab dim over ``model``
* attention / FFN in-proj      → output features over ``model``  (column)
* attention / FFN out-proj     → input features over ``model``   (row)
* MoE expert stacks (E, d, f)  → expert dim over ``model``       (EP)
* norms, biases, routers       → replicated
* batch-like inputs            → leading dim over (pod, data)

Scan-stacked layer params carry a leading L dim → specs get a None prefix.
A ``None`` in a tree (an absent ``GraphBatch`` field) stays ``None``, as in
a JAX tree, where it has no leaves.

A spec is the reference's ``PartitionSpec`` as a tuple (``tuple(P(...))``
compares equal): one entry per leading dimension, an axis name, a tuple of
names or None.  A :class:`Sharding` pairs it with the mesh: a
``DeviceMesh``, or, where only the sizes are read (``param_sharding``, the
registry's cells), a plain ``{axis: size}`` mapping.  ``place`` cuts this
rank's block of every leaf and ``gather`` puts the blocks back together:
the port's ``jax.device_put(tree, shardings)`` and ``jax.device_get``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from torch.utils._pytree import tree_map, tree_map_with_path

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.mesh import axes_group, axis_sizes, dp_axes_of, shard_rows

TP = "model"

_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "w_dkv", "w_uk", "w_uv"}
_ROW = {"wo", "w_down"}
_TABLES = {"embed", "user_table", "item_table"}


@dataclass(frozen=True)
class Sharding:
    """``NamedSharding(mesh, PartitionSpec(*spec))``.  An entry naming one
    axis in a tuple is that name, as ``PartitionSpec`` normalises it."""

    mesh: Any
    spec: tuple = ()

    def __post_init__(self):
        spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in self.spec)
        object.__setattr__(self, "spec", spec)


def _path_names(path) -> list[str]:
    """A key path's names as the reference reads them: dict keys, list
    indices and NamedTuple fields alike."""
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
        elif hasattr(p, "name"):
            out.append(str(p.name))
    return out


def expert_stack(path, leaf) -> bool:
    """A routed MoE expert stack ``[(L,) E, ...]`` (not the shared experts)."""
    names = _path_names(path)
    name = names[-1] if names else ""
    base_ndim = leaf.ndim - (1 if "layers" in names else 0)
    return name in _COLUMN | _ROW and base_ndim == 3 and "shared" not in names


def lm_param_spec(path, leaf) -> tuple:
    names = _path_names(path)
    name = names[-1] if names else ""
    scanned = 1 if "layers" in names else 0
    base_ndim = leaf.ndim - scanned
    prefix = (None,) * scanned

    if name in _TABLES and leaf.ndim == 2:
        return (TP, None)
    if name == "unembed" and leaf.ndim == 2:
        return (None, TP)
    if expert_stack(path, leaf):
        return (*prefix, TP, None, None)
    if name in _COLUMN and base_ndim == 2:
        return (*prefix, None, TP)
    if name in _ROW and base_ndim == 2:
        return (*prefix, TP, None)
    return ()                                             # replicate


def _axes(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(spec, shape, mesh) -> bool:
    sizes = axis_sizes(mesh)
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            continue
        shards = 1
        for a in _axes(entry):
            shards *= sizes[a]
        if dim % shards != 0:
            return False
    return True


def param_sharding(params, mesh, spec_fn=lm_param_spec):
    """Tree of :class:`Sharding` following the rules above.

    Falls back to replication when a sharded dim is not divisible by the
    axis size (e.g. granite's vocab 49155 on 16-way ``model``): a block
    must be a whole slice.
    """

    def one(path, leaf):
        if leaf is None:
            return None
        spec = spec_fn(path, leaf)
        if not _divisible(spec, leaf.shape, mesh):
            spec = ()
        return Sharding(mesh, spec)

    return tree_map_with_path(one, params)


def batch_sharding(batch, mesh):
    """Leading (batch/edge/token) dim over all DP axes; rest replicated."""
    dp = dp_axes_of(mesh)

    def one(leaf):
        if leaf is None:
            return None
        if leaf.ndim == 0:
            return Sharding(mesh, ())
        return Sharding(mesh, (dp,) + (None,) * (leaf.ndim - 1))

    return tree_map(one, batch)


def replicated(tree, mesh):
    return tree_map(lambda x: None if x is None else Sharding(mesh, ()), tree)


def sharded_dims(sharding: Sharding):
    """(dim, axes) of each sharded dimension of a leaf."""
    return [(dim, _axes(entry)) for dim, entry in enumerate(sharding.spec)
            if entry is not None]


def place(tree, shardings):
    """This rank's block of every leaf of ``tree`` (views, no copy)."""

    def one(x, sh):
        if x is None:
            return None
        for dim, axes in sharded_dims(sh):
            x = shard_rows(x, sh.mesh, axes, dim)
        return x

    return tree_map(one, tree, shardings)


def gather(tree, shardings):
    """Every leaf whole again from the ranks' blocks (``place``'s inverse)."""

    def one(x, sh):
        if x is None:
            return None
        for dim, axes in sharded_dims(sh):
            x = all_gather(x, axes_group(sh.mesh, axes), dim)
        return x

    return tree_map(one, tree, shardings)
