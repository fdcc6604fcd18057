"""The process grid: a named ``DeviceMesh`` over ``torch.distributed`` ranks.

The reference names the axes of a ``jax.sharding.Mesh`` and lets
``shard_map`` bind them; here every rank is one process and an axis is a
process group.  ``make_mesh`` wraps ``init_device_mesh``; the caller
initialises the default group first (NCCL on the card, gloo on the CPU,
with an explicit ``init_method``, world size and rank: nothing on a
machine tells a program of a cluster).

A rank's coordinate along an axis plays ``jax.lax.axis_index``; a group
over several axes (a flattened sub-mesh) plays a tuple of axis names.
Its ranks are in the mesh's row-major order, which is the order in which
the reference tiles a dimension sharded over those axes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._python_dispatch import _disable_current_modes


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group.

    ``device=None`` means CUDA, which raises where there is none (pass
    ``device="cpu"`` for gloo ranks on the CPU)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch make_mesh runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to build a mesh of CPU ranks'
        )
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: initialise torch.distributed first "
            "(init_process_group with an init_method, world_size and rank)"
        )
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_group(mesh: DeviceMesh, axes) -> dist.ProcessGroup:
    """The process group of this rank over ``axes`` (one name or several)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # slicing a mesh computes on its table of ranks, a host tensor: outside
    # any dispatch mode, so that a shapes-only trace does not make it fake
    with _disable_current_modes():
        return mesh[axes]._flatten().get_group()


def axis_size(mesh: DeviceMesh, axes) -> int:
    size = 1
    for a in _axes(axes):
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's row-major coordinate over ``axes``."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in _axes(axes):
        dim = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(dim) + coord[dim]
    return idx


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or of a plain mapping that
    stands for one (the rules read only the sizes, so they can be checked
    at a production mesh's sizes without its ranks)."""
    if isinstance(mesh, DeviceMesh):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def shard_rows(x: torch.Tensor, mesh: DeviceMesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` cut evenly along ``dim`` over ``axes``
    (the reference's ``PartitionSpec`` entry for that dimension)."""
    shards = axis_size(mesh, axes)
    if x.shape[dim] % shards:
        raise ValueError(f"shard_rows: dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {shards} shards of {_axes(axes)}")
    size = x.shape[dim] // shards
    return x.narrow(dim, axis_index(mesh, axes) * size, size)
