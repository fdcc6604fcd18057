"""The distributed layer on ``torch.distributed``: a named process grid
(``make_mesh``), collectives with the reference's transposes, and the mesh
context.  The reference's ``shard_map`` has no counterpart (each rank is a
process that runs its shard's code), nor has ``collective_bytes`` (it reads
XLA's HLO; the port's sharded steps count their own bytes); its partition
rules (``param_sharding``, ``batch_sharding``, ``lm_param_spec``) wait for
the transformer (ROADMAP A11)."""

from repro_torch.distributed.mesh import (
    axes_group,
    axis_index,
    axis_size,
    dp_axes_of,
    make_mesh,
    mesh_device,
    shard_rows,
)
from repro_torch.distributed.collectives import all_gather, grad_psum, psum, psum_scatter
from repro_torch.distributed.context import get_dp_axes, get_mesh, mesh_context

__all__ = [
    "make_mesh",
    "dp_axes_of",
    "axes_group",
    "axis_index",
    "axis_size",
    "mesh_device",
    "shard_rows",
    "psum",
    "psum_scatter",
    "all_gather",
    "grad_psum",
    "mesh_context",
    "get_mesh",
    "get_dp_axes",
]
