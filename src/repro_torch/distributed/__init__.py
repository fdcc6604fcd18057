"""The distributed layer on ``torch.distributed``: a named process grid
(``make_mesh``), collectives with the reference's transposes, the mesh
context, and the partition rules (``param_sharding``, ``batch_sharding``,
``lm_param_spec``) with ``place``/``gather`` for this rank's blocks, and
``collective_bytes``, which counts this rank's collective traffic at the
dispatcher as the reference counts it in XLA's HLO.  The reference's
``shard_map`` has no counterpart (each rank is a process that runs its
shard's code)."""

from repro_torch.distributed.mesh import (
    axes_group,
    axis_index,
    axis_size,
    axis_sizes,
    dp_axes_of,
    make_mesh,
    mesh_device,
    shard_rows,
)
from repro_torch.distributed.collectives import (
    all_gather, grad_psum, pmean, ppermute, psum, psum_scatter,
)
from repro_torch.distributed.context import get_dp_axes, get_mesh, mesh_context
from repro_torch.distributed.sharding import (
    Sharding,
    batch_sharding,
    gather,
    lm_param_spec,
    param_sharding,
    place,
    replicated,
)
from repro_torch.distributed.traffic import collective_bytes

__all__ = [
    "make_mesh",
    "dp_axes_of",
    "axes_group",
    "axis_index",
    "axis_size",
    "axis_sizes",
    "mesh_device",
    "shard_rows",
    "psum",
    "pmean",
    "psum_scatter",
    "all_gather",
    "grad_psum",
    "ppermute",
    "mesh_context",
    "get_mesh",
    "get_dp_axes",
    "Sharding",
    "lm_param_spec",
    "param_sharding",
    "batch_sharding",
    "replicated",
    "place",
    "gather",
    "collective_bytes",
]
