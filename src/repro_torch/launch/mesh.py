"""Production mesh construction.

A FUNCTION, not a module-level constant: importing this module touches no
device and no process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.mesh import make_mesh


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (data=16, model=16), 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16), 512 ranks across 2 pods; the
    ``pod`` axis carries only the DP gradient all-reduce.

    The caller initialises ``torch.distributed`` with that many ranks first;
    ``device`` as ``distributed.make_mesh``'s (CUDA when None)."""
    shape, axes = production_shape(multi_pod)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of {need} ranks "
            f"as a {shape} {axes} mesh; torch.distributed has "
            + (f"{world}" if world else "no process group"))
    return make_mesh(shape, axes, device=device)
