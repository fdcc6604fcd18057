"""Error-feedback int8 gradient compression for the DP all-reduce.

Before the data-parallel sum, each rank quantizes its local gradient to
int8 with a per-tensor scale; the quantization residual is carried in an
**error-feedback buffer** added back the next step (Seide et al. '14 /
Karimireddy et al. '19 — EF-SGD converges at the uncompressed rate).

As in the reference (``grad_compress.py:31-53``), what crosses the wire is
the *dequantized float32* gradient: 4 bytes per element, the rounding of
int8 without its bandwidth.  The error buffers are updated in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.linalg.vector_norm(x, float("inf")) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_state_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum(grads, error_state, group=None):
    """int8-rounded sum with error feedback over ``group`` (the default
    group when None).  Returns (mean gradient across the group, the error
    state, whose buffers now hold the new residuals)."""
    n = dist.get_world_size(group)

    def one(g, e):
        g32 = e.add_(g.to(torch.float32))        # g + e, in the error buffer
        q, scale = quantize_int8(g32)
        local = dequantize_int8(q, scale)
        del q
        g32.sub_(local)                          # residual kept locally
        dist.all_reduce(local, group=group)      # the dequantized float32 values
        return (local / n).to(g.dtype)

    flat_g, spec = tree_flatten(grads)
    flat_e = tree_leaves(error_state)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return tree_unflatten(out, spec), error_state
