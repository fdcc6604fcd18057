"""Gather-sum (embedding bag / ELL SpMM): the wrapper over ``csrc/gather_sum.cu``.

``out[b] = Σ_k x[idx[b, k]]`` with ``idx < 0`` masked, for ``idx`` int32[B, K]
and ``x`` float32 or bfloat16 [N, D]; the result is [B, D] in ``x.dtype``,
summed in float32.  A bag holding an id ≥ N comes out NaN (see
:func:`repro_torch.kernels.ref.gather_sum_plain`).

A CUDA tensor launches the hand-written kernel on PyTorch's current stream
(no synchronisation; the output allocated here with ``torch.empty``) or
raises; a CPU tensor runs the plain version.  ``gather_sum.launches`` counts
kernel launches.  The kernel has no backward: serving only.  A fake CUDA
tensor (a shapes-only trace, ``launch/dryrun.py``) gets an output of the
kernel's shape and dtype, and nothing is built or launched: such calls count
in ``gather_sum.fake_calls``.

The kernel takes bags in tiles and fetches a row that repeats within a tile
once, into shared memory (``csrc/gather_sum.cu``), so callers should hand it
all their bags over one table in one call: the two-tower model passes every
field of a batch as one ``[B·F, K]`` view.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gather_sum_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ids per bag at most: a bag's ids and their hash table must fit beside the
#: row stage in one block's shared memory
MAX_K = 1536


def _check(idx: torch.Tensor, x: torch.Tensor) -> None:
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(
            f"gather_sum: idx must be a 2-D torch.int32 tensor, got "
            f"{getattr(idx, 'dtype', type(idx))} with shape {tuple(getattr(idx, 'shape', ()))}"
        )
    if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES or x.dim() != 2:
        raise ValueError(
            f"gather_sum: x must be a 2-D float32 or bfloat16 tensor, got "
            f"{getattr(x, 'dtype', type(x))} with shape {tuple(getattr(x, 'shape', ()))}"
        )
    if x.device != idx.device:
        raise ValueError(f"gather_sum: x is on {x.device}, idx is on {idx.device}")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_sum: tensors must be on cuda or cpu, got {idx.device}")
    for name, t in (("idx", idx), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"gather_sum: {name} must be contiguous")
    if x.shape[0] == 0:
        raise ValueError("gather_sum: x has no rows")
    if idx.shape[1] > MAX_K:
        raise ValueError(f"gather_sum: {idx.shape[1]} ids per bag exceed {MAX_K}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("gather_sum: the kernel has no backward; call it under torch.no_grad()")


@functools.cache
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel's library; ``defines`` such as ``("GS_TILE_BAGS=64",)`` build a
    variant of its tile and stage constants (``tools/gather_sum_variants.py``
    times them)."""
    lib = _build.library("gather_sum", defines)
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_sum_launch.argtypes = [vp, vp, vp, i64, i, i64, i, i, vp]
    lib.gather_sum_launch.restype = i
    lib.gather_sum_plan.argtypes = [i64, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.gather_sum_plan.restype = i
    return lib


def gather_sum(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_k x[idx[b, k]] over idx ≥ 0: [B, D] in ``x.dtype``."""
    _check(idx, x)
    if idx.device.type == "cpu":
        return gather_sum_plain(idx, x)
    (bags, k), (n, d) = idx.shape, x.shape
    if is_fake(idx) or is_fake(x):
        gather_sum.fake_calls += 1
        return x.new_empty((bags, d))
    out = torch.empty((bags, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gather_sum_launch(
            idx.data_ptr(), x.data_ptr(), out.data_ptr(), bags, k, n, d, _DTYPES[x.dtype],
            stream,
        )
    _build.raise_on(err, "gather_sum")
    gather_sum.launches += 1
    return out


gather_sum.launches = 0
gather_sum.fake_calls = 0


def spmm_ell(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: out[i] = Σ_k x[idx[i, k]] (pad = −1).  GNN aggregation."""
    return gather_sum(idx, x)


def embed_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Embedding bag: out[b] = Σ_k table[idx[b, k]] (pad = −1).  RecSys."""
    return gather_sum(idx, table)
