"""PBME bit-matrix products: wrappers over the CUDA kernels in ``csrc/bitmm.cu``.

A CUDA tensor launches the hand-written kernel on PyTorch's current stream
(no synchronisation; outputs allocated here with ``torch.empty``) or raises.
A CPU tensor runs the plain version from :mod:`repro_torch.kernels.ref`.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

Operands are packed ``int32`` words (see ``ref.py`` for the layout):
``a`` is ``[M, ceil(K/32)]``, ``b`` is ``[K, Nw]``; A's bits at columns ≥ K
are ignored, so an n×n relation multiplies with no padding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitmm_fused_delta_plain, bitmm_plain

_MAX_GRID_Y = 65535
_WORDS_PER_BLOCK = 128


def _check(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor | None = None) -> None:
    named = [("a", a), ("b", b)] + ([("m", m)] if m is not None else [])
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(
                f"bitmm: {name} must be a 2-D torch.int32 tensor of packed words, got "
                f"{getattr(t, 'dtype', type(t))} with shape {tuple(getattr(t, 'shape', ()))}"
            )
        if t.device != a.device:
            raise ValueError(f"bitmm: {name} is on {t.device}, a is on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"bitmm: {name} must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitmm: tensors must be on cuda or cpu, got {a.device}")
    if a.shape[1] != (b.shape[0] + 31) // 32:
        raise ValueError(
            f"bitmm: a has {a.shape[1]} words per row but b has {b.shape[0]} rows "
            f"(needs ceil({b.shape[0]}/32) = {(b.shape[0] + 31) // 32})"
        )
    if m is not None and tuple(m.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(
            f"bitmm: m has shape {tuple(m.shape)}, the product has "
            f"{(a.shape[0], b.shape[1])}"
        )
    if (b.shape[1] + _WORDS_PER_BLOCK - 1) // _WORDS_PER_BLOCK > _MAX_GRID_Y:
        raise ValueError(f"bitmm: {b.shape[1]} output words per row exceed the grid")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("bitmm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bitmm_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.bitmm_launch.restype = i
    lib.bitmm_fused_delta_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.bitmm_fused_delta_launch.restype = i
    return lib


def bitmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ⊛ B over the OR-AND semiring: int32[M, Nw]."""
    _check(a, b)
    if a.device.type == "cpu":
        return bitmm_plain(a, b)
    rows, nw = a.shape[0], b.shape[1]
    c = torch.empty((rows, nw), dtype=torch.int32, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().bitmm_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), rows, a.shape[1], b.shape[0], nw,
            stream,
        )
    _build.raise_on(err, "bitmm")
    bitmm.launches += 1
    return c


bitmm.launches = 0


def bitmm_fused_delta(
    a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One PBME iteration: (Δ', M') = ((A⊛B) & ~M, M | Δ')."""
    _check(a, b, m)
    if a.device.type == "cpu":
        return bitmm_fused_delta_plain(a, b, m)
    rows, nw = a.shape[0], b.shape[1]
    delta = torch.empty((rows, nw), dtype=torch.int32, device=a.device)
    m_out = torch.empty_like(delta)
    if delta.numel() == 0:
        return delta, m_out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().bitmm_fused_delta_launch(
            a.data_ptr(), b.data_ptr(), m.data_ptr(), delta.data_ptr(), m_out.data_ptr(),
            rows, a.shape[1], b.shape[0], nw, stream,
        )
    _build.raise_on(err, "bitmm_fused_delta")
    bitmm_fused_delta.launches += 1
    return delta, m_out


bitmm_fused_delta.launches = 0
