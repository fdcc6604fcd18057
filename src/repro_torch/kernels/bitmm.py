"""PBME bit-matrix products: wrappers over the CUDA kernels in ``csrc/bitmm.cu``.

A CUDA tensor launches the hand-written kernel on PyTorch's current stream
(no synchronisation; outputs and the kernel's scratch allocated here with
``torch.empty``) or raises.  A CPU tensor runs the plain version from
:mod:`repro_torch.kernels.ref`.  Each wrapper counts its calls that launch
the kernel in ``<wrapper>.launches``; one call is a transpose of B's words,
the stage plan and the product (a tensor-core kernel and a light kernel for
row blocks that need no MMA), all on the same stream.  A fake CUDA tensor (a
shapes-only trace, ``launch/dryrun.py``) gets outputs of the kernel's shapes
and its scratch (``workspace_bytes``), and nothing is built or launched: such
calls count in ``<wrapper>.fake_calls``.

The kernel's blocks own 128 rows by 8 output words and walk K in stages of
1024 bits: an empty stage is skipped, a stage whose 128 x 1024 tile of A holds
fewer than 512 set bits ORs the listed rows of B, the others run single-bit
MMA on the tensor cores (see ``csrc/bitmm.cu``, which sets both as build-time
constants).

Operands are packed ``int32`` words (see ``ref.py`` for the layout):
``a`` is ``[M, ceil(K/32)]``, ``b`` is ``[K, Nw]``; A's bits at columns ≥ K
are ignored, so an n×n relation multiplies with no padding.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitmm_fused_delta_plain, bitmm_plain

_MAX_GRID_Y = 65535         # blocks along the output words (grid y)
_WORDS_PER_BLOCK = 8        # output words per block: 256 columns
# csrc/bitmm.cu's default tile constants, for workspace_bytes: rows per block
# (BM), K words per stage (BKW) and listed bits per row block (WALK_CAP)
_BM, _BKW, _WALK_CAP = 128, 32, 8192


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
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines`` such as ``("BITMM_BKW=16",)`` build a
    variant of its tile constants (``tools/bitmm_variants.py`` times them)."""
    lib = _build.library("bitmm", defines)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bitmm_workspace_bytes.argtypes = [i, i, i]
    lib.bitmm_workspace_bytes.restype = ctypes.c_longlong
    lib.bitmm_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.bitmm_launch.restype = i
    lib.bitmm_fused_delta_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.bitmm_fused_delta_launch.restype = i
    return lib


def workspace_bytes(rows: int, kw: int, nw: int) -> int:
    """The scratch bytes of one call (``bitmm_workspace_bytes`` in
    ``csrc/bitmm.cu`` at its default constants): B transposed, the stage
    plan, the walk counts and the walk lists."""
    up8 = lambda n: (n + 7) // 8 * 8
    kwp = (kw + _BKW - 1) // _BKW * _BKW
    stages, blocks = kwp // _BKW, (rows + _BM - 1) // _BM
    return 32 * nw * kwp * 4 + up8(blocks * stages * 4) + up8(blocks * 4) + blocks * _WALK_CAP * 8


def _fake_call(a: torch.Tensor, nw: int, outputs: int) -> list[torch.Tensor]:
    """A shapes-only call: the outputs, and the scratch the kernel would take
    beside them until it returns."""
    outs = [a.new_empty((a.shape[0], nw)) for _ in range(outputs)]
    a.new_empty(workspace_bytes(a.shape[0], a.shape[1], nw), dtype=torch.uint8)
    return outs


def _workspace(lib: ctypes.CDLL, a: torch.Tensor, nw: int) -> torch.Tensor:
    nbytes = lib.bitmm_workspace_bytes(a.shape[0], a.shape[1], nw)
    return torch.empty(nbytes, dtype=torch.uint8, device=a.device)


def bitmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A ⊛ B over the OR-AND semiring: int32[M, Nw]."""
    _check(a, b)
    if a.device.type == "cpu":
        return bitmm_plain(a, b)
    rows, nw = a.shape[0], b.shape[1]
    if is_fake(a) or is_fake(b):
        bitmm.fake_calls += 1
        return _fake_call(a, nw, 1)[0]
    c = torch.empty((rows, nw), dtype=torch.int32, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        lib = _lib()
        ws = _workspace(lib, a, nw)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.bitmm_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), rows, a.shape[1],
            b.shape[0], nw, stream,
        )
    _build.raise_on(err, "bitmm")
    bitmm.launches += 1
    return c


bitmm.launches = 0
bitmm.fake_calls = 0


def bitmm_fused_delta(
    a: torch.Tensor, b: torch.Tensor, m: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One PBME iteration: (Δ', M') = ((A⊛B) & ~M, M | Δ')."""
    _check(a, b, m)
    if a.device.type == "cpu":
        return bitmm_fused_delta_plain(a, b, m)
    rows, nw = a.shape[0], b.shape[1]
    if is_fake(a) or is_fake(b) or is_fake(m):
        bitmm_fused_delta.fake_calls += 1
        return tuple(_fake_call(a, nw, 2))
    delta = torch.empty((rows, nw), dtype=torch.int32, device=a.device)
    m_out = torch.empty_like(delta)
    if delta.numel() == 0:
        return delta, m_out
    with torch.cuda.device(a.device):
        lib = _lib()
        ws = _workspace(lib, a, nw)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.bitmm_fused_delta_launch(
            a.data_ptr(), b.data_ptr(), m.data_ptr(), delta.data_ptr(), m_out.data_ptr(),
            ws.data_ptr(), rows, a.shape[1], b.shape[0], nw, stream,
        )
    _build.raise_on(err, "bitmm_fused_delta")
    bitmm_fused_delta.launches += 1
    return delta, m_out


bitmm_fused_delta.launches = 0
bitmm_fused_delta.fake_calls = 0
