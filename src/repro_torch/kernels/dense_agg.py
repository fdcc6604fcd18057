"""The dense MIN/MAX table's update: the wrapper over ``csrc/dense_agg.cu``.

One round of a recursive MIN/MAX aggregate (CC's labels, SSSP's distances)
folds each of its candidate buffers ``(keys, vals, valid)`` into a copy of the
table ``values`` (``int32[n]``, ``absent`` where no value is known: ``SENTINEL``
for MIN, ``-SENTINEL`` for MAX) and returns the new table, the round's Δ
(``bool[n]``, the keys whose value improved) and the counts the engine needs:
the valid candidate slots, the keys present and the keys in Δ.  Keys of valid
slots are clamped to ``[0, n)``; invalid slots are ignored.  ``values`` is
never written: a serving snapshot may still hold it.

A CUDA tensor launches the hand-written kernels on PyTorch's current stream
(one scatter a buffer, one Δ pass a round; outputs allocated here) and reads
the four counts in one host copy; ``atomics`` is then the scatter's atomics
that got past its read-before-atomic filter.  A CPU tensor runs the plain
version (:func:`repro_torch.kernels.ref.dense_agg_update_plain`), whose
``atomics`` is ``None``.  ``dense_agg_update.launches`` counts the calls that
launch the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dense_agg_update_plain
from repro_torch.relational.sort import SENTINEL


class DenseAggRound(NamedTuple):
    values: torch.Tensor        # int32[n], a new tensor
    delta: torch.Tensor         # bool[n]
    candidates: int             # valid slots over every buffer
    count: int                  # keys present after the round
    delta_count: int            # keys in Δ
    atomics: int | None         # atomics the kernel issued; None on the CPU


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("dense_agg")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dense_agg_scatter_launch.argtypes = [vp, vp, vp, ll, i, i, vp, vp, vp]
    lib.dense_agg_scatter_launch.restype = i
    lib.dense_agg_diff_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.dense_agg_diff_launch.restype = i
    return lib


def _check(values: torch.Tensor, op: str, buffers) -> None:
    if op not in ("MIN", "MAX"):
        raise ValueError(f"dense_agg_update: op must be 'MIN' or 'MAX', got {op!r}")
    if not isinstance(values, torch.Tensor) or values.dtype != torch.int32 or values.dim() != 1:
        raise ValueError(
            f"dense_agg_update: values must be a 1-D torch.int32 tensor, got "
            f"{getattr(values, 'dtype', type(values))} with shape "
            f"{tuple(getattr(values, 'shape', ()))}"
        )
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_agg_update: tensors must be on cuda or cpu, got {values.device}")
    for keys, vals, valid in buffers:
        for what, t, dtype in (("keys", keys, torch.int32), ("vals", vals, torch.int32),
                               ("valid", valid, torch.bool)):
            if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != 1:
                raise ValueError(
                    f"dense_agg_update: {what} must be a 1-D {dtype} tensor, got "
                    f"{getattr(t, 'dtype', type(t))} with shape {tuple(getattr(t, 'shape', ()))}"
                )
            if t.device != values.device:
                raise ValueError(
                    f"dense_agg_update: {what} is on {t.device}, values is on {values.device}")
        if not keys.shape == vals.shape == valid.shape:
            raise ValueError(
                f"dense_agg_update: keys, vals and valid have shapes {tuple(keys.shape)}, "
                f"{tuple(vals.shape)} and {tuple(valid.shape)}"
            )


def dense_agg_update(values: torch.Tensor, op: str, buffers) -> DenseAggRound:
    """One round of candidate buffers ``[(keys, vals, valid), ...]`` (int32,
    int32, bool, each 1-D and of one length) folded into a copy of ``values``
    by ``op`` (``"MIN"`` or ``"MAX"``).  On the card: one host sync."""
    buffers = list(buffers)
    _check(values, op, buffers)
    if values.device.type == "cpu":
        return DenseAggRound(*dense_agg_update_plain(values, op, buffers), None)
    n = values.shape[0]
    absent = SENTINEL if op == "MIN" else -SENTINEL
    is_min = int(op == "MIN")
    with torch.cuda.device(values.device):
        lib = _lib()
        stream = torch.cuda.current_stream(values.device).cuda_stream
        new = values.clone()
        counts = torch.zeros(4, dtype=torch.int64, device=values.device)
        for keys, vals, valid in buffers:
            keys, vals, valid = keys.contiguous(), vals.contiguous(), valid.contiguous()
            _build.raise_on(
                lib.dense_agg_scatter_launch(keys.data_ptr(), vals.data_ptr(), valid.data_ptr(),
                                             keys.shape[0], n, is_min, new.data_ptr(),
                                             counts.data_ptr(), stream),
                "dense_agg_update",
            )
        delta = torch.empty(n, dtype=torch.bool, device=values.device)
        _build.raise_on(
            lib.dense_agg_diff_launch(values.data_ptr(), new.data_ptr(), n, is_min, absent,
                                      delta.data_ptr(), counts.data_ptr(), stream),
            "dense_agg_update",
        )
    dense_agg_update.launches += 1
    candidates, atomics, count, delta_count = counts.tolist()
    return DenseAggRound(new, delta, candidates, count, delta_count, atomics)


dense_agg_update.launches = 0
