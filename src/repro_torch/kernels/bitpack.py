"""PBME's conversions between (row, col) pairs and packed bit matrices:
wrappers over the CUDA kernels in ``csrc/bitpack.cu``.

A CUDA tensor launches the hand-written kernels on PyTorch's current stream
(outputs allocated here) or raises; a CPU tensor runs the plain versions from
:mod:`repro_torch.kernels.ref`.  Each wrapper counts its calls that launch the
kernels in ``<wrapper>.launches``.

Packed matrices are ``int32[rows, ceil(n/32)]`` (see ``ref.py`` for the
layout); bits at columns ≥ n are ignored.  Neither conversion builds a dense
n × n matrix on the card: :func:`edges_to_bitmatrix` ORs each edge's bit into
zeroed words, :func:`bitmatrix_to_table` counts each row's bits, reads the
total (its one host sync) and writes every pair, and the padding behind them,
once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitmatrix_to_rows_plain, edges_to_bitmatrix_plain
from repro_torch.relational.sort import SENTINEL


def _check_device(what: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors must be on cuda or cpu, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the tensor must be contiguous")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("bitpack")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitpack_pack_launch.argtypes = [vp, ll, i, vp, vp]
    lib.bitpack_pack_launch.restype = i
    lib.bitpack_count_launch.argtypes = [vp, i, i, vp, vp]
    lib.bitpack_count_launch.restype = i
    lib.bitpack_write_launch.argtypes = [vp, i, i, vp, ll, ll, i, vp, vp]
    lib.bitpack_write_launch.restype = i
    return lib


def edges_to_bitmatrix(edges: torch.Tensor, n: int) -> torch.Tensor:
    """int32[m, 2] (row, col) pairs → packed ``int32[n, ceil(n/32)]`` on their
    device.  Pairs may repeat and come in any order; a pair outside ``[0, n)
    × [0, n)`` is skipped on either device.  On the card no host sync is
    made."""
    if not isinstance(edges, torch.Tensor) or edges.dtype != torch.int32 or (
        edges.dim() != 2 or edges.shape[1] != 2
    ):
        raise ValueError(
            f"edges_to_bitmatrix: edges must be a torch.int32 tensor of shape [m, 2], got "
            f"{getattr(edges, 'dtype', type(edges))} with shape "
            f"{tuple(getattr(edges, 'shape', ()))}"
        )
    if n < 0:
        raise ValueError(f"edges_to_bitmatrix: n must be >= 0, got {n}")
    _check_device("edges_to_bitmatrix", edges)
    if edges.device.type == "cpu":
        inside = ((edges >= 0) & (edges < n)).all(dim=1)
        return edges_to_bitmatrix_plain(edges if bool(inside.all()) else edges[inside], n)
    words = torch.zeros((n, (n + 31) // 32), dtype=torch.int32, device=edges.device)
    if edges.shape[0] == 0 or n == 0:
        return words
    with torch.cuda.device(edges.device):
        stream = torch.cuda.current_stream(edges.device).cuda_stream
        err = _lib().bitpack_pack_launch(edges.data_ptr(), edges.shape[0], n, words.data_ptr(),
                                         stream)
    _build.raise_on(err, "edges_to_bitmatrix")
    edges_to_bitmatrix.launches += 1
    return words


edges_to_bitmatrix.launches = 0


def bitmatrix_to_table(
    packed: torch.Tensor, n: int, capacity_min: int = 128
) -> tuple[torch.Tensor, int]:
    """The set bits of a packed matrix as a :class:`TupleRelation`'s table:
    ``(rows, count)``, ``rows`` an ``int32[capacity, 2]`` of the (row, col)
    pairs in lexicographic order followed by ``SENTINEL`` pairs, where
    ``capacity = next_bucket(count, capacity_min)``: what ``from_numpy``
    builds from the same pairs."""
    from repro_torch.core.relation import next_bucket   # repro_torch.core imports this module

    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError(
            f"bitmatrix_to_table: packed must be a 2-D torch.int32 tensor of packed words, got "
            f"{getattr(packed, 'dtype', type(packed))} with shape "
            f"{tuple(getattr(packed, 'shape', ()))}"
        )
    if n < 0 or packed.shape[1] != (n + 31) // 32:
        raise ValueError(
            f"bitmatrix_to_table: packed has {packed.shape[1]} words per row, n = {n} needs "
            f"ceil(n/32) = {(n + 31) // 32}"
        )
    _check_device("bitmatrix_to_table", packed)
    if packed.device.type == "cpu":
        pairs = bitmatrix_to_rows_plain(packed, n)
        count = pairs.shape[0]
        rows = torch.full((next_bucket(count, capacity_min), 2), SENTINEL, dtype=torch.int32)
        rows[:count] = pairs
        return rows, count
    nrows = packed.shape[0]
    with torch.cuda.device(packed.device):
        lib = _lib()
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        counts = torch.empty(nrows, dtype=torch.int64, device=packed.device)
        _build.raise_on(
            lib.bitpack_count_launch(packed.data_ptr(), nrows, n, counts.data_ptr(), stream),
            "bitmatrix_to_table",
        )
        incl = torch.cumsum(counts, 0)
        count = int(incl[-1]) if nrows else 0
        rows = torch.empty((next_bucket(count, capacity_min), 2), dtype=torch.int32,
                           device=packed.device)
        err = lib.bitpack_write_launch(packed.data_ptr(), nrows, n, incl.data_ptr(), count,
                                       rows.shape[0], SENTINEL, rows.data_ptr(), stream)
    _build.raise_on(err, "bitmatrix_to_table")
    bitmatrix_to_table.launches += 1
    return rows, count


bitmatrix_to_table.launches = 0
