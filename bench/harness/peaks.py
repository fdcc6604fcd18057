"""The table of peaks and the arithmetic of bounds and percentiles.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``B1_OPS_PER_S``,
``bitmm_bound``, ``percentile``) as of the PR that added the benchmark, so
that a later change to the program's own copies cannot move the yardstick.
"""

from __future__ import annotations

import math

import torch

#: NVIDIA H100 SXM device memory, published: 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
#: Single-bit ``mma.sync`` (AND + POPC) rate.  NVIDIA publishes none for the
#: H100: ``tools/mma_rates.py`` measured 5.2e15 bit multiply-accumulates a
#: second on an H100 80GB HBM3 at 700 W, two operations each.  A measured
#: rate, not a published peak.
B1_OPS_PER_S = 2 * 5.20191304247123e15


def popcount(packed: torch.Tensor) -> int:
    """Set bits in a tensor of packed int32 words (SWAR, every shift masked)."""
    x = packed
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) >> 24) & 0xFF).sum(dtype=torch.int64))


def bitmm_bound_s(a: torch.Tensor, n_cols: int, c_arrays: int) -> float:
    """Least seconds of a bit-matrix product of packed A (``[M, ceil(K/32)]``)
    with a K × ``n_cols`` B: the larger of the bytes it must move (A read
    once, only the rows of B that A's set columns select read once, and
    ``c_arrays`` arrays of C's size read or written once: C; or M read and
    Δ', M' written) at the memory rate, and one multiply-add per set bit of A
    and column of B at the b1 rate.  What the inputs need, whatever
    implements the product."""
    cols_set = torch.zeros(a.shape[1], dtype=torch.int32, device=a.device)
    for bit in range(32):                  # the OR of A's rows, one packed row
        cols_set |= ((a >> bit) & 1).amax(dim=0) << bit
    b_rows = popcount(cols_set[None])
    words = -(-n_cols // 32)
    nbytes = (a.numel() + b_rows * words + c_arrays * a.shape[0] * words) * 4
    ops = 2.0 * popcount(a) * n_cols
    return max(nbytes / HBM_BYTES_PER_S, ops / B1_OPS_PER_S)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    return ordered[max(0, math.ceil(len(ordered) * q / 100) - 1)]
