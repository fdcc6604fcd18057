"""Plain reference for Andersen's points-to analysis, RecStep's program::

    pointsTo(y, x) :- addressOf(y, x).
    pointsTo(y, x) :- assign(y, z), pointsTo(z, x).
    pointsTo(y, w) :- load(y, x), pointsTo(x, z), pointsTo(z, w).
    pointsTo(z, w) :- store(y, x), pointsTo(y, z), pointsTo(x, w).

``spec`` is ``{"kind": "points_to"}``; the relations keep those names.  With
``A``, ``S``, ``L`` and ``St`` the ``n x n`` bit matrices of ``addressOf``,
``assign``, ``load`` and ``store`` and ``P`` the fixpoint so far, each naive
round sets ``P ← P ∪ A ∪ S·P ∪ L·P·P ∪ Pᵀ·St·P`` until a round adds nothing.
Each product is a dense float32 product of 0/1 operands whose counts are
made bits again before the next product, so no count passes ``n`` and every
one is exact; TF32 is off while it runs.  Naive and semi-naive rounds
publish the same set after each round, so the facts and the count of
rounds are exact.

``Closure`` repeats ``linear_closure.Closure`` field for field, with every
variable a key: a reference is loaded by its path and may import only
``numpy``, ``torch``, ``dataclasses`` and ``math``
(``bench/tests/test_bench_isolation.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

RELATIONS = ("addressOf", "assign", "load", "store")


@dataclass
class Closure:
    """``bits[i, y]`` holds ``pointsTo(keys[i], y)``; ``rounds`` counts the
    rounds after the base that derived a new fact."""

    keys: torch.Tensor           # int64[n]: every variable
    bits: torch.Tensor           # bool[n, n]
    rounds: int

    @property
    def count(self) -> int:
        return int(self.bits.sum())

    def row_digests(self, chunk: int = 1024) -> tuple[np.ndarray, np.ndarray]:
        """Per key, the number of facts and the sum of their ``y``: int64[S]
        each, on the host."""
        n = self.bits.shape[1]
        ys = torch.arange(n, dtype=torch.float64, device=self.bits.device)
        counts, sums = [], []
        for i in range(0, self.bits.shape[0], chunk):
            block = self.bits[i:i + chunk]
            counts.append(block.sum(dim=1))
            sums.append(block.double() @ ys)      # sums below 2**53: exact
        return (torch.cat(counts).cpu().numpy().astype(np.int64),
                torch.cat(sums).round().cpu().numpy().astype(np.int64))

    def row(self, x: int) -> np.ndarray:
        """The sorted ``y`` of ``pointsTo(x, y)``."""
        if not 0 <= x < self.bits.shape[0]:
            return np.zeros(0, np.int64)
        return torch.nonzero(self.bits[x]).flatten().cpu().numpy()


def _bits(rows: np.ndarray, n: int, device) -> torch.Tensor:
    r = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 2), device=device)
    m = torch.zeros((n, n), dtype=torch.bool, device=device)
    m[r[:, 0], r[:, 1]] = True
    return m


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a·b`` of two bit matrices, as bits."""
    return (a.float() @ b.float()) > 0


def fixpoint(edb: dict[str, np.ndarray], spec: dict, n: int, device,
             max_rounds: int | None = None) -> Closure:
    """Andersen's ``pointsTo`` over the domain ``[0, n)``.  ``max_rounds``
    stops it early (the control)."""
    a, s, ld, st = (_bits(edb[r], n, device) for r in RELATIONS)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bits = a.clone()
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            new = (_mm(s, bits) | _mm(_mm(ld, bits), bits)
                   | _mm(_mm(bits.T, st), bits)) & ~bits
            if not bool(new.any()):
                break
            bits |= new
            rounds += 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return Closure(torch.arange(n, device=device), bits, rounds)
