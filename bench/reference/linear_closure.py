"""Plain reference for linear recursive binary programs::

    p(x, y) :- base(x, y).
    p(x, y) :- p(x, z), step(z, y).

TC is ``base = step = arc``; CSDA is ``base = nullEdge``, ``step = arc``.
The fixpoint is the set of ``(x, y)`` with ``y`` reachable by ``step`` edges
from a ``base`` target of ``x``.  It is held as one row of bits over the
active domain per distinct ``x`` and worked out round by round: a sparse
product of the last round's new facts with ``step``, in float32 counts that
only their sign is read from (exact), less what is already known.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Closure:
    """``bits[i, y]`` holds ``p(keys[i], y)``; ``rounds`` counts the rounds
    after the base that derived a new fact."""

    keys: torch.Tensor           # int64[S], sorted, distinct
    bits: torch.Tensor           # bool[S, n]
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
        """The sorted ``y`` of ``p(x, y)``."""
        i = int(torch.searchsorted(self.keys, torch.tensor([x], device=self.keys.device)))
        if i >= len(self.keys) or int(self.keys[i]) != x:
            return np.zeros(0, np.int64)
        return torch.nonzero(self.bits[i]).flatten().cpu().numpy()


def fixpoint(edb: dict[str, np.ndarray], spec: dict, n: int, device,
             max_rounds: int | None = None) -> Closure:
    """The closure of ``edb[spec["base"]]`` under ``edb[spec["step"]]`` over
    the domain ``[0, n)``.  ``max_rounds`` stops it early (the control)."""
    base = torch.as_tensor(np.asarray(edb[spec["base"]], np.int64), device=device)
    step = torch.as_tensor(np.asarray(edb[spec["step"]], np.int64), device=device)
    keys = torch.unique(base[:, 0])
    bits = torch.zeros((len(keys), n), dtype=torch.bool, device=device)
    bits[torch.searchsorted(keys, base[:, 0].contiguous()), base[:, 1]] = True
    # step transposed, so that stepᵀ · frontierᵀ lands y-major: [n, S]
    with torch.sparse.check_sparse_tensor_invariants():
        step_t = torch.sparse_coo_tensor(
            torch.stack([step[:, 1], step[:, 0]]),
            torch.ones(len(step), dtype=torch.float32, device=device), (n, n),
        ).coalesce()
    frontier_t = bits.T.contiguous().float()
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = (torch.sparse.mm(step_t, frontier_t) > 0).T & ~bits
        if not bool(new.any()):
            break
        bits |= new
        frontier_t = new.T.contiguous().float()
        rounds += 1
    return Closure(keys, bits, rounds)
