"""Plain reference for same generation over one edge relation ``e``::

    sg(x, y) :- e(p, x), e(p, y), x != y.
    sg(x, y) :- e(a, x), sg(a, b), e(b, y).

``spec`` is ``{"kind": "same_generation", "edge": <e>}``.  With ``A`` the
edge matrix, the base is ``Aᵀ·A`` off the diagonal and each round adds
``Aᵀ·Δ·A`` less what is already known.  ``x != y`` constrains the base rule
alone: the recursive rule derives ``sg(x, x)``, and it is kept.

The fixpoint is held as one row of bits over the active domain per distinct
``x``, as ``linear_closure`` holds its own.  Each product is a sparse ``Aᵀ``
against a dense operand, in float32 counts that only their sign is read from
(exact); ``P·A`` is worked out as ``(Aᵀ·Pᵀ)ᵀ``.

``Closure`` repeats ``linear_closure.Closure`` field for field: the harness
loads each reference by its path, outside any package, and a reference may
import nothing but ``numpy``, ``torch`` and the standard library's
``dataclasses`` and ``math`` (``bench/tests/test_bench_isolation.py``), so
the class cannot be imported from its sibling.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# float32 products in float32, never TF32
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


@dataclass
class Closure:
    """``bits[i, y]`` holds ``sg(keys[i], y)``; ``rounds`` counts the rounds
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
        """The sorted ``y`` of ``sg(x, y)``."""
        i = int(torch.searchsorted(self.keys, torch.tensor([x], device=self.keys.device)))
        if i >= len(self.keys) or int(self.keys[i]) != x:
            return np.zeros(0, np.int64)
        return torch.nonzero(self.bits[i]).flatten().cpu().numpy()


def _sandwich(a_t: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``Aᵀ·Δ·A`` as bits, for sparse ``a_t = Aᵀ`` and a dense ``delta``."""
    p = torch.sparse.mm(a_t, delta.float()) > 0                     # Aᵀ·Δ
    return (torch.sparse.mm(a_t, p.T.float()) > 0).T                 # (Aᵀ·Pᵀ)ᵀ


def fixpoint(edb: dict[str, np.ndarray], spec: dict, n: int, device,
             max_rounds: int | None = None) -> Closure:
    """Same generation over ``edb[spec["edge"]]`` on the domain ``[0, n)``.
    ``max_rounds`` stops it early (the control)."""
    e = torch.as_tensor(np.asarray(edb[spec["edge"]], np.int64), device=device)
    with torch.sparse.check_sparse_tensor_invariants():
        a_t = torch.sparse_coo_tensor(
            torch.stack([e[:, 1], e[:, 0]]),
            torch.ones(len(e), dtype=torch.float32, device=device), (n, n),
        ).coalesce()
    eye = torch.eye(n, dtype=torch.bool, device=device)
    bits = _sandwich(a_t, eye) & ~eye                 # the base: Aᵀ·I·A, x != y
    delta = bits
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = _sandwich(a_t, delta) & ~bits           # no mask: sg(x, x) stays
        if not bool(new.any()):
            break
        bits |= new
        delta = new
        rounds += 1
    keys = torch.nonzero(bits.any(dim=1)).flatten()
    return Closure(keys, bits[keys], rounds)
