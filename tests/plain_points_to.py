"""Plain Andersen points-to analysis, for the tests of the port::

    pointsTo(y, x) :- addressOf(y, x).
    pointsTo(y, x) :- assign(y, z), pointsTo(z, x).
    pointsTo(y, w) :- load(y, x), pointsTo(x, z), pointsTo(z, w).
    pointsTo(z, w) :- store(y, x), pointsTo(y, z), pointsTo(x, w).

Naive rounds in plain ``torch`` over a dense ``bool[n, n]``: with ``A``,
``S``, ``L`` and ``St`` the bit matrices of ``addressOf``, ``assign``,
``load`` and ``store``, each round sets ``P ← P ∪ A ∪ S·P ∪ L·P·P ∪
Pᵀ·St·P`` until a round adds nothing.  Each product is a float32 product
of 0/1 matrices whose counts are made bits again before the next product,
so every count stays at most ``n`` and is exact; TF32 is off while it runs.
No deltas and no batching; imports nothing of the port.

``BY_HAND_*`` is a case worked by hand, shared by the port's tests and the
benchmark's.
"""

from __future__ import annotations

import numpy as np
import torch

#: five variables on which every rule fires: the base gives 0 → 1, 1 → 2 and
#: 3 → 4; round 1 gives 2 → 1 through ``assign`` and 4 → 2 through ``load``;
#: round 2 gives 4 → 1 through ``store``; round 3 adds nothing
BY_HAND_EDB = {"addressOf": [(0, 1), (1, 2), (3, 4)], "assign": [(2, 0)],
               "load": [(4, 0)], "store": [(3, 2)]}
BY_HAND_FACTS = [(0, 1), (1, 2), (2, 1), (3, 4), (4, 1), (4, 2)]
BY_HAND_ROUNDS = 2
#: the semi-naive rounds' derivations: the base's 3; in round 1 assign, load
#: with Δ on either atom (0 → 1 and 1 → 2 are both new) once each; in round 2
#: store with Δ on its second atom; none in round 3
BY_HAND_DERIVATIONS = [3, 3, 1, 0]
BY_HAND_NEW = [3, 2, 1, 0]


def _bits(rows: np.ndarray, n: int, device) -> torch.Tensor:
    r = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 2), device=device)
    m = torch.zeros((n, n), dtype=torch.bool, device=device)
    m[r[:, 0], r[:, 1]] = True
    return m


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()) > 0


def _matrices(edb: dict, n: int, device):
    return (_bits(edb[r], n, device) for r in ("addressOf", "assign", "load", "store"))


def _rounds(edb: dict, n: int, device, max_rounds: int | None):
    """``(P, Δ)`` after the base and after each productive round."""
    a, s, ld, st = _matrices(edb, n, device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p, rounds = a.clone(), 0
        yield p.clone(), p.clone()
        while max_rounds is None or rounds < max_rounds:
            new = (a | _mm(s, p) | _mm(_mm(ld, p), p) | _mm(_mm(p.T, st), p)) & ~p
            if not bool(new.any()):
                return
            p |= new
            rounds += 1
            yield p.clone(), new
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def points_to(edb: dict, n: int, device="cpu",
              max_rounds: int | None = None) -> tuple[np.ndarray, int]:
    """``pointsTo`` over ``edb`` on the domain ``[0, n)``: its pairs as
    ``int32[count, 2]`` rows in lexicographic order, and the rounds after the
    base that added a fact.  ``max_rounds`` stops it early."""
    states = list(_rounds(edb, n, device, max_rounds))
    pairs = torch.nonzero(states[-1][0]).to(torch.int32)
    return pairs.cpu().numpy(), len(states) - 1


def new_facts(edb: dict, n: int, device="cpu") -> list[int]:
    """The facts each round adds, the base first, then each productive round,
    then the last round's 0."""
    return [int(d.sum()) for _p, d in _rounds(edb, n, device, None)] + [0]


def derivations(edb: dict, n: int, device="cpu") -> list[int]:
    """The rows the port's rule variants derive in each round of a
    semi-naive evaluation, with multiplicity and before any dedup: the base
    derives ``|A|``; each later round, from the last round's new facts
    ``Δ`` and the whole ``P`` so far (``Δ`` in it), derives
    ``|S·Δ| + |L·Δ·P| + |L·P·Δ| + |Δᵀ·St·P| + |Pᵀ·St·Δ|``, where ``|M|`` sums
    the counts of ``M``.  The base comes first and the last round, which
    adds nothing, last.  Each sum is of float64 products of 0/1 matrices
    with vectors of row or column sums, every number below 2**53: exact."""
    a, s, ld, st = (m.double() for m in _matrices(edb, n, device))
    out = [int(a.sum())]
    for p, d in _rounds(edb, n, device, None):
        p, d = p.double(), d.double()
        p_out, d_out = p.sum(1), d.sum(1)               # rows' counts: P·1, Δ·1
        out.append(int(round(float(
            s.sum(0) @ d_out                            # 1ᵀ·S·Δ·1
            + ld.sum(0) @ d @ p_out                     # 1ᵀ·L·Δ·P·1
            + ld.sum(0) @ p @ d_out                     # 1ᵀ·L·P·Δ·1
            + d_out @ st @ p_out                        # 1ᵀ·Δᵀ·St·P·1
            + p_out @ st @ d_out))))                    # 1ᵀ·Pᵀ·St·Δ·1
    return out
