"""Plain same generation, for the tests of the port's SG plan::

    sg(x, y) :- arc(p, x), arc(p, y), x != y.
    sg(x, y) :- arc(a, x), sg(a, b), arc(b, y).

Round by round on dense 0/1 matrices in plain ``torch``: the base is
``Aᵀ·A`` off the diagonal, each round adds ``Aᵀ·Δ·A`` less what is known,
and ``x != y`` masks the base alone, so the recursive rule's ``sg(x, x)``
facts stay.  The products are float32 matmuls read only for their sign
(exact).  Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 products in float32, never TF32
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def same_generation(arc: np.ndarray, n: int, device="cpu",
                    max_rounds: int | None = None) -> tuple[np.ndarray, int]:
    """The SG fixpoint of ``arc`` over the domain ``[0, n)`` as sorted
    ``int32[count, 2]`` rows, and the number of rounds after the base that
    derived a new fact.  ``max_rounds`` stops it early."""
    edges = torch.as_tensor(np.asarray(arc, np.int64).reshape(-1, 2), device=device)
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    a[edges[:, 0], edges[:, 1]] = 1.0
    eye = torch.eye(n, dtype=torch.bool, device=device)
    sg = (a.T @ a > 0) & ~eye
    delta = sg
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = (a.T @ delta.float() @ a > 0) & ~sg
        if not bool(new.any()):
            break
        sg |= new
        delta = new
        rounds += 1
    return torch.nonzero(sg).to(torch.int32).cpu().numpy(), rounds
