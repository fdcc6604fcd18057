"""Plain connected-components labels, for the tests of the port's CC::

    cc3(x, MIN(x)) :- arc(x, _).
    cc3(y, MIN(z)) :- cc3(x, z), arc(x, y).
    cc2(x, MIN(y)) :- cc3(x, y).

Jacobi label propagation in plain ``torch`` on int64 labels: every node with
an out-edge starts with its own id, and each round takes, for every arc
``(x, y)``, ``y``'s label down to ``x``'s (one ``scatter_reduce("amin")``
over the whole edge list) until a round changes nothing.  No deltas and no
batching; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

NONE = torch.iinfo(torch.int64).max


def min_label(arc: np.ndarray, n: int, device="cpu",
              max_rounds: int | None = None) -> tuple[np.ndarray, int, list[int]]:
    """CC over ``arc`` on the domain ``[0, n)``: ``cc2``'s ``(key, label)``
    pairs as ``int32[count, 2]`` rows, keys ascending; the rounds after the
    base that lowered a label; and the candidates of each round the
    semi-naive evaluation runs, the base first and the last (empty) round
    included.  The base reads every distinct arc once; each later round
    reads the out-edges of the nodes whose label fell in the round before,
    every node with an out-edge counting as fallen in the base.
    ``max_rounds`` stops it early."""
    edges = torch.as_tensor(np.asarray(arc, np.int64).reshape(-1, 2), device=device)
    edges = torch.unique(edges, dim=0)
    src, dst = edges[:, 0], edges[:, 1]
    out_degree = torch.bincount(src, minlength=n)
    label = torch.full((n,), NONE, dtype=torch.int64, device=device)
    label[src] = src
    fell = out_degree > 0
    candidates = [len(edges)]
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        candidates.append(int(out_degree[fell].sum()))
        new = label.scatter_reduce(0, dst, label[src], "amin", include_self=True)
        fell = new < label
        if not bool(fell.any()):
            break
        label = new
        rounds += 1
    keys = torch.nonzero(label != NONE).flatten()
    rows = torch.stack([keys, label[keys]], dim=1).to(torch.int32)
    return rows.cpu().numpy(), rounds, candidates
