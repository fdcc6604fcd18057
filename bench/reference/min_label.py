"""Plain reference for connected components (CC), RecStep's program::

    cc3(x, MIN(x)) :- arc(x, _).
    cc3(y, MIN(z)) :- cc3(x, z), arc(x, y).
    cc2(x, MIN(y)) :- cc3(x, y).
    cc(x) :- cc2(_, x).

``spec`` is ``{"kind": "min_label", "edge": <arc>}``; the cell is judged on
``cc2``, one label per node.  Jacobi label propagation on int64 labels:
every node with an out-edge starts with its own id, and each round takes,
for every arc ``(x, y)``, ``y``'s label down to ``x``'s (one
``scatter_reduce("amin")`` over the whole edge list), until a round lowers
no label.  Jacobi and semi-naive propagation publish the same table after
each round, so both the labels and the count of rounds are exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NONE = torch.iinfo(torch.int64).max


@dataclass
class Labels:
    """``values[i]`` is the label of node ``keys[i]``; ``rounds`` counts the
    rounds after the base that lowered a label."""

    keys: torch.Tensor           # int64[S], sorted, distinct
    values: torch.Tensor         # int64[S]
    rounds: int

    @property
    def count(self) -> int:
        return len(self.keys)

    def expected_iterations(self, backend: str) -> int:
        """``EvalStats.total_iterations()`` over the three strata: cc3's base,
        its rounds and the empty one, then one each for cc2 and cc."""
        return self.rounds + 4


def fixpoint(edb: dict[str, np.ndarray], spec: dict, n: int, device,
             max_rounds: int | None = None) -> Labels:
    """CC's labels over ``edb[spec["edge"]]`` on the domain ``[0, n)``.
    ``max_rounds`` stops the propagation early (the control)."""
    arc = torch.as_tensor(np.asarray(edb[spec["edge"]], np.int64).reshape(-1, 2),
                          device=device)
    src, dst = arc[:, 0], arc[:, 1]
    label = torch.full((n,), NONE, dtype=torch.int64, device=device)
    label[src] = src
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = label.scatter_reduce(0, dst, label[src], "amin", include_self=True)
        if bool((new == label).all()):
            break
        label = new
        rounds += 1
    keys = torch.nonzero(label != NONE).flatten()
    return Labels(keys, label[keys], rounds)
