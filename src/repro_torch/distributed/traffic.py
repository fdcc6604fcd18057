"""Collective bytes by kind, counted at the dispatcher.

The reference parses XLA's compiled HLO (``repro.distributed.hlo``) and sums
the output bytes of every collective op by kind.  Here every collective of
``torch.distributed`` reaches the dispatcher as a ``c10d`` op whose first
argument holds its outputs (the tensors written in place), so a
``TorchDispatchMode`` sees each call, whoever makes it:
``distributed.collectives``, ``core.distributed._gather_words``,
``sharding.gather`` or a plain ``dist.all_reduce``.  A point-to-point pair
(``collectives.ppermute`` through ``batch_isend_irecv``) counts as
``collective-permute`` by the bytes this rank receives; sends are not
counted.  The count is the same on real tensors and on fake ones
(``launch/dryrun.py``), and on every backend.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: c10d op → the kind the reference's HLO count files it under
_C10D = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
}


def count(out: dict, func, args) -> None:
    """Add a dispatched op's collective bytes, if it is a collective, to
    ``out`` (a ``defaultdict(int)``) under its kind and ``"total"``."""
    kind = _C10D.get(func.overloadpacket.__name__) if func.namespace == "c10d" else None
    if kind is not None:
        size = sum(t.numel() * t.element_size() for t in tree_leaves(args[0]))
        out[kind] += size
        out["total"] += size


class _Counter(TorchDispatchMode):
    def __init__(self, out: dict):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        count(self.out, func, args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def collective_bytes():
    """``with collective_bytes() as out:`` — ``out`` fills with the output
    bytes of this rank's collectives in the block, ``{kind: bytes, "total":
    bytes}`` (kinds ``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``; one that did not occur is absent,
    as in the reference's count)."""
    out: dict[str, int] = defaultdict(int)
    with _Counter(out):
        yield out
