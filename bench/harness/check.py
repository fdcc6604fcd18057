"""The comparison that decides ``correct``.

Every number compared is exact, so every limit is 0: a fixpoint either holds
every fact the reference derives and no other, or it is wrong.  The program's
outputs are only read here, never handed to the reference.

What the reference returns decides the comparison.  A closure (``keys``,
``bits``, ``rounds``) goes through :func:`closure_gap`.  A functional
relation, one value per key (``keys`` and ``values``, each int64[S], keys
sorted and distinct; ``values`` ``None`` for a unary relation; ``count`` and
``rounds``), goes through :func:`keyed_gap`, whose memory grows with S and
the program's rows, never with n × n.  Either may carry
``expected_iterations(backend)``, the ``EvalStats.total_iterations()`` it
expects over all strata.
"""

from __future__ import annotations

import torch


def closure_gap(rows: torch.Tensor, ref) -> dict[str, int]:
    """Facts the program's rows (``[count, 2]``) miss and add against a
    reference :class:`~bench.reference.linear_closure.Closure`, and rows
    that repeat a fact."""
    keys, bits = ref.keys, ref.bits
    x, y = rows[:, 0].to(device=bits.device, dtype=torch.int64), rows[:, 1].to(
        device=bits.device, dtype=torch.int64)
    idx = torch.searchsorted(keys, x.contiguous()).clamp(max=len(keys) - 1)
    keyed = (keys[idx] == x) & (y >= 0) & (y < bits.shape[1])
    got = torch.zeros_like(bits)
    got[idx[keyed], y[keyed]] = True
    n_keyed = int(keyed.sum())
    distinct = int(got.sum())
    return {
        "missing_facts": int((bits & ~got).sum()),
        "extra_facts": int((got & ~bits).sum()) + len(rows) - n_keyed,
        "duplicate_rows": n_keyed - distinct,
    }


def keyed_gap(rows: torch.Tensor, ref) -> dict[str, int]:
    """The program's rows (``[count, 2]`` key and value, or ``[count, 1]``
    keys) against a reference with one value per key: reference keys the
    program lacks or holds with another value, program rows whose key the
    reference lacks or whose value differs, and rows that repeat a key."""
    keys = ref.keys
    x = rows[:, 0].to(device=keys.device, dtype=torch.int64).contiguous()
    idx = torch.searchsorted(keys, x).clamp(max=max(len(keys) - 1, 0))
    match = keys[idx] == x if len(keys) else torch.zeros_like(x, dtype=torch.bool)
    if ref.values is not None:
        y = rows[:, 1].to(device=keys.device, dtype=torch.int64)
        match &= ref.values[idx] == y
    held = torch.zeros(len(keys), dtype=torch.bool, device=keys.device)
    held[idx[match]] = True
    return {
        "missing_facts": len(keys) - int(held.sum()),
        "extra_facts": len(rows) - int(match.sum()),
        "duplicate_rows": len(rows) - len(torch.unique(x)),
    }


def idb_gap(rows: torch.Tensor, ref) -> dict[str, int]:
    """:func:`closure_gap` for a closure, :func:`keyed_gap` otherwise."""
    return closure_gap(rows, ref) if hasattr(ref, "bits") else keyed_gap(rows, ref)


def reference_iterations(ref, backend: str) -> int:
    """The reference's own count where it carries one, else
    :func:`expected_iterations` of its rounds."""
    own = getattr(ref, "expected_iterations", None)
    return own(backend) if own is not None else expected_iterations(ref.rounds, backend)


def expected_iterations(rounds: int, backend: str) -> int:
    """The engine's ``EvalStats`` count for a fixpoint whose base is followed
    by ``rounds`` productive rounds: PBME counts its products, the last
    (empty) one included; the tuple path counts the base round too."""
    return rounds + (1 if backend == "bitmatrix" else 2)


def verdict(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def exact(**values: int) -> dict[str, dict]:
    return {name: {"value": int(v), "limit": 0} for name, v in values.items()}
