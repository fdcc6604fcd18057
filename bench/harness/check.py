"""The comparison that decides ``correct``.

Every number compared is exact, so every limit is 0: a fixpoint either holds
every fact the reference derives and no other, or it is wrong.  The program's
outputs are only read here, never handed to the reference.
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


def expected_iterations(rounds: int, backend: str) -> int:
    """The engine's ``EvalStats`` count for a fixpoint whose base is followed
    by ``rounds`` productive rounds: PBME counts its products, the last
    (empty) one included; the tuple path counts the base round too."""
    return rounds + (1 if backend == "bitmatrix" else 2)


def verdict(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def exact(**values: int) -> dict[str, dict]:
    return {name: {"value": int(v), "limit": 0} for name, v in values.items()}
