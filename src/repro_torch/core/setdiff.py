"""Dynamic Set Difference (DSD) — paper §5.1 + Appendix A, adapted to sorted tables.

The paper's OPSD builds a hash table on the (ever-growing) full relation R and
probes R_δ; TPSD intersects first so the build happens on the smaller side.
On the sorted-table backend there is no hash build, but the *asymmetry the
cost model arbitrates still exists*: which side gets probed.

* ``opsd``  — probe R_δ's keys into sorted R (cost ≈ |R_δ|·log|R|; the analogue
  of "probe into the structure that already exists on R").
* ``tpsd``  — two phases: (1) intersection r = R_δ ∩ R by probing the *smaller*
  side into the larger; (2) anti-join R_δ against r (cost involves |r|).

The per-iteration choice keeps the paper's cost model *verbatim*
(α = C_b/C_p from offline calibration, β = |R|/|R_δ|, μ = |R_δ|/|r| estimated
from the previous iteration):  OPSD iff β ≤ 1; TPSD iff β ≥ 2α/(α−1);
otherwise compare costs with μ ≈ μ_prev (Appendix A Eq. 5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.joins import membership
from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.relational.sort import SENTINEL, argsort_rows


@dataclass
class DSDState:
    """Per-IDB dynamic state: previous iteration's μ (paper's heuristic)."""

    alpha: float = 4.0
    mu_prev: float = 2.0

    def choose(self, r_size: int, delta_size: int) -> str:
        if delta_size == 0:
            return "opsd"
        beta = r_size / max(delta_size, 1)
        if beta <= 1.0:
            return "opsd"
        thresh = 2 * self.alpha / max(self.alpha - 1.0, 1e-6)
        if beta >= thresh:
            return "tpsd"
        # grey zone: paper Eq. (5) — Cost(OPSD) − Cost(TPSD) =
        #   μ|r|C_p[β(α−1) − (α + α/μ)]; positive ⇒ TPSD cheaper.
        mu = max(self.mu_prev, 1.0)
        diff = beta * (self.alpha - 1.0) - (self.alpha + self.alpha / mu)
        return "tpsd" if diff > 0 else "opsd"

    def observe(self, delta_in: int, intersect: int) -> None:
        if intersect > 0:
            self.mu_prev = delta_in / intersect


def opsd(
    delta_rows: torch.Tensor, r_rows: torch.Tensor, domain: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """ΔR = R_δ − R by probing R_δ into sorted R.  Returns (keep_mask, member)."""
    member = membership(delta_rows, r_rows, domain)
    keep = ~member & (delta_rows[:, 0] != SENTINEL)
    return keep, member


def tpsd(
    delta_rows: torch.Tensor,
    delta_count: int,
    r_rows: torch.Tensor,
    r_count: int,
    domain: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-phase: intersection first (probe smaller into larger), then anti."""
    if r_count <= delta_count:
        # probe R into R_δ to find the intersection, then mark Δ rows
        r_in_delta = membership(r_rows, delta_rows, domain)
        inter_rows = torch.where(r_in_delta[:, None], r_rows, SENTINEL)
        # re-sort: punching SENTINELs breaks sortedness, and membership's
        # compact-key fast path requires a sorted table
        inter_rows = inter_rows[argsort_rows(inter_rows, domain)]
        # phase 2: which Δ rows are in the (small) intersection?
        member = membership(delta_rows, inter_rows, domain)
    else:
        member = membership(delta_rows, r_rows, domain)   # probe smaller (Δ)
    keep = ~member & (delta_rows[:, 0] != SENTINEL)
    return keep, member


def set_difference(
    delta_rows: torch.Tensor,
    delta_count: int,
    r_rows: torch.Tensor,
    r_count: int,
    domain: int,
    state: DSDState,
    mode: str = "dynamic",
) -> tuple[torch.Tensor, int, str]:
    """DSD dispatch.  Returns (ΔR rows compacted+sorted, count, strategy)."""
    strategy = mode if mode in ("opsd", "tpsd") else state.choose(r_count, delta_count)
    if strategy == "opsd":
        keep, member = opsd(delta_rows, r_rows, domain)
    else:
        keep, member = tpsd(delta_rows, delta_count, r_rows, r_count, domain)
    inter = int(member.sum())
    state.observe(delta_count, inter)
    kept = torch.where(keep[:, None], delta_rows, SENTINEL)
    out = kept[torch.argsort(~keep, stable=True)]   # compact, preserving sort order
    return out, int(keep.sum()), strategy


def calibrate_alpha(
    n: int = 1 << 14, k: int = 3, seed: int = 0, device: str | torch.device = "cuda"
) -> float:
    """Offline α calibration (paper Appendix A Eq. 7), measured on ``device``.

    Measures the per-tuple cost ratio of the 'build' primitive (sorting an
    unsorted table — our analogue of hash-table construction) to the 'probe'
    primitive (searchsorted membership).
    """
    dev = torch.device(device)

    def timed(fn) -> float:
        fn()                                            # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            _TRACE.count_sync()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            _TRACE.count_sync()
        return time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    ratios = []
    for _ in range(k):
        a = torch.as_tensor(rng.integers(0, n, size=(n, 2), dtype=np.int32), device=dev)
        b = torch.as_tensor(np.sort(rng.integers(0, n, size=n, dtype=np.int32)), device=dev)
        p = torch.as_tensor(rng.integers(0, n, size=n, dtype=np.int32), device=dev)
        t_build = timed(lambda: torch.sort(a[:, 0]))
        t_probe = timed(lambda: torch.searchsorted(b, p))
        ratios.append(max(t_build / max(t_probe, 1e-9), 1.01))
    return float(np.mean(ratios))
