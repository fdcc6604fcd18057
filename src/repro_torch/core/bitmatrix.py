"""PBME — Parallel Bit-Matrix Evaluation (paper §5.3).

A dense binary IDB over active domain n is an n×n bit matrix, packed 32
bits/word: ``int32[n, ceil(n/32)]`` (bit j of word w = column 32w+j; see
``kernels/ref.py``).  One semi-naïve iteration of TC is a boolean-semiring
product of the Δ frontier against the arc matrix, with dedup +
set-difference fused into the epilogue::

    New = Δ ⊛ Arc          (boolean matmul — kernels.bitmm)
    Δ'  = New & ~M         (set difference = bit andnot)
    M   = M | Δ'           (merge = bit or)

Every product goes through :mod:`repro_torch.kernels.bitmm`: the CUDA kernel
for a CUDA tensor, the plain version for a CPU one.  The serving layer's
increments (``tc_increment``, ``sg_increment``) multiply a *row-compacted*
frontier: the k rows of Δ that hold a bit are gathered and the kernel runs
at M = k (and, in SG's sandwich product, K = k), since it takes any M and K;
the product is scattered back into n rows.  The reference skips compaction
when it runs its Pallas kernel and pays the full n³ product there.

Pattern matching: a stratum qualifies for PBME when it is a recursive binary
IDB whose rules are TC-shaped (ΔM ⊛ E) or SG-shaped (Eᵀ ⊛ ΔM ⊛ E), with no
aggregation.  Everything else falls back to the tuple path.

Residency: :meth:`BitmatrixPlan.execute` returns the packed arc and fixpoint
as a :class:`PackedStratum`, which the engine hands to the serving layer.
An insert runs :meth:`PackedStratum.insert`, which returns a new one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.analyzer import Stratum
from repro_torch.core.ast import Var
from repro_torch.core.relation import TupleRelation
from repro_torch.kernels.bitmm import bitmm, bitmm_fused_delta
from repro_torch.kernels.bitpack import bitmatrix_to_table, edges_to_bitmatrix
from repro_torch.kernels.ref import pack_bits, unpack_bits
from repro_torch.obs.trace import NOOP_SPAN, TRACER as _TRACE


# --------------------------------------------------------------------------
# packed bit-matrix primitives
# --------------------------------------------------------------------------


def _popcount_words(packed: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts (SWAR on int32: every right shift is masked)."""
    x = packed
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Total number of set bits (the Δ-count statistic), int64."""
    return _popcount_words(packed).sum(dtype=torch.int64)


def popcount_rows(packed: torch.Tensor) -> torch.Tensor:
    """Per-row set-bit counts — the frontier-compaction statistic, int32."""
    return _popcount_words(packed).sum(dim=1, dtype=torch.int32)


def transpose_packed(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """The transpose of a packed ``rows × cols`` bit matrix: ``int32[rows,
    ceil(cols/32)]`` → ``int32[cols, ceil(rows/32)]``.  Square (n × n) on
    the fixpoint paths; rectangular (k × n → n × k) in the sandwich product."""
    return pack_bits(unpack_bits(packed, cols).T)


def packed_identity(n: int, device) -> torch.Tensor:
    """The packed n × n identity: SG's ``x != y`` mask."""
    return pack_bits(torch.eye(n, dtype=torch.bool, device=device))


# --------------------------------------------------------------------------
# fixpoint loops
# --------------------------------------------------------------------------


def tc_fixpoint(
    arc: torch.Tensor, n: int, *, max_iters: int = 10_000, span=NOOP_SPAN
) -> tuple[torch.Tensor, int]:
    """Transitive closure: M ← M | (Δ ⊛ Arc) until Δ = ∅ (Alg. 2, vectorized).

    One fused product per iteration, the last one (an empty Δ) included.
    ``span`` (the caller's ``pbme.fixpoint``) gets the ``products`` launched.
    """
    m = arc
    delta = arc
    iters = products = 0
    while iters < max_iters:
        delta, m_new = bitmm_fused_delta(delta, arc, m)
        products += 1
        if int(popcount(delta)) == 0:
            break
        m = m_new
        iters += 1
    span.set(products=products)
    return m, iters + 1


def sg_fixpoint(
    arc: torch.Tensor, n: int, *, max_iters: int = 10_000, span=NOOP_SPAN
) -> tuple[torch.Tensor, int]:
    """Same generation (Alg. 3):  sg ← Aᵀ⊛A & ~I;  Δ' = Aᵀ⊛Δ⊛A & ~sg.

    One product for the base, two per iteration; ``span`` (the caller's
    ``pbme.fixpoint``) gets the ``products`` launched.  ``x != y`` masks the
    base alone: the recursive rule derives ``sg(x, x)`` and keeps it.
    """
    device = arc.device
    with _TRACE.device_span("pbme.transpose", "pbme", device=device, n=n):
        arc_t = transpose_packed(arc, n)
    with _TRACE.device_span("pbme.mask", "pbme", device=device, n=n):
        eye = packed_identity(n, device)
    sg = bitmm(arc_t, arc) & ~eye
    products = 1
    delta = sg
    iters = 0
    while iters < max_iters:
        new = bitmm(bitmm(arc_t, delta), arc)
        products += 2
        delta = new & ~sg
        if int(popcount(delta)) == 0:
            break
        sg = sg | delta
        iters += 1
    span.set(products=products)
    return sg, iters + 1


# --------------------------------------------------------------------------
# row-compacted products and the serving increments
# --------------------------------------------------------------------------


def _frontier_rows(delta: torch.Tensor) -> torch.Tensor:
    """Indices of the rows of ``delta`` that hold a set bit, on its device.

    ``torch.nonzero`` copies one count to the host: the one sync per call,
    which doubles as the increments' termination test.
    """
    return torch.nonzero(popcount_rows(delta)).flatten()


def bitmm_rows(
    a_packed: torch.Tensor, b_packed: torch.Tensor, n: int, row_idx: torch.Tensor
) -> torch.Tensor:
    """Row-compacted boolean product: only the ``row_idx`` rows of A against B.

    The paper's per-row worklists become frontier row compaction: the Δ
    frontier usually has few nonzero rows, so the work shrinks from n×n×n to
    |frontier|×n×n.  The result is scattered back into an n-row zero matrix.
    """
    return bitmm_chain_rows(a_packed, (b_packed,), n, row_idx)


def bitmm_chain_rows(
    a_packed: torch.Tensor, mats: tuple, n: int, row_idx: torch.Tensor
) -> torch.Tensor:
    """Row-compacted product chain: ``A[rows] ⊛ mats[0] ⊛ mats[1] …``.

    The intermediate products stay compacted to the k frontier rows, so each
    factor is one kernel launch at M = k (any k: the kernel needs no
    power-of-two bucket, so nothing is padded).  Rows outside ``row_idx``
    of the result are zero.
    """
    sub = a_packed[row_idx]
    for b_packed in mats:
        sub = bitmm(sub, b_packed)
    out = torch.zeros(
        (a_packed.shape[0], sub.shape[1]), dtype=torch.int32, device=a_packed.device
    )
    out[row_idx] = sub
    return out


def _sandwich_rows(
    delta: torch.Tensor, arc: torch.Tensor, n: int, row_idx: torch.Tensor
) -> torch.Tensor:
    """``arcᵀ ⊛ Δ ⊛ arc`` for a *symmetric* Δ whose nonzero rows are
    ``row_idx`` — both contractions run over the k-row frontier block:

        new(i, j) = OR_{r ∈ R} arc(r, i) · (Δ ⊛ arc)(r, j)

    (Δ symmetric ⇒ the contraction of arcᵀ⊛Δ only ranges over Δ's rows),
    so the cost is 2·k·n² instead of 2·n³.  Two kernel launches:
    ``T = Δ[R] ⊛ arc`` at M = k, then ``arc[R]ᵀ ⊛ T`` at K = k, whose A is
    the rectangular transpose of the k × n block ``arc[R]``.
    """
    t = bitmm(delta[row_idx], arc)                                  # k × n
    return bitmm(transpose_packed(arc[row_idx], n), t)              # n × n


def tc_increment(
    m: torch.Tensor,
    arc: torch.Tensor,
    delta_arc: torch.Tensor,
    n: int,
    *,
    max_iters: int = 10_000,
) -> tuple[torch.Tensor, int]:
    """Resume TC from its fixpoint after ``arc`` gains ``delta_arc`` edges.

    Insert-only IVM on the bit matrix: every new closure pair decomposes at
    its *first* new edge into (old path | empty) · Δarc · (suffix in arc′), so

        Δ₀ = (M ⊛ Δarc  |  Δarc) & ~M        # seed: prefix + first new edge
        Δ  ← (Δ ⊛ arc′) & ~M                 # extend suffix one arc at a time

    ``arc`` must already include the new edges.  The seed's big product is
    computed transposed (Δarcᵀ ⊛ Mᵀ) so its row frontier is the handful of
    new-edge heads; loop products compact to the Δ frontier rows whenever
    the frontier holds at most n // 2 rows.  Returns (new fixpoint,
    iterations).
    """
    dat = transpose_packed(delta_arc, n)
    heads = _frontier_rows(dat)
    if len(heads) == 0:
        return m, 0
    if len(heads) <= n // 2:
        ext = transpose_packed(bitmm_rows(dat, transpose_packed(m, n), n, heads), n)
    else:
        ext = bitmm(m, delta_arc)
    delta = (ext | delta_arc) & ~m
    iters = 0
    while iters < max_iters:
        frontier = _frontier_rows(delta)   # doubles as the termination test
        if len(frontier) == 0:
            break
        m = m | delta
        # extend through the *growing closure*, not just single arcs: old-path
        # suffix segments absorb in one step (m is transitively closed over
        # everything absorbed so far), so iterations scale with the number of
        # new edges on a path, not its length
        reach = arc | m
        if len(frontier) <= n // 2:
            new = bitmm_rows(delta, reach, n, frontier)
        else:
            new = bitmm(delta, reach)
        delta = new & ~m
        iters += 1
    return m, iters


def sg_increment(
    sg: torch.Tensor,
    arc: torch.Tensor,
    delta_arc: torch.Tensor,
    n: int,
    *,
    max_iters: int = 10_000,
) -> tuple[torch.Tensor, int]:
    """Resume SG from its fixpoint after ``arc`` gains ``delta_arc`` edges.

    A new sg pair's derivation tree contains a new component at some level:
    either a new base pair (arc′ᵀ⊛arc′ & ~I), a new wrapping edge around an
    *old* sg fact (arc′ᵀ⊛sg⊛Δarc or Δarcᵀ⊛sg⊛arc′), or a new inner sg fact —
    the last is exactly what the resumed Δ loop derives.  ``arc`` must
    already include the new edges.
    """
    dat = transpose_packed(delta_arc, n)
    heads = _frontier_rows(dat)              # dst endpoints of the new edges
    if len(heads) == 0:                      # doubles as the empty-Δ test
        return sg, 0
    eye = packed_identity(n, arc.device)
    if len(heads) <= n // 2:
        # every seed product has Δarcᵀ as one factor, so chain the whole
        # thing through its |heads|-row block: k·n² per factor, not n³.
        # base:  (Δaᵀ⊛arc′ | its transpose) covers base pairs with ≥1 new edge
        # wraps: arc′ᵀ⊛sg⊛Δa = (Δaᵀ⊛sgᵀ⊛arc′)ᵀ   and   Δaᵀ⊛sg⊛arc′
        t1 = bitmm_chain_rows(dat, (arc,), n, heads)
        seed = (t1 | transpose_packed(t1, n)) & ~eye
        seed = seed | transpose_packed(
            bitmm_chain_rows(dat, (transpose_packed(sg, n), arc), n, heads), n
        )
        seed = seed | bitmm_chain_rows(dat, (sg, arc), n, heads)
    else:
        arc_t = transpose_packed(arc, n)
        seed = bitmm(arc_t, arc) & ~eye
        seed = seed | bitmm(bitmm(arc_t, sg), delta_arc)
        seed = seed | bitmm(bitmm(dat, sg), arc)
    delta = seed & ~sg
    iters = 0
    while iters < max_iters:
        frontier = _frontier_rows(delta)   # doubles as the termination test
        if len(frontier) == 0:
            break
        sg = sg | delta
        if len(frontier) <= n // 2:
            # Δ is symmetric throughout (sg and every seed term are), so the
            # sandwich product contracts over Δ's row block alone
            new = _sandwich_rows(delta, arc, n, frontier)
        else:
            new = bitmm(bitmm(transpose_packed(arc, n), delta), arc)
        delta = new & ~sg
        iters += 1
    return sg, iters


# --------------------------------------------------------------------------
# stratum pattern matching (engine integration)
# --------------------------------------------------------------------------


@dataclass
class BitmatrixPlan:
    kind: str                 # "tc" | "sg"
    idb: str
    edb: str
    n: int
    iterations: int = 0

    def execute(self, store: dict[str, Any], engine) -> PackedStratum:
        """Run the fixpoint on the EDB's device and install the IDB as a
        :class:`TupleRelation`, converted from the packed matrix on the device
        (the same sorted rows, count and capacity as ``from_numpy``).  Returns
        the packed arc and fixpoint."""
        edb = store[self.edb]
        device = edb.rows.device
        with _TRACE.device_span("pbme.build", "pbme", device=device, n=self.n) as sp:
            arc = edges_to_bitmatrix(edb.rows[: edb.count], self.n)
            sp.set(rows=edb.count)
        fixpoint = tc_fixpoint if self.kind == "tc" else sg_fixpoint
        with _TRACE.device_span("pbme.fixpoint", "pbme", device=device, n=self.n,
                                plan=self.kind) as sp:
            m, self.iterations = fixpoint(arc, self.n, span=sp)
            sp.set(iterations=self.iterations)
        with _TRACE.device_span("pbme.to_rows", "pbme", device=device, n=self.n) as sp:
            rows, count = bitmatrix_to_table(m, self.n)
            sp.set(rows=count)
        store[self.idb] = TupleRelation(self.idb, 2, rows, count, engine.domain)
        return PackedStratum(self, arc, m)


# --------------------------------------------------------------------------
# a resident stratum (serving)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedStratum:
    """A PBME stratum kept on the device between updates: its plan, the
    packed arc and the packed fixpoint ``m``, each ``int32[n, ceil(n/32)]``.

    No operation writes a matrix in place (``m`` may be ``arc`` itself, when
    TC's fixpoint ends in its first round), so an epoch that holds one keeps
    its words while a writer builds the next.
    """

    plan: BitmatrixPlan
    arc: torch.Tensor
    m: torch.Tensor

    @classmethod
    def pack(cls, plan: BitmatrixPlan, handles: dict[str, Any], domain: int) -> PackedStratum:
        """Pack the stored EDB and IDB tables of ``plan`` on their device."""
        arc, m = (
            edges_to_bitmatrix(h.rows[: h.count], domain)
            for h in (handles[plan.edb], handles[plan.idb])
        )
        return cls(plan, arc, m)

    def insert(
        self, view, domain: int, capacity_min: int
    ) -> tuple[PackedStratum, torch.Tensor, int, int]:
        """Resume the fixpoint after the EDB gains ``view``'s rows, on the
        device: the new edges are packed, the increment runs the ``bitmm``
        kernel on the compacted frontier, and the new pairs go from matrix to
        sorted rows.  Returns ``(stratum, rows, count, iterations)``."""
        d_arc = edges_to_bitmatrix(view.rows[: view.count], domain)
        arc = self.arc | d_arc
        increment = tc_increment if self.plan.kind == "tc" else sg_increment
        m, iters = increment(self.m, arc, d_arc, domain)
        rows, count = bitmatrix_to_table(m & ~self.m, domain, capacity_min)
        return PackedStratum(self.plan, arc, m), rows, count, iters

    def diff(
        self, old: PackedStratum, domain: int, capacity_min: int
    ) -> tuple[tuple[torch.Tensor, int] | None, tuple[torch.Tensor, int] | None]:
        """The facts gained and lost since ``old``, this stratum's fixpoint
        before a recompute at the same domain: ``(added, removed)``, each
        ``(rows, count)`` as :func:`bitmatrix_to_table` gives them, or
        ``None`` where no bit changed.  The words are diffed on the device and
        one host sync reads which sides hold a bit; only those are converted.

        The rows equal a diff of the two stored tables only while each table
        holds exactly the set bits of its ``m``, as every resident stratum's
        does."""
        masks = (self.m & ~old.m, old.m & ~self.m)
        hits = torch.stack([w.any() for w in masks]).tolist()
        added, removed = (
            bitmatrix_to_table(words, domain, capacity_min) if hit else None
            for words, hit in zip(masks, hits)
        )
        return added, removed


def _is_var(t, name=None):
    return isinstance(t, Var) and (name is None or t.name == name)


def eligible_plan(stratum: Stratum, domain: int, config) -> BitmatrixPlan | None:
    """The full PBME gate: shape match + backend/memory policy.

    Shared by the engine's fast path and the serving layer's bit-matrix
    residency, which must agree on which strata are bit-matrix evaluated.
    """
    plan, _reason = explain_eligibility(stratum, domain, config)
    return plan


def explain_eligibility(
    stratum: Stratum, domain: int | None, config
) -> tuple[BitmatrixPlan | None, str]:
    """:func:`eligible_plan` plus the *reason*.

    Returns ``(plan, reason)``; ``plan`` is ``None`` iff the stratum is
    ineligible, and ``reason`` then states the first gate it failed.
    ``domain=None`` skips the runtime memory gate.
    """
    if config.backend not in ("auto", "bitmatrix"):
        return None, f"backend={config.backend!r} disables the bit-matrix path"
    if stratum.has_recursive_agg:
        return None, "stratum contains a recursive aggregate"
    plan, reason = explain_bitmatrix_stratum(stratum, domain, config)
    if plan is None:
        return None, reason
    if (
        config.backend != "bitmatrix"
        and domain is not None
        and domain > config.max_bitmatrix_n
    ):
        return None, (
            f"active domain {domain} exceeds max_bitmatrix_n "
            f"{config.max_bitmatrix_n} (n^2-bit matrix would not fit the "
            "memory policy)"
        )
    return plan, reason


def explain_bitmatrix_stratum(
    stratum: Stratum, domain: int | None, config
) -> tuple[BitmatrixPlan | None, str]:
    """Shape matcher with a reason for every rejection."""
    if not stratum.recursive:
        return None, "stratum is not recursive"
    if stratum.mutual or len(stratum.preds) != 1:
        return None, (
            f"mutual recursion over {stratum.preds} (PBME handles a single "
            "self-recursive predicate)"
        )
    idb = stratum.preds[0]
    rules = stratum.rules
    if any(r.has_aggregate for r in rules):
        return None, "stratum contains an aggregate head"
    if any(a.negated for r in rules for a in r.atoms):
        return None, "stratum contains a negated body atom"
    if len(rules) != 2:
        return None, (
            f"expected exactly 2 rules (one base, one recursive), found "
            f"{len(rules)}"
        )
    base = next((r for r in rules if all(a.pred != idb for a in r.atoms)), None)
    rec = next((r for r in rules if any(a.pred == idb for a in r.atoms)), None)
    if base is None:
        return None, "no non-recursive base rule"
    if rec is None:
        return None, "no recursive rule"
    return _match_shapes(idb, base, rec, domain)


def _match_shapes(
    idb: str, base, rec, domain: int | None
) -> tuple[BitmatrixPlan | None, str]:
    n = domain if domain is not None else 0

    # TC:  idb(x,y) :- e(x,y).   idb(x,y) :- idb(x,z), e(z,y).
    if (
        len(base.atoms) == 1
        and not base.comparisons
        and base.atoms[0].arity == 2
        and len(base.head_terms) == 2
        and base.atoms[0].terms == base.head_terms
        and len(rec.atoms) == 2
        and not rec.comparisons
    ):
        a0, a1 = rec.atoms
        h = rec.head_terms
        if (
            a0.pred == idb
            and a1.pred == base.atoms[0].pred
            and a0.arity == a1.arity == 2
            and _is_var(h[0])
            and _is_var(h[1])
            and a0.terms[0] == h[0]
            and a0.terms[1] == a1.terms[0]
            and a1.terms[1] == h[1]
        ):
            return (
                BitmatrixPlan("tc", idb, base.atoms[0].pred, n),
                "TC-shaped stratum (packed boolean matrix closure)",
            )

    # SG:  idb(x,y) :- e(p,x), e(p,y), x != y.
    #      idb(x,y) :- e(a,x), idb(a,b), e(b,y).
    if (
        len(base.atoms) == 2
        and len(base.comparisons) == 1
        and base.comparisons[0].op == "!="
        and len(rec.atoms) == 3
    ):
        e = base.atoms[0].pred
        b0, b1 = base.atoms
        h = base.head_terms
        sg_base_ok = (
            b0.pred == b1.pred == e
            and b0.terms[0] == b1.terms[0]
            and b0.terms[1] == h[0]
            and b1.terms[1] == h[1]
        )
        r0, r1, r2 = rec.atoms
        hr = rec.head_terms
        sg_rec_ok = (
            r0.pred == e
            and r1.pred == idb
            and r2.pred == e
            and r0.terms[1] == hr[0]
            and r0.terms[0] == r1.terms[0]
            and r1.terms[1] == r2.terms[0]
            and r2.terms[1] == hr[1]
        )
        if sg_base_ok and sg_rec_ok:
            return (
                BitmatrixPlan("sg", idb, e, n),
                "SG-shaped stratum (packed boolean matrix closure)",
            )

    return None, "rule shapes match neither the TC nor the SG pattern"
