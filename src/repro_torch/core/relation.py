"""Device-resident relations (EOST: state never leaves the device).

Three physical representations, chosen by the engine per-IDB (the paper's
"specialized data structures" lever):

* :class:`TupleRelation`    — sorted ``int32[capacity, arity]`` + count; the
  general representation (program analysis, arbitrary arity).
* :class:`DenseSetRelation` — ``bool[n]`` for unary recursive IDBs (REACH):
  the bit-vector cousin of PBME.
* :class:`DenseAggRelation` — ``int32[n]`` best-value table for recursive
  MIN/MAX aggregates (CC, SSSP): a group-by whose key is the active domain
  *is* a dense array.

Capacities are power-of-two buckets; growth doubles the bucket.  Handles are
immutable: every update returns a new handle and leaves its input untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.relational.sort import SENTINEL, argsort_rows, compact_key, unique_mask

INT_INF = SENTINEL

#: Bytes a device → host copy moves per step.  One pageable copy of a 1 GB
#: table holds the CUDA driver for half a second on an H100 host, and every
#: other thread's copies (a server's reads) wait behind it; in steps through
#: a pinned buffer each wait is a few milliseconds.
HOST_COPY_CHUNK_BYTES = 64 << 20


def next_bucket(n: int, minimum: int = 128) -> int:
    return max(minimum, 1 << int(np.ceil(np.log2(max(n, 1)))))


def empty_delta(arity: int, device: torch.device | str, minimum: int = 128) -> torch.Tensor:
    """The normalized empty Δ/∇ view: a minimum-bucket SENTINEL table."""
    return torch.full((next_bucket(0, minimum), arity), SENTINEL, dtype=torch.int32,
                      device=device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t``'s contents as a host numpy array.  A CUDA tensor larger than
    :data:`HOST_COPY_CHUNK_BYTES` is copied in steps of that size through a
    pinned buffer, each on the caller's current stream, which is then
    synchronised; the caller orders that stream after ``t``'s writer."""
    if t.device.type != "cuda" or t.numel() * t.element_size() <= HOST_COPY_CHUNK_BYTES:
        return t.cpu().numpy()
    src = t.reshape(-1)
    out = torch.empty(t.shape, dtype=t.dtype)
    dst = out.view(-1)
    step = HOST_COPY_CHUNK_BYTES // t.element_size()
    stage = torch.empty(step, dtype=t.dtype, pin_memory=True)
    stream = torch.cuda.current_stream(t.device)
    for a in range(0, src.numel(), step):
        n = min(step, src.numel() - a)
        stage[:n].copy_(src[a : a + n], non_blocking=True)
        stream.synchronize()
        dst[a : a + n].copy_(stage[:n])
    return out.numpy()


def _sort_pad(rows: torch.Tensor, capacity: int, domain: int) -> torch.Tensor:
    pad = torch.full((capacity - rows.shape[0], rows.shape[1]), SENTINEL,
                     dtype=torch.int32, device=rows.device)
    rows = torch.cat([rows.to(torch.int32), pad], dim=0)
    return rows[argsort_rows(rows, domain)]


def _compact(rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Rows where ``keep`` first (in order), SENTINEL rows after."""
    kept = torch.where(keep[:, None], rows, SENTINEL)
    return kept[torch.argsort(~keep, stable=True)]


def _dedup_sorted(rows: torch.Tensor, domain: int) -> tuple[torch.Tensor, int]:
    """Sorted rows → (unique rows first + SENTINEL pads, unique count)."""
    mask = unique_mask(rows)
    return _compact(rows, mask), int(mask.sum())


def _delete_sorted(
    table: torch.Tensor, cand: torch.Tensor, domain: int
) -> tuple[torch.Tensor, int, torch.Tensor, int]:
    """Remove candidate rows from a sorted table.

    ``cand`` is sorted + SENTINEL-padded.  Returns
    ``(removed, removed_count, kept, kept_count)`` — ``removed`` is the
    compacted intersection (the ∇R view, sorted), ``kept`` the table with
    those rows punched out and re-compacted at the original capacity.
    """
    from repro_torch.core.joins import membership

    present = membership(cand, table, domain)
    removed = _compact(cand, present)
    gone = membership(table, removed, domain)
    keep = ~gone & (table[:, 0] != SENTINEL)
    return removed, int(present.sum()), _compact(table, keep), int(keep.sum())


def _sorted_by_col(rows: torch.Tensor, col: int) -> tuple[torch.Tensor, torch.Tensor]:
    # pads already have SENTINEL keys; stable sort keeps lex order within key
    srt = rows[torch.argsort(rows[:, col], stable=True)]
    return srt, srt[:, col]


def _merge_sorted(
    a: torch.Tensor, b: torch.Tensor, capacity: int, domain: int
) -> torch.Tensor:
    """Merge two sorted disjoint tables into one sorted ``capacity`` table.

    Compact-key path is a true O(n) rank merge: each valid row's output
    position is its own index plus the count of smaller rows on the other
    side (two ``searchsorted`` passes + two scatters) — no full-table sort.
    Pad rows are masked out of the scatters.
    """
    ka = compact_key(a, domain)
    kb = compact_key(b, domain)
    if ka is None or kb is None:
        rows = torch.cat([a, b], dim=0)
        if rows.shape[0] < capacity:
            pad = torch.full((capacity - rows.shape[0], rows.shape[1]), SENTINEL,
                             dtype=torch.int32, device=rows.device)
            rows = torch.cat([rows, pad], dim=0)
        return rows[argsort_rows(rows, 0)][:capacity]
    pos_a = torch.arange(a.shape[0], device=a.device) + torch.searchsorted(kb, ka)
    pos_b = torch.arange(b.shape[0], device=b.device) + torch.searchsorted(ka, kb, right=True)
    va, vb = ka != SENTINEL, kb != SENTINEL
    out = torch.full((capacity, a.shape[1]), SENTINEL, dtype=torch.int32, device=a.device)
    out[pos_a[va]] = a[va].to(torch.int32)
    out[pos_b[vb]] = b[vb].to(torch.int32)
    return out


@dataclass
class TupleRelation:
    """Sorted fixed-capacity tuple table."""

    name: str
    arity: int
    rows: torch.Tensor       # int32[capacity, arity], lex-sorted, pads last
    count: int               # host-side valid-row count (the OOF statistic)
    domain: int              # active-domain size (compact-key eligibility)
    _by_col: dict[int, tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @classmethod
    def empty(cls, name: str, arity: int, domain: int, device, capacity: int = 128):
        rows = torch.full((capacity, arity), SENTINEL, dtype=torch.int32, device=device)
        return cls(name, arity, rows, 0, domain)

    @classmethod
    def from_numpy(cls, name: str, data: np.ndarray, domain: int, device):
        data = np.asarray(data, dtype=np.int32)
        if data.ndim == 1:
            data = data[:, None]
        data = np.unique(data, axis=0) if data.size else data
        cap = next_bucket(len(data))
        rows = _sort_pad(torch.as_tensor(data, device=device), cap, domain)
        return cls(name, data.shape[1], rows, int(len(data)), domain)

    def sorted_by(self, col: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Relation sorted by one column (join index); cached per column."""
        if col == 0:
            return self.rows, self.rows[:, 0]
        if col not in self._by_col:
            self._by_col[col] = _sorted_by_col(self.rows, col)
        return self._by_col[col]

    def merge(self, delta_rows: torch.Tensor, delta_count: int) -> "TupleRelation":
        """R ⊎ ΔR keeping the table sorted (ΔR pre-deduped, disjoint from R)."""
        if delta_count == 0:
            return self
        new_count = self.count + delta_count
        cap = self.capacity
        while cap < new_count:
            cap *= 2
        merged = _merge_sorted(self.rows, delta_rows, cap, self.domain)
        return TupleRelation(self.name, self.arity, merged, new_count, self.domain)

    def insert(self, data: np.ndarray) -> tuple["TupleRelation", torch.Tensor, int]:
        """Delta-append: dedup incoming rows against the table, merge the rest.

        Returns ``(updated_relation, delta_rows, delta_count)`` where
        ``delta_rows`` holds only the genuinely-new tuples (sorted, SENTINEL
        padded) — the ΔR seed for incremental view maintenance.
        """
        from repro_torch.core.setdiff import DSDState, set_difference

        data = np.asarray(data, np.int32).reshape(-1, self.arity)
        if data.size == 0:
            return self, empty_delta(self.arity, self.device), 0
        data = np.unique(data, axis=0)
        cap = next_bucket(len(data))
        cand = _sort_pad(torch.as_tensor(data, device=self.device), cap, self.domain)
        delta_rows, delta_count, _ = set_difference(
            cand, len(data), self.rows, self.count, self.domain,
            DSDState(), mode="opsd",
        )
        return self.merge(delta_rows, delta_count), delta_rows, delta_count

    def delete(self, data: np.ndarray) -> tuple["TupleRelation", torch.Tensor, int]:
        """Remove a batch of rows (rows not present are ignored).

        Returns ``(updated_relation, removed_rows, removed_count)`` where
        ``removed_rows`` holds exactly the tuples that were present and are
        now gone (sorted, SENTINEL padded) — the ∇R seed for DRed.  Capacity
        is preserved.
        """
        data = np.asarray(data, np.int32).reshape(-1, self.arity)
        # constants outside [0, domain) cannot be present (the table invariant
        # behind compact keys) — drop them, or the base-``domain`` key packing
        # would alias e.g. (a, domain) onto (a+1, 0)
        if data.size:
            data = data[((data >= 0) & (data < self.domain)).all(axis=1)]
        if data.size == 0 or self.count == 0:
            return self, empty_delta(self.arity, self.device), 0
        data = np.unique(data, axis=0)
        cap = next_bucket(len(data))
        return self.delete_rows(
            _sort_pad(torch.as_tensor(data, device=self.device), cap, self.domain)
        )

    def delete_rows(self, cand: torch.Tensor) -> tuple["TupleRelation", torch.Tensor, int]:
        """Device-side delete: ``cand`` already sorted + SENTINEL padded."""
        removed, r_count, kept, k_count = _delete_sorted(self.rows, cand, self.domain)
        if r_count == 0:
            return self, empty_delta(self.arity, self.device), 0
        return TupleRelation(self.name, self.arity, kept, k_count, self.domain), removed, r_count

    def device_buffers(self) -> tuple[torch.Tensor, ...]:
        """Every tensor this handle owns (reclamation accounting), the
        per-column sort copies cached by :meth:`sorted_by` included."""
        return (self.rows, *(a for pair in self._by_col.values() for a in pair))

    def to_numpy(self) -> np.ndarray:
        return self.rows[: self.count].cpu().numpy()

    def to_blocks(self) -> tuple[dict, dict[str, np.ndarray]]:
        """(meta, arrays) in the reference snapshot layout: the full
        sorted/padded table; per-column sort caches are not serialized."""
        meta = {
            "kind": "tuple",
            "arity": self.arity,
            "count": self.count,
            "domain": self.domain,
        }
        return meta, {"rows": to_host(self.rows)}

    @classmethod
    def from_blocks(cls, name: str, meta: dict, arrays: dict, device) -> "TupleRelation":
        rows = torch.tensor(np.asarray(arrays["rows"], np.int32), device=device)
        return cls(name, int(meta["arity"]), rows, int(meta["count"]), int(meta["domain"]))


def _bits_to_numpy(mask: torch.Tensor) -> np.ndarray:
    return np.packbits(mask.cpu().numpy())


def _bits_from_numpy(packed: np.ndarray, n: int, device) -> torch.Tensor:
    return torch.as_tensor(
        np.unpackbits(np.asarray(packed), count=n).astype(bool), device=device
    )


@dataclass
class DenseSetRelation:
    """Unary recursive IDB as a boolean membership vector (REACH)."""

    name: str
    n: int
    member: torch.Tensor     # bool[n]
    delta: torch.Tensor      # bool[n] — newly added last iteration
    count: int = 0
    delta_count: int = 0

    @classmethod
    def empty(cls, name: str, n: int, device):
        z = torch.zeros(n, dtype=torch.bool, device=device)
        return cls(name, n, z, z, 0, 0)

    def update(self, candidate_keys: torch.Tensor, valid: torch.Tensor) -> "DenseSetRelation":
        """Insert candidates; Δ = candidates not already members."""
        hit = torch.zeros(self.n, dtype=torch.bool, device=self.member.device)
        hit[candidate_keys[valid].long()] = True
        delta = hit & ~self.member
        member = self.member | delta
        return DenseSetRelation(
            self.name, self.n, member, delta, int(member.sum()), int(delta.sum())
        )

    def device_buffers(self) -> tuple[torch.Tensor, ...]:
        """Tensors owned by this handle (reclamation accounting)."""
        return (self.member, self.delta)

    def delta_tuples(self, capacity: int) -> tuple[torch.Tensor, int]:
        """Materialize Δ as a (capacity, 1) tuple view for the join machinery."""
        return _key_column(self.delta, capacity)[:, None], self.delta_count

    def to_numpy(self) -> np.ndarray:
        return np.flatnonzero(self.member.cpu().numpy()).astype(np.int32)[:, None]

    def to_blocks(self) -> tuple[dict, dict[str, np.ndarray]]:
        """(meta, arrays): membership and live Δ, bit-packed (``np.packbits``)."""
        meta = {"kind": "dense_set", "n": self.n}
        return meta, {"member": _bits_to_numpy(self.member), "delta": _bits_to_numpy(self.delta)}

    @classmethod
    def from_blocks(cls, name: str, meta: dict, arrays: dict, device) -> "DenseSetRelation":
        n = int(meta["n"])
        member = _bits_from_numpy(arrays["member"], n, device)
        delta = _bits_from_numpy(arrays["delta"], n, device)
        return cls(name, n, member, delta, int(member.sum()), int(delta.sum()))


def _key_column(present: torch.Tensor, capacity: int) -> torch.Tensor:
    """Sorted ``int32`` keys where ``present``, then SENTINELs, cut to
    ``capacity`` (or to ``n`` when ``capacity > n``)."""
    n = present.shape[0]
    keys = torch.where(present, torch.arange(n, device=present.device), SENTINEL)
    return torch.sort(keys).values[:capacity].to(torch.int32)


@dataclass
class DenseAggRelation:
    """Recursive MIN/MAX aggregate IDB as a dense best-value table (CC/SSSP)."""

    name: str
    n: int
    op: str                  # "MIN" | "MAX"
    values: torch.Tensor     # int32[n]; INT_INF (MIN) / -INT_INF (MAX) = absent
    delta: torch.Tensor      # bool[n] — keys improved last iteration
    count: int = 0
    delta_count: int = 0

    @property
    def absent(self) -> int:
        return INT_INF if self.op == "MIN" else -INT_INF

    @classmethod
    def empty(cls, name: str, n: int, op: str, device):
        absent = INT_INF if op == "MIN" else -INT_INF
        return cls(
            name,
            n,
            op,
            torch.full((n,), absent, dtype=torch.int32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            0,
            0,
        )

    def update(
        self, candidate_keys: torch.Tensor, candidate_vals: torch.Tensor, valid: torch.Tensor
    ) -> "DenseAggRelation":
        keys = torch.where(valid, candidate_keys, 0).long()
        absent = self.absent
        vals = torch.where(valid, candidate_vals, absent).to(torch.int32)
        best = torch.full((self.n,), absent, dtype=torch.int32, device=self.values.device)
        if self.op == "MIN":
            best = best.scatter_reduce(0, keys, vals, "amin", include_self=True)
            improved = best < self.values
            values = torch.minimum(self.values, best)
        else:
            best = best.scatter_reduce(0, keys, vals, "amax", include_self=True)
            improved = best > self.values
            values = torch.maximum(self.values, best)
        return DenseAggRelation(
            self.name,
            self.n,
            self.op,
            values,
            improved,
            int((values != absent).sum()),
            int(improved.sum()),
        )

    def _tuples(self, present: torch.Tensor, capacity: int) -> torch.Tensor:
        srt = _key_column(present, capacity)
        vals = torch.where(
            srt != SENTINEL, self.values[torch.clamp(srt, max=self.n - 1).long()], SENTINEL
        )
        return torch.stack([srt, vals], dim=1)

    def device_buffers(self) -> tuple[torch.Tensor, ...]:
        """Tensors owned by this handle (reclamation accounting)."""
        return (self.values, self.delta)

    def delta_tuples(self, capacity: int) -> tuple[torch.Tensor, int]:
        return self._tuples(self.delta, capacity), self.delta_count

    def full_tuples(self, capacity: int) -> tuple[torch.Tensor, int]:
        return self._tuples(self.values != self.absent, capacity), self.count

    def to_numpy(self) -> np.ndarray:
        vals = self.values.cpu().numpy()
        keys = np.flatnonzero(vals != self.absent)
        return np.stack([keys, vals[keys]], axis=1).astype(np.int32)

    def to_blocks(self) -> tuple[dict, dict[str, np.ndarray]]:
        """(meta, arrays): the value table and the bit-packed live Δ."""
        meta = {"kind": "dense_agg", "n": self.n, "op": self.op}
        return meta, {"values": to_host(self.values), "delta": _bits_to_numpy(self.delta)}

    @classmethod
    def from_blocks(cls, name: str, meta: dict, arrays: dict, device) -> "DenseAggRelation":
        n = int(meta["n"])
        values = torch.tensor(np.asarray(arrays["values"], np.int32), device=device)
        delta = _bits_from_numpy(arrays["delta"], n, device)
        h = cls(name, n, str(meta["op"]), values, delta)
        h.count = int((values != h.absent).sum())
        h.delta_count = int(delta.sum())
        return h


#: ``meta["kind"]`` → handle class: the snapshot codec and ``interop`` share it.
_KINDS = {
    "tuple": TupleRelation,
    "dense_set": DenseSetRelation,
    "dense_agg": DenseAggRelation,
}


def relation_to_blocks(handle) -> tuple[dict, dict[str, np.ndarray]]:
    """Serialize any relation handle to (meta, host arrays): codec entry point."""
    fn = getattr(handle, "to_blocks", None)
    if fn is None:
        raise TypeError(f"{type(handle).__name__} is not serializable")
    return fn()


def relation_from_blocks(name: str, meta: dict, arrays: dict, device):
    """Rebuild a relation handle on ``device`` from codec (meta, arrays)."""
    kind = meta.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown relation kind {kind!r} for {name!r}")
    return _KINDS[kind].from_blocks(name, meta, arrays, device)
