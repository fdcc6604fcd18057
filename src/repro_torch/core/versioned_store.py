"""VersionedStore: MVCC-lite epochs over immutable relation handles.

The relation handles in this codebase (:class:`~repro_torch.core.relation.
TupleRelation` and the dense specializations) are immutable: every update
produces a *new* handle and leaves the old one untouched.  That makes
snapshot isolation almost free — a consistent view of the database is just
a handle map captured at one instant.  What this module adds on top is the
bookkeeping that turns "copy the dict" into a real concurrency story:

* **Epochs** — an append-only chain of published handle maps.  Epoch ``e``
  is the complete database state (every EDB and IDB handle plus the active
  domain) after the ``e``-th successful update.  A writer builds epoch
  ``e+1`` in a *private* map and :meth:`VersionedStore.publish`-es it with
  one pointer swap; readers pinned to ``e`` are never affected, and a failed
  update simply never publishes (rollback is "the epoch never existed").
* **Pins** — :meth:`VersionedStore.pin` returns a :class:`Snapshot` of the
  latest published epoch and increments that epoch's reader count.  A
  pinned snapshot stays readable — same handles, same domain — no matter
  how many updates publish after it.  Snapshots are context managers;
  :meth:`Snapshot.release` drops the pin.
* **Epoch-based reclamation** — a superseded epoch (anything but the
  latest) is retained only while readers pin it.  When its last pin drops,
  the epoch is removed from the chain and every handle unique to it (by
  object identity against all retained epochs) loses its last store
  reference, returning its device buffers to the allocator.  ``stats()``
  reports reclaimed epoch/handle/buffer counts so serving dashboards can
  verify memory stays bounded under sustained update traffic.

Reclamation deliberately drops references instead of freeing tensors by
hand: handles may be aliased by in-flight views outside the store (a
writer's base snapshot, debug captures), and Python refcounting returns an
unreferenced tensor to the caching allocator just as promptly without the
use-after-free hazard.

**Device ordering.**  On a CUDA device the writer builds an epoch on its own
stream, so a published handle may still be in the making on the card when
a reader pins it.  ``publish`` therefore takes a ``ready`` event recorded on
the writer's stream after the epoch's last kernel; a pinned
:class:`Snapshot` carries it, and :meth:`Snapshot.wait_ready` makes the
reader's current stream wait for it on the card (the host never blocks).
Without an event (the CPU) there is nothing to wait for.

Thread model: any number of reader threads (``pin``/``release``), one
writer at a time (``publish``); all bookkeeping is behind one lock.  The
serving layer (``repro_torch.serve_datalog``) enforces the single writer.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from types import MappingProxyType
from typing import Any, Iterable, Mapping

from repro_torch.obs.trace import TRACER as _TRACE


def handle_buffers(handle: Any) -> tuple:
    """The device arrays owned by one relation handle.

    Relation classes report their own buffers via ``device_buffers()`` (see
    ``relation.py``); anything else counts as a single opaque buffer.  Used
    only for reclamation accounting — the buffers themselves are freed by
    the allocator once the handle loses its last reference.
    """
    fn = getattr(handle, "device_buffers", None)
    return fn() if fn is not None else (handle,)


class Snapshot:
    """A pinned, immutable view of one published epoch.

    ``handles`` is a read-only mapping of relation name → handle and
    ``domain`` the active-domain size those handles were materialized
    against.  The view is consistent: every handle belongs to the same
    fixpoint, regardless of updates published after the pin.  Use as a
    context manager, or call :meth:`release` explicitly; releasing twice is
    a no-op.  Snapshots constructed without a store (``VersionedStore.
    latest``) are unpinned peeks and ``release`` does nothing.
    """

    __slots__ = ("epoch", "handles", "domain", "meta", "ready", "_store")

    def __init__(
        self,
        epoch: int,
        handles: Mapping[str, Any],
        domain: int,
        store: "VersionedStore | None" = None,
        meta: Any = None,
        ready: Any = None,
    ):
        self.epoch = epoch
        self.handles = handles
        self.domain = domain
        self.meta = meta
        self.ready = ready
        self._store = store

    def wait_ready(self) -> None:
        """Order the caller's current CUDA stream after the epoch's writer
        (a no-op for an epoch built without an event, as on the CPU)."""
        if self.ready is not None:
            self.ready.wait()

    def release(self) -> None:
        store, self._store = self._store, None
        if store is not None:
            store._release(self.epoch)

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "pinned" if self._store is not None else "released"
        return f"Snapshot(epoch={self.epoch}, |handles|={len(self.handles)}, {state})"


@dataclass
class _Epoch:
    handles: dict[str, Any]
    domain: int
    pins: int = 0
    meta: Any = None         # opaque epoch-consistent sidecar (PBME residency)
    ready: Any = None        # CUDA event recorded after the epoch's last kernel


@dataclass
class StoreStats:
    """Reclamation / pin counters (cumulative since construction)."""

    pins_total: int = 0
    reclaimed_epochs: int = 0
    reclaimed_handles: int = 0
    reclaimed_buffers: int = 0


class VersionedStore:
    """Append-only epoch → handle-map chain with pin-gated reclamation."""

    _WRITES_HISTORY = 1024        # published write sets retained for conflicts

    def __init__(
        self,
        handles: Mapping[str, Any],
        domain: int,
        epoch: int = 0,
        meta: Any = None,
        ready: Any = None,
    ):
        """``epoch`` seeds the chain index: a store restored from a durable
        snapshot continues the pre-crash epoch numbering instead of
        restarting at 0 (durability, ROADMAP.md item A8).  ``meta`` is an opaque sidecar
        published with each epoch — reading it through a pinned
        :class:`Snapshot` is guaranteed consistent with that epoch's handles
        (the checkpointer snapshots PBME residency this way)."""
        self._lock = threading.Lock()
        self._epochs: dict[int, _Epoch] = {
            epoch: _Epoch(dict(handles), domain, meta=meta, ready=ready)
        }
        self._latest = epoch
        self._stats = StoreStats()
        # (epoch, write set) of recent publishes — survives reclamation, so
        # conflict checks work against epochs whose handle maps are gone
        self._writes_log: deque[tuple[int, frozenset | None]] = deque(
            maxlen=self._WRITES_HISTORY
        )

    # -- read side -----------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Index of the latest published epoch."""
        return self._latest

    @property
    def handles(self) -> Mapping[str, Any]:
        """The latest epoch's handle map (read-only).

        Wrapped in a :class:`MappingProxyType` like every snapshot view —
        mutating a published epoch in place would corrupt pinned readers and
        the identity-based reclamation accounting.  Writers copy
        (``dict(handles)``) and publish instead.
        """
        with self._lock:
            return MappingProxyType(self._epochs[self._latest].handles)

    @property
    def domain(self) -> int:
        with self._lock:
            return self._epochs[self._latest].domain

    def latest(self) -> Snapshot:
        """Unpinned peek at the latest epoch (no reclamation guarantee)."""
        with self._lock:
            e = self._epochs[self._latest]
            return Snapshot(
                self._latest, MappingProxyType(e.handles), e.domain, meta=e.meta,
                ready=e.ready,
            )

    def pin(self) -> Snapshot:
        """Pin the latest published epoch for reading.

        The returned snapshot stays consistent across concurrent publishes;
        its epoch is not reclaimed until :meth:`Snapshot.release`.
        """
        with self._lock:
            e = self._epochs[self._latest]
            e.pins += 1
            self._stats.pins_total += 1
            return Snapshot(
                self._latest, MappingProxyType(e.handles), e.domain, self,
                meta=e.meta, ready=e.ready,
            )

    def _release(self, epoch: int) -> None:
        with self._lock:
            e = self._epochs.get(epoch)
            if e is None:  # epoch map already gone (shutdown paths)
                return
            e.pins -= 1
            self._reclaim_locked()

    # -- write side ----------------------------------------------------------

    def publish(
        self,
        handles: Mapping[str, Any],
        domain: int,
        meta: Any = None,
        writes: "frozenset[str] | None" = None,
        ready: Any = None,
    ) -> int:
        """Atomically install a new latest epoch; returns its index.

        The caller hands over a complete handle map built privately (never a
        map readers could observe mid-mutation), plus an optional ``meta``
        sidecar that pinned readers of this epoch observe atomically with
        the handles.  ``writes`` names the relations this epoch changed —
        recorded in a bounded history that :meth:`conflicts_since` consults
        (``None`` = unknown, treated as conflicting with everything).
        Superseded unpinned epochs are reclaimed immediately.  ``ready`` is
        the writer's CUDA event (see the module docstring).
        """
        with _TRACE.span("epoch.publish", "store") as sp:
            with self._lock:
                self._latest += 1
                self._epochs[self._latest] = _Epoch(
                    dict(handles), domain, meta=meta, ready=ready
                )
                self._writes_log.append((self._latest, writes))
                self._reclaim_locked()
                sp.set(
                    epoch=self._latest, domain=domain,
                    relations=len(handles),
                    writes=sorted(writes) if writes else None,
                )
                return self._latest

    def conflicts_since(
        self, base_epoch: int, names: Iterable[str]
    ) -> list[int] | None:
        """Epochs published after ``base_epoch`` that touched ``names``.

        The conflict-detection substrate for multi-writer epoch merging: a
        transaction that pinned ``base_epoch`` and read/wrote ``names`` can
        fast-forward onto the latest epoch iff this returns ``[]`` — no
        intervening publish wrote a relation it depends on.  Epochs whose
        write set was not declared (``writes=None``) count as conflicts.
        Returns ``None`` when ``base_epoch`` predates the bounded write
        history — the caller must assume a conflict (conservative).
        """
        names = set(names)
        with self._lock:
            if base_epoch >= self._latest:
                return []
            # publishes are sequential, so the log covers the consecutive
            # epochs (latest - len(log), latest]; anything older aged out
            if base_epoch + 1 < self._latest - len(self._writes_log) + 1:
                return None
            return [
                e
                for e, w in self._writes_log
                if e > base_epoch and (w is None or w & names)
            ]

    def _reclaim_locked(self) -> None:
        """Drop every superseded epoch no reader pins.

        Each epoch's map is self-contained, so any unpinned non-latest epoch
        can go independently of its neighbors.  Handles shared with a
        retained epoch (by identity) survive; handles unique to the dead
        epochs lose their store reference here, which frees their device
        buffers once no outside view holds them.
        """
        dead = [
            k for k, e in self._epochs.items() if k != self._latest and e.pins == 0
        ]
        if not dead:
            return
        kept_ids = {
            id(h)
            for k, e in self._epochs.items()
            if k not in dead
            for h in e.handles.values()
        }
        for k in dead:
            e = self._epochs.pop(k)
            self._stats.reclaimed_epochs += 1
            for h in e.handles.values():
                if id(h) not in kept_ids:
                    self._stats.reclaimed_handles += 1
                    self._stats.reclaimed_buffers += len(handle_buffers(h))

    # -- observability -------------------------------------------------------

    def active_pins(self) -> int:
        with self._lock:
            return sum(e.pins for e in self._epochs.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "epoch": self._latest,
                "live_epochs": len(self._epochs),
                "active_pins": sum(e.pins for e in self._epochs.values()),
                "pins_total": self._stats.pins_total,
                "reclaimed_epochs": self._stats.reclaimed_epochs,
                "reclaimed_handles": self._stats.reclaimed_handles,
                "reclaimed_buffers": self._stats.reclaimed_buffers,
            }
