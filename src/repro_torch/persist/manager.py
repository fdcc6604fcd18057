"""DurabilityManager: snapshot root + WAL + checkpoint policy, as one unit.

``DatalogServer(durability=...)`` owns one of these.  The write path calls
:meth:`DurabilityManager.log_group` *before* applying an update batch (the
WAL record is durable before the epoch publishes); the server's background
checkpointer thread calls :meth:`should_checkpoint` after each published
batch and :meth:`checkpoint` when the policy fires.

Checkpoints are taken **off a reader pin**: the manager pins the latest
published epoch of the instance's ``VersionedStore`` and serializes those
immutable handles while the writer keeps publishing new epochs and queries
keep reading — a checkpoint never blocks either.  The pinned snapshot's
``meta`` sidecar carries the PBME residency (packed bit matrices) published
*with* that epoch, so the on-disk snapshot is epoch-consistent by
construction, not by locking.

On CUDA the pinned epoch's tensors were written on the instance's own
writer stream, which is not ordered with the checkpointer thread's stream:
the checkpoint first makes its current stream wait on the epoch's ready
event (``Snapshot.wait_ready``), then copies every tensor to the host, and
holds the pin until the copies are complete.

After a snapshot finalizes, the WAL is truncated to the tail above the
snapshot epoch and snapshots beyond ``keep_snapshots`` are pruned — restart
cost stays proportional to the WAL tail.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.obs.trace import TRACER as _TRACE
from repro_torch.persist.codec import (
    SnapshotError,
    list_snapshots,
    prune_snapshots,
    read_manifest,
    snapshot_dir_epoch,
    strat_hash,
    write_snapshot,
)
from repro_torch.persist.wal import DeltaWAL

WAL_NAME = "wal.log"


@dataclass
class DurabilityConfig:
    """Knobs for one durable serving root (see ``docs/persistence.md``).

    ``checkpoint_every_epochs`` / ``checkpoint_wal_bytes`` are OR-ed: a
    checkpoint fires when either trips (0 disables that trigger; both 0
    means only explicit ``checkpoint_now`` calls snapshot).
    """

    root: str
    fsync: str = "batch"                  # WAL durability: batch|always|off
    checkpoint_every_epochs: int = 0      # snapshot every N published epochs
    checkpoint_wal_bytes: int = 4 << 20   # ... or when the WAL tail exceeds this
    keep_snapshots: int = 2               # finalized snapshots retained
    poll_seconds: float = 0.05            # checkpointer wake period


@dataclass
class DurabilityStats:
    checkpoints: int = 0
    checkpoint_failures: int = 0
    last_checkpoint_epoch: int = -1
    last_checkpoint_seconds: float = 0.0


class DurabilityManager:
    """WAL + snapshot lifecycle for one served instance."""

    checkpoint_histogram = None     # optional obs.metrics.Histogram sink

    def __init__(self, config: DurabilityConfig | str):
        if isinstance(config, str):
            config = DurabilityConfig(root=config)
        self.config = config
        os.makedirs(config.root, exist_ok=True)
        self.wal = DeltaWAL(os.path.join(config.root, WAL_NAME), config.fsync)
        self._ckpt_lock = threading.Lock()   # one checkpoint at a time
        self._stats = DurabilityStats()
        # finalized-dir names carry the epoch — no blob hashing or device
        # loads at construction time.  last_snapshot_epoch only drives the
        # checkpoint policy; the restore path does the full validation.
        existing = list_snapshots(config.root)
        self.last_snapshot_epoch = (
            snapshot_dir_epoch(existing[-1]) if existing else -1
        )

    # -- write path -----------------------------------------------------------

    def log_txn(self, ops, next_epoch: int) -> str:
        """Log one transaction ``[(rel, kind, rows)]`` as a framed group.

        Called by the writer *before* the transaction applies: the whole
        BEGIN/op*/COMMIT bracket lands in one atomic write with ONE fsync
        before any effect can publish, so a crash at any later point
        replays the transaction — atomically — from the log, a crash
        mid-commit drops it whole, and a concurrent checkpoint truncation
        can never split it.  Returns the transaction token, the handle
        :meth:`abort_txn` needs.
        """
        return self.wal.append_txn(ops, next_epoch)

    def abort_txn(self, token: str, epoch: int) -> None:
        """Mark a previously-logged transaction as acknowledged-failed.

        Appends one txn-granularity abort marker and fsyncs; replay drops
        the whole bracket so a transient failure cannot be redone on
        recovery.
        """
        self.wal.abort_txn(token, epoch)

    def log_group(self, requests, next_epoch: int) -> None:
        """Log one legacy admission group (rel, kind, payload rows) durably.

        The pre-transaction format: bare records, one fsync for the group.
        Kept for the deprecated ``submit_insert``/``submit_delete`` path —
        new code logs framed transactions via :meth:`log_txn`.
        """
        for rel, kind, rows in requests:
            self.wal.append(rel, kind, rows, next_epoch)
        self.wal.commit()

    def abort_group(self, requests, epoch: int) -> None:
        """Mark previously-logged legacy records as acknowledged-failed.

        Appends one abort marker per record (a full copy, flagged) and
        fsyncs; replay cancels the pairs so a transient failure cannot be
        redone on recovery.
        """
        for rel, kind, rows in requests:
            self.wal.append(rel, kind, rows, epoch, abort=True)
        self.wal.commit()

    # -- checkpoint policy ----------------------------------------------------

    def should_checkpoint(self, epoch: int) -> bool:
        cfg = self.config
        if (
            cfg.checkpoint_every_epochs
            and epoch - self.last_snapshot_epoch >= cfg.checkpoint_every_epochs
        ):
            return True
        return bool(
            cfg.checkpoint_wal_bytes
            and self.wal.size_bytes() >= cfg.checkpoint_wal_bytes
        )

    def checkpoint(self, instance) -> str | None:
        """Snapshot the latest published epoch off a reader pin; truncate WAL.

        Returns the finalized snapshot directory, or ``None`` when the
        latest epoch is already snapshotted.  Safe to call concurrently with
        the writer thread and with readers; concurrent checkpoint calls
        serialize on an internal lock.
        """
        with self._ckpt_lock, _TRACE.span("checkpoint", "persist") as sp:
            t0 = time.perf_counter()
            snap = instance.pin()
            try:
                if snap.epoch <= self.last_snapshot_epoch:
                    sp.set(epoch=snap.epoch, skipped=True)
                    return None
                sp.set(epoch=snap.epoch)
                if snap.ready is not None:
                    # the epoch was written on the instance's stream: order
                    # this thread's stream after it before any copy
                    with torch.cuda.device(instance.device):
                        snap.wait_ready()
                bm = {
                    idx: {"arc": st["arc"], "m": st["m"]}
                    for idx, st in (snap.meta or {}).items()
                }
                path = write_snapshot(
                    self.config.root,
                    handles=snap.handles,
                    domain=snap.domain,
                    epoch=snap.epoch,
                    fingerprint=instance.plan.fingerprint,
                    stratification_hash=strat_hash(instance.strat),
                    program_source=repr(instance.plan.program),
                    bitmatrix=bm,
                )
            except Exception:
                self._stats.checkpoint_failures += 1
                raise
            finally:
                snap.release()
            self.last_snapshot_epoch = snap.epoch
            prune_snapshots(self.config.root, self.config.keep_snapshots)
            # truncate only to the OLDEST retained snapshot: if the newest
            # one later fails validation (bit rot), recovery falls back to
            # an older snapshot — which is only useful while the WAL still
            # covers the gap between the two
            retained = list_snapshots(self.config.root)
            floor = snapshot_dir_epoch(retained[0]) if retained else snap.epoch
            self.wal.truncate(up_to_epoch=floor)
            dt = time.perf_counter() - t0
            self._stats.checkpoints += 1
            self._stats.last_checkpoint_epoch = snap.epoch
            self._stats.last_checkpoint_seconds = dt
            if self.checkpoint_histogram is not None:
                self.checkpoint_histogram.observe(dt)
            return path

    def ensure_baseline(self, instance) -> str | None:
        """Snapshot the current epoch if the root has no valid snapshot yet.

        Without a baseline the WAL alone cannot rebuild the instance (the
        initial fixpoint is not in the log) — a durable server writes one at
        attach time, which is what turns it into a system of record.

        Attaching to a root that already holds snapshots is only sound for
        an instance *continuing* that root's history (normally one built by
        ``MaterializedInstance.restore``, whose epoch is ≥ the newest
        snapshot's).  A fresh instance (epoch 0) attached to a used root
        would log updates at epochs the recovery replay filters out as
        already-covered — every acknowledged update silently unrecoverable —
        so that misuse raises instead.
        """
        if self.last_snapshot_epoch < 0:
            return self.checkpoint(instance)
        snaps = list_snapshots(self.config.root)
        if snaps:
            try:
                fp = read_manifest(snaps[-1]).get("fingerprint", "")
            except SnapshotError:
                fp = ""
            if fp and fp != instance.plan.fingerprint:
                raise SnapshotError(
                    f"durability root {self.config.root!r} holds snapshots of "
                    f"a different program (fingerprint {fp}); use a fresh "
                    "root or restore() the matching instance"
                )
        if instance.epoch < self.last_snapshot_epoch:
            raise SnapshotError(
                f"instance at epoch {instance.epoch} attached to durability "
                f"root {self.config.root!r} already checkpointed at epoch "
                f"{self.last_snapshot_epoch}; restore() from the root (or "
                "point the server at a fresh root) instead of re-attaching "
                "a fresh instance"
            )
        if not hasattr(instance, "restore_stats") and any(
            True for _ in self.wal.replay(after_epoch=self.last_snapshot_epoch)
        ):
            # epochs match the newest snapshot, but the WAL holds a tail the
            # instance never replayed (it was not built by restore()): its
            # acknowledged history is not this instance's history, and new
            # records would collide with the stale tail's epoch tags
            raise SnapshotError(
                f"durability root {self.config.root!r} has unreplayed WAL "
                "records; restore() from the root instead of attaching a "
                "fresh instance"
            )
        return None

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        s = self._stats
        return {
            "wal_records": self.wal.appended_records,
            "wal_bytes": self.wal.size_bytes(),
            "wal_syncs": self.wal.syncs,
            "wal_sync_seconds_total": self.wal.sync_seconds_total,
            "wal_last_sync_seconds": self.wal.last_sync_seconds,
            "checkpoints": s.checkpoints,
            "checkpoint_failures": s.checkpoint_failures,
            "last_checkpoint_epoch": self.last_snapshot_epoch,
            "last_checkpoint_seconds": s.last_checkpoint_seconds,
            "snapshots_on_disk": len(list_snapshots(self.config.root)),
        }

    def close(self) -> None:
        self.wal.close()
