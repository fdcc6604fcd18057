"""Durability on PyTorch: epoch snapshots, a delta WAL, crash-safe warm start.

The port of ``repro.persist``, with its on-disk formats unchanged, so a
durability root written by either package restores in the other:

* :mod:`repro_torch.persist.codec` — the **snapshot codec**: one pinned
  epoch as an atomic ``snapshot-<epoch>/`` directory of ``.npy`` blocks
  (tuple tables with their padding, bit-packed dense vectors, packed PBME
  matrices as ``uint32``), every blob SHA-256-checksummed, the manifest
  written last, a tmp directory renamed into place.  Reads copy the blocks
  onto the caller's device (CUDA unless ``device="cpu"``).
* :mod:`repro_torch.persist.wal` — the **delta WAL**: each committed
  transaction as one CRC-framed BEGIN/op*/COMMIT bracket, appended and
  fsynced before its epoch publishes; torn tails and half-written brackets
  end replay cleanly; abort markers cancel transactions acknowledged as
  failed.
* :mod:`repro_torch.persist.manager` — :class:`DurabilityManager`: the WAL
  plus snapshots under one root with a checkpoint policy, used by
  ``DatalogServer(durability=...)``'s checkpointer thread, which snapshots
  off a reader pin after waiting on the epoch's CUDA event.

Recovery is :meth:`repro_torch.serve_datalog.MaterializedInstance.restore`:
the newest valid snapshot onto the device, then the WAL tail replayed
through ``apply_txn``, bit for bit the pre-crash fixpoint.
"""

from repro_torch.persist.codec import (
    SnapshotError,
    latest_valid_snapshot,
    list_snapshots,
    prune_snapshots,
    read_snapshot,
    strat_hash,
    write_snapshot,
)
from repro_torch.persist.manager import DurabilityConfig, DurabilityManager
from repro_torch.persist.wal import DeltaWAL, TxnRecord, WalRecord

__all__ = [
    "SnapshotError",
    "write_snapshot",
    "read_snapshot",
    "list_snapshots",
    "latest_valid_snapshot",
    "prune_snapshots",
    "strat_hash",
    "DeltaWAL",
    "WalRecord",
    "TxnRecord",
    "DurabilityConfig",
    "DurabilityManager",
]
