"""Delta WAL: committed write transactions as CRC-framed append-only records.

FlowLog treats delta batches as the unit of incremental work; here the unit
of *logging* is the write transaction.  Every frame shares one layout::

    header  <IIqBBHI = magic, crc32, epoch, op, arity, rel_len, n_rows
    payload          = relation name (utf-8) + rows (int32, C-order)

Frame kinds (the ``op`` byte; bit 2 is the abort flag):

* ``OP_INSERT``/``OP_DELETE`` (0/1) — one update operation's rows.
* ``OP_BEGIN``/``OP_COMMIT`` (4/5) — transaction control frames.  The
  ``rel`` field carries an opaque transaction token instead of a relation
  name and the payload is empty; every op frame between a BEGIN and its
  matching COMMIT belongs to that transaction.  The writer appends a whole
  bracket in one atomic write (:meth:`DeltaWAL.append_txn`), so concurrent
  truncation can never split one.  A transaction whose COMMIT frame is
  missing (crash mid-commit) is dropped whole on replay — the atomicity
  contract extends through recovery — and trimmed from the file when the
  log is reopened, so post-restart appends never land inside a dead
  bracket.
* ``op | _ABORT`` — abort markers.  ``OP_COMMIT | _ABORT`` cancels the
  committed transaction with the same token (txn-granularity abort: a
  transaction acknowledged as *failed* must not be redone on recovery);
  ``OP_INSERT/OP_DELETE | _ABORT`` is the legacy record-granularity marker,
  a full copy of a bare record that cancels one multiset-matching record.

Bare op frames outside any BEGIN/COMMIT bracket are the legacy (pre-txn)
format and remain fully supported — mixed logs replay correctly.

``epoch`` is the epoch the transaction is *about* to publish (the writer
appends before the epoch swap, so a record is durable before its effects
are visible).  ``crc32`` covers the header tail plus the payload, so both a
torn write and bit rot end replay cleanly: :meth:`DeltaWAL.replay` yields
records up to the first frame that is short, mis-magicked, or
checksum-broken, and ignores everything after — the recovery contract is "a
consistent prefix of the log", exactly what redo needs.

Durability knobs (``fsync=``):

* ``"batch"`` (default) — appends buffer in the OS page cache;
  :meth:`commit` flushes + fsyncs once per commit group.  One fsync
  amortizes over the whole transaction (or coalesced group of
  transactions), the same way the serving layer amortizes fixpoint work.
* ``"always"`` — fsync every record (commit latency per request).
* ``"off"`` — never fsync (tests, read-only replay handles).

Truncation (:meth:`truncate`) runs at checkpoint time: frames at or below
the snapshot epoch are dropped by rewriting the surviving tail — whole
transactions with their framing intact — into a tmp file and atomically
renaming it into place, so restart cost stays proportional to the tail,
not the update history.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid
import zlib
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch.obs.trace import TRACER as _TRACE

_MAGIC = 0x57414C31                       # "WAL1"
_HEADER = struct.Struct("<IIqBBHI")       # magic crc epoch op arity rel_len nrows
_CRC_SKIP = 8                             # crc covers the header past magic+crc
OP_INSERT, OP_DELETE = 0, 1
_ABORT = 2                                # op | _ABORT = abort marker for op
OP_BEGIN, OP_COMMIT = 4, 5                # txn control frames (rel = token)
_OP_CODE = {"insert": OP_INSERT, "delete": OP_DELETE}
_OP_NAME = {v: k for k, v in _OP_CODE.items()}
_VALID_BASES = {OP_INSERT, OP_DELETE, OP_BEGIN, OP_COMMIT}


@dataclass
class WalRecord:
    """One logged update operation."""

    rel: str
    op: str                  # "insert" | "delete"
    rows: np.ndarray         # int32[k, arity]
    epoch: int               # epoch the transaction publishes


@dataclass
class TxnRecord:
    """One replayable transaction reconstructed from the log.

    ``token is None`` marks a legacy bare record (pre-framing format)
    wrapped as a single-op transaction; callers that re-coalesce legacy
    batches key on it.
    """

    token: str | None
    epoch: int
    ops: list[WalRecord] = field(default_factory=list)


def _raw_frames(data: bytes):
    """(epoch, op_code, rel, raw_rows_bytes, arity, nrows) for the longest
    valid frame prefix of a raw log image (control frames and abort markers
    included)."""
    pos = 0
    while pos + _HEADER.size <= len(data):
        magic, crc, epoch, op, arity, rel_len, nrows = _HEADER.unpack_from(
            data, pos
        )
        span = rel_len + nrows * arity * 4
        end = pos + _HEADER.size + span
        if (
            magic != _MAGIC
            or (op & ~_ABORT) not in _VALID_BASES
            or end > len(data)
            or (zlib.crc32(data[pos + _CRC_SKIP : end]) & 0xFFFFFFFF) != crc
        ):
            break                        # torn tail or bit rot: stop cleanly
        body = pos + _HEADER.size
        rel = data[body : body + rel_len].decode()
        yield epoch, op, rel, data[body + rel_len : end], arity, nrows
        pos = end


def _resolve_txns(
    data: bytes, after_epoch: int | None = None
) -> list[TxnRecord]:
    """The replayable transactions of a raw log image, in append order.

    Framed transactions (BEGIN … COMMIT with one token) become one
    :class:`TxnRecord` each; a BEGIN whose COMMIT never landed (crash
    mid-commit) is dropped whole, and a ``OP_COMMIT | _ABORT`` marker
    cancels the committed transaction carrying the same token.  Bare op
    frames outside any bracket are the legacy format: each becomes a
    single-op ``TxnRecord(token=None)``, after legacy record-granularity
    abort markers cancel multiset-matching records — insert/delete are
    idempotent set operations, so identical records are interchangeable
    and which duplicate gets skipped cannot change the replayed state.
    """
    frames = list(_raw_frames(data))
    aborted_tokens = {
        rel
        for _e, op, rel, _raw, _a, _n in frames
        if op == (OP_COMMIT | _ABORT)
    }
    record_aborts = Counter(
        (epoch, op & ~_ABORT, rel, raw)
        for epoch, op, rel, raw, _a, _n in frames
        if op & _ABORT and (op & ~_ABORT) in _OP_NAME
    )
    out: list[TxnRecord] = []
    cur: TxnRecord | None = None
    for epoch, op, rel, raw, arity, nrows in frames:
        base = op & ~_ABORT
        if base == OP_BEGIN:
            # an unterminated earlier bracket is torn: drop it
            cur = TxnRecord(token=rel, epoch=int(epoch))
            continue
        if base == OP_COMMIT:
            if not op & _ABORT and cur is not None and cur.token == rel:
                if rel not in aborted_tokens:
                    out.append(cur)
                cur = None
            continue
        if op & _ABORT:
            continue
        rows = np.frombuffer(raw, np.int32).reshape(nrows, arity)
        rec = WalRecord(rel, _OP_NAME[base], rows.copy(), int(epoch))
        if cur is not None:
            cur.ops.append(rec)
            continue
        key = (epoch, op, rel, raw)
        if record_aborts.get(key, 0) > 0:
            record_aborts[key] -= 1
            continue
        out.append(TxnRecord(token=None, epoch=int(epoch), ops=[rec]))
    if after_epoch is not None:
        out = [t for t in out if t.epoch > after_epoch]
    return out


class DeltaWAL:
    """Append-only, CRC-framed, torn-tail-tolerant update log."""

    # class-attribute defaults: ``truncate`` builds its tmp-file writer via
    # ``__new__`` (bypassing ``__init__``), so observability state must not
    # be required instance state (same pattern as ``_closed_size``)
    fsync_histogram = None          # optional obs.metrics.Histogram sink
    sync_seconds_total = 0.0
    last_sync_seconds = 0.0

    def __init__(self, path: str, fsync: str = "batch"):
        if fsync not in ("batch", "always", "off"):
            raise ValueError(f"fsync must be batch/always/off, got {fsync!r}")
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._truncate_lock = threading.Lock()   # one truncation at a time
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "ab")
        self.appended_records = 0
        self.synced_records = 0
        self.syncs = 0
        self._trim_torn_tail()

    def _trim_torn_tail(self) -> None:
        """Drop torn trailing bytes when (re)opening an existing log.

        Anything after the last frame boundary in a bracket-closed state
        can never replay: it is either a corrupt/short frame or a bracket
        whose COMMIT never landed (crash mid-commit).  Left in place, a
        torn BEGIN would swallow records appended after the restart — a
        post-crash bare record lands *inside* the dead bracket positionally
        and replay would drop it with the bracket.  Trimming at open keeps
        the on-disk log equal to its own replayable prefix.
        """
        with self._lock:
            self._f.flush()
            with open(self.path, "rb") as f:
                data = f.read()
            if not data:
                return
            clean = pos = 0
            in_bracket = False
            for _epoch, op, rel, raw, _a, _n in _raw_frames(data):
                pos += _HEADER.size + len(rel.encode()) + len(raw)
                base = op & ~_ABORT
                if base == OP_BEGIN:
                    in_bracket = True
                elif base == OP_COMMIT and not op & _ABORT:
                    in_bracket = False
                if not in_bracket:
                    clean = pos
            if clean < len(data):
                self._f.truncate(clean)
                self._f.seek(0, os.SEEK_END)

    # -- write side ----------------------------------------------------------

    def append(
        self, rel: str, op: str, rows: np.ndarray, epoch: int,
        abort: bool = False,
    ) -> int:
        """Append one record; returns the file offset it starts at.

        Durable only after :meth:`commit` (or immediately with
        ``fsync="always"``).  ``abort=True`` appends an *abort marker* — a
        copy of a previously-logged record whose request was acknowledged
        as failed; replay cancels the pair so a transient failure cannot
        succeed on recovery (see :func:`_resolve_txns`).
        """
        rows = np.ascontiguousarray(rows, np.int32)
        if rows.ndim == 1:
            rows = rows[:, None]
        arity = rows.shape[1] if rows.size else rows.shape[-1]
        if not 1 <= arity <= 255:
            raise ValueError(f"arity {arity} out of WAL range [1, 255]")
        code = _OP_CODE[op] | (_ABORT if abort else 0)
        return self._append_frame(code, rel, rows, epoch)

    @staticmethod
    def _frame_bytes(code: int, rel: str, rows: np.ndarray, epoch: int) -> bytes:
        arity = max(rows.shape[-1], 1)
        rel_b = rel.encode()
        payload = rel_b + rows.tobytes()
        header = _HEADER.pack(
            _MAGIC, 0, int(epoch), code, arity, len(rel_b), rows.shape[0]
        )
        crc = zlib.crc32(header[_CRC_SKIP:] + payload) & 0xFFFFFFFF
        header = _HEADER.pack(
            _MAGIC, crc, int(epoch), code, arity, len(rel_b), rows.shape[0]
        )
        return header + payload

    def _append_frame(
        self, code: int, rel: str, rows: np.ndarray, epoch: int
    ) -> int:
        blob = self._frame_bytes(code, rel, rows, epoch)
        with self._lock:
            offset = self._f.tell()
            self._f.write(blob)
            self.appended_records += 1
            if self.fsync == "always":
                self._sync_locked()
        return offset

    def append_txn(self, ops, epoch: int, token: str | None = None) -> str:
        """Append one whole BEGIN/op*/COMMIT bracket atomically; fsync once.

        ``ops`` is ``[(rel, op, rows)]``.  The entire bracket lands in ONE
        write under ONE lock acquisition, so a concurrent :meth:`truncate`
        can never observe — and therefore never split — a partial bracket
        (its off-lock scan sees the whole transaction or none of it, and
        the raw tail it copies after the swap contains only whole
        brackets).  This is the writer path; the frame-at-a-time
        ``begin_txn``/``commit_txn`` pair exists for tests that simulate
        crashes mid-bracket.
        """
        token = token or uuid.uuid4().hex[:12]
        chunks = [self._frame_bytes(OP_BEGIN, token, self._EMPTY, epoch)]
        for rel, op, rows in ops:
            rows = np.ascontiguousarray(rows, np.int32)
            if rows.ndim == 1:
                rows = rows[:, None]
            arity = rows.shape[1] if rows.size else rows.shape[-1]
            if not 1 <= arity <= 255:
                raise ValueError(f"arity {arity} out of WAL range [1, 255]")
            chunks.append(self._frame_bytes(_OP_CODE[op], rel, rows, epoch))
        chunks.append(self._frame_bytes(OP_COMMIT, token, self._EMPTY, epoch))
        with self._lock:
            self._f.write(b"".join(chunks))
            self.appended_records += len(chunks)
            if self.fsync != "off":
                self._sync_locked()
            else:
                self._f.flush()
        return token

    # -- transaction framing ---------------------------------------------------

    _EMPTY = np.zeros((0, 1), np.int32)       # control frames carry no rows

    def begin_txn(self, epoch: int, token: str | None = None) -> str:
        """Open one transaction bracket; returns its opaque token.

        Append the transaction's op records with :meth:`append`, then seal
        with :meth:`commit_txn` — the COMMIT frame plus one fsync is what
        makes the whole transaction durable; a bracket with no COMMIT is
        dropped whole on replay.  Tokens are random (process-lifetime
        collisions impossible), so abort markers written after a restart
        can never cancel another incarnation's transaction.
        """
        token = token or uuid.uuid4().hex[:12]
        self._append_frame(OP_BEGIN, token, self._EMPTY, epoch)
        return token

    def commit_txn(self, token: str, epoch: int) -> None:
        """Seal one transaction bracket and make it durable (one fsync)."""
        self._append_frame(OP_COMMIT, token, self._EMPTY, epoch)
        self.commit()

    def abort_txn(self, token: str, epoch: int) -> None:
        """Cancel a committed transaction that was acknowledged as failed.

        Replay (and truncation) drop the token's whole bracket, so a
        transiently-failed transaction cannot be redone on recovery.
        """
        self._append_frame(OP_COMMIT | _ABORT, token, self._EMPTY, epoch)
        self.commit()

    def commit(self) -> None:
        """Flush + fsync everything appended so far (one call per batch)."""
        with self._lock:
            if self.fsync != "off":
                self._sync_locked()
            else:
                self._f.flush()

    def _sync_locked(self) -> None:
        t0 = time.perf_counter()
        with _TRACE.span("wal.fsync", "persist") as sp:
            self._f.flush()
            os.fsync(self._f.fileno())
            sp.set(records=self.appended_records - self.synced_records)
        dt = time.perf_counter() - t0
        self.syncs += 1
        self.synced_records = self.appended_records
        self.sync_seconds_total += dt
        self.last_sync_seconds = dt
        if self.fsync_histogram is not None:
            self.fsync_histogram.observe(dt)

    # -- read side -----------------------------------------------------------

    def replay(self, after_epoch: int | None = None) -> Iterator[WalRecord]:
        """Records in append order, stopping at the first torn/corrupt frame.

        The flat record-level view (committed transactions' ops in order;
        uncommitted/aborted transactions omitted).  With ``after_epoch``,
        frames at or below that epoch are skipped (they are already
        reflected in the snapshot being recovered from).
        """
        for txn in self.replay_txns(after_epoch):
            yield from txn.ops

    def replay_txns(self, after_epoch: int | None = None) -> list[TxnRecord]:
        """Replayable transactions in append order (see :func:`_resolve_txns`).

        Framed groups come back whole — recovery re-applies each as one
        atomic batch; legacy bare records come back as single-op
        ``TxnRecord(token=None)`` entries for the caller to re-coalesce.
        """
        with self._lock:
            self._f.flush()
            with open(self.path, "rb") as f:
                data = f.read()
        return _resolve_txns(data, after_epoch)

    # -- maintenance ---------------------------------------------------------

    def truncate(self, up_to_epoch: int) -> int:
        """Drop frames at or below ``up_to_epoch``; returns surviving
        transactions kept (legacy bare records count as one each).

        Atomic: survivors are rewritten to a tmp file which replaces the log
        in one rename — a crash mid-truncate leaves the old (superset) log,
        which replays to the same state (replay filters by epoch anyway).

        Concurrency: the expensive part (scanning + rewriting the surviving
        tail) runs *outside* the append lock, so a checkpoint does not stall
        the writer thread's batch commits; the lock is retaken only to copy
        whatever raw frames were appended since the scan (a small tail) and
        swap the file.  Records fsynced mid-truncate therefore always
        survive.  Concurrent truncations serialize on their own lock.
        """
        tmp = self.path + ".tmp"
        with self._truncate_lock:
            with self._lock:
                self._f.flush()
                with open(self.path, "rb") as f:
                    data = f.read()
            # scan + rewrite off-lock: appends proceed meanwhile
            survivors = _resolve_txns(data, after_epoch=up_to_epoch)
            out = open(tmp, "wb")
            writer = DeltaWAL.__new__(DeltaWAL)
            writer.path, writer.fsync = tmp, "off"
            writer._lock = threading.Lock()
            writer._f = out
            writer.appended_records = writer.synced_records = writer.syncs = 0
            for txn in survivors:
                # framed transactions keep their bracket (and token) so the
                # rewritten log replays at the same commit granularity
                if txn.token is not None:
                    writer.begin_txn(txn.epoch, token=txn.token)
                for rec in txn.ops:
                    writer.append(rec.rel, rec.op, rec.rows, rec.epoch)
                if txn.token is not None:
                    writer._append_frame(
                        OP_COMMIT, txn.token, writer._EMPTY, txn.epoch
                    )
            with self._lock:
                self._f.flush()
                with open(self.path, "rb") as f:
                    f.seek(len(data))
                    appended = f.read()   # frames landed during the rewrite
                # appended frames keep their raw bytes (their epochs exceed
                # any checkpoint floor; even for an arbitrary user floor a
                # kept-superset log replays identically — replay filters)
                out.write(appended)
                out.flush()
                os.fsync(out.fileno())
                out.close()
                self._f.close()
                os.replace(tmp, self.path)
                self._f = open(self.path, "ab")
        return len(survivors)

    def size_bytes(self) -> int:
        with self._lock:
            if self._f.closed:
                return self._closed_size
            self._f.flush()
            return self._f.tell()

    _closed_size = 0

    def close(self) -> None:
        """Fsync and close; idempotent, and stats keep working after."""
        with self._lock:
            if not self._f.closed:
                if self.fsync != "off":
                    self._sync_locked()
                else:
                    self._f.flush()
                self._closed_size = self._f.tell()
                self._f.close()

    def __enter__(self) -> "DeltaWAL":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
