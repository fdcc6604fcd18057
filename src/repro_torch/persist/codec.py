"""Snapshot codec: one pinned epoch ⇄ an atomic on-disk directory.

Layout of one snapshot (all under ``<root>/snapshot-<epoch, 12 digits>/``)::

    MANIFEST.json            # written LAST — its presence marks completeness
    rel.<name>.<field>.npy   # relation column blocks (TupleRelation rows,
                             #   packed dense-set/agg vectors)
    bm.<stratum>.<field>.npy # PBME residency: packed uint32 arc / closure
    extra.<key>.npy          # caller sidecar (engine mid-fixpoint deltas)

The manifest records, per array, the file name and its SHA-256, plus the
program fingerprint, stratification hash, active-domain size, epoch, and the
program source (``repr(Program)`` parses back — so ``MaterializedInstance.
restore`` needs no out-of-band copy of the program).

Atomicity: everything is written into ``snapshot-<epoch>.tmp-<pid>``, each
blob fsynced, the manifest written and fsynced last, then the directory is
renamed into place and the parent directory fsynced.  A crash mid-snapshot
leaves a ``*.tmp-*`` directory that readers never consider; a finalized
directory with a corrupt or missing blob fails checksum validation and
:func:`latest_valid_snapshot` falls back to the previous snapshot.  Recovery
therefore always lands on a consistent epoch, never a partial one.

The on-disk format is the reference package's (``repro.persist.codec``),
byte for byte: a snapshot written by either package reads in the other.
Packed PBME matrices are the port's ``int32`` words written as ``uint32``
(a ``view``, never a conversion: bit 31 is a real column) and read back
with ``.view(np.int32)``.

Arrays are plain ``.npy`` files loaded with ``mmap_mode="r"`` and copied
once onto the reading device with ``torch.tensor``: no tensor shares the
mapped pages, so a snapshot directory can be pruned while its relations
live on.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.relation import relation_from_blocks, relation_to_blocks, to_host

FORMAT_VERSION = 1
MANIFEST = "MANIFEST.json"
SNAP_PREFIX = "snapshot-"
#: Bytes per ``write`` call when a block is saved.  ``np.save`` writes a
#: table in one call, and on a 9p file system a server's concurrent reads
#: waited out a 1 GB call whole; in 16 MiB pieces they do not
#: (``tools/checkpoint_stalls.py``, step ``save_npy``).
WRITE_CHUNK_BYTES = 16 << 20


class SnapshotError(RuntimeError):
    """A snapshot is missing, torn, corrupt, or belongs to another program."""


def strat_hash(strat) -> str:
    """Stable hash of a stratification's structure (order, preds, recursion).

    Stored in the manifest and checked by the restore path: a snapshot taken
    under a different stratification of the "same" program must not be
    replayed into — stratum indices key the PBME residency sidecar.
    """
    shape = [
        (s.index, tuple(sorted(s.preds)), bool(s.recursive))
        for s in strat.strata
    ]
    return hashlib.sha1(repr(shape).encode()).hexdigest()[:16]


@dataclass
class RestoredSnapshot:
    """Everything :func:`read_snapshot` recovers from one snapshot dir,
    its tensors on ``device``."""

    path: str
    epoch: int
    domain: int
    fingerprint: str
    strat_hash: str
    program_source: str
    device: torch.device = torch.device("cpu")
    handles: dict = field(default_factory=dict)      # name → relation handle
    bitmatrix: dict = field(default_factory=dict)    # stratum → {field: int32 words}
    extra_meta: dict = field(default_factory=dict)
    extra_arrays: dict = field(default_factory=dict)  # key → tensor


def resolve_device(device) -> torch.device:
    """``device``, or CUDA when it is ``None``; CUDA must be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.persist reads snapshots onto CUDA by default and no CUDA "
            'device is available; pass device="cpu" to read them onto the CPU'
        )
    return dev


def _host(arr) -> np.ndarray:
    """A tensor's host copy (packed ``int32`` words stay ``int32`` here), or
    the array as numpy."""
    if isinstance(arr, torch.Tensor):
        return to_host(arr.detach())
    return np.asarray(arr)


def packed_to_disk(words) -> np.ndarray:
    """Packed ``int32`` words (a tensor or an array) → ``uint32``, same bits."""
    return np.ascontiguousarray(_host(words)).view(np.uint32)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_npy(path: str, arr: np.ndarray) -> None:
    """Write ``np.save(path, arr)``'s bytes: numpy's own header, then the
    C-ordered data in pieces of :data:`WRITE_CHUNK_BYTES`."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(arr)
        )
        if arr.size:
            data = memoryview(arr.reshape(-1).view(np.uint8))
            for a in range(0, len(data), WRITE_CHUNK_BYTES):
                f.write(data[a : a + WRITE_CHUNK_BYTES])


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def snapshot_dirname(epoch: int) -> str:
    return f"{SNAP_PREFIX}{epoch:012d}"


def snapshot_dir_epoch(path: str) -> int:
    """Epoch encoded in a snapshot directory name (no manifest read)."""
    return int(os.path.basename(path.rstrip("/"))[len(SNAP_PREFIX):])


def write_snapshot(
    root: str,
    *,
    handles: dict,
    domain: int,
    epoch: int,
    fingerprint: str = "",
    stratification_hash: str = "",
    program_source: str = "",
    bitmatrix: dict | None = None,
    extra_meta: dict | None = None,
    extra_arrays: dict | None = None,
) -> str:
    """Serialize one epoch atomically; returns the finalized directory.

    ``handles`` is an epoch's (pinned) relation-handle map, whose tensors
    must be ready to read on the caller's current stream; ``bitmatrix``
    maps stratum index → ``{"arc": words[n, w], "m": words[n, w]}`` packed
    matrices (the epoch's PBME residency sidecar; ``int32`` tensors or
    arrays, written as ``uint32``); ``extra_*`` is an opaque caller channel
    (the engine stores mid-fixpoint resume state there; tensors are copied
    to the host).  Writing an epoch that already has a finalized snapshot
    is a no-op.
    """
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, snapshot_dirname(epoch))
    if os.path.exists(os.path.join(final, MANIFEST)):
        return final
    tmp = os.path.join(root, f"{snapshot_dirname(epoch)}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    files: dict[str, dict] = {}

    def put(fname: str, arr: np.ndarray) -> dict:
        path = os.path.join(tmp, fname)
        save_npy(path, arr)
        _fsync_file(path)
        files[fname] = {"sha256": _sha256(path)}
        return {"file": fname}

    relations: dict[str, dict] = {}
    for name, handle in handles.items():
        meta, arrays = relation_to_blocks(handle)
        entry = {"meta": meta, "arrays": {}}
        for f, arr in arrays.items():
            entry["arrays"][f] = put(f"rel.{name}.{f}.npy", arr)
        relations[name] = entry

    bm_entries: dict[str, dict] = {}
    for idx, mats in (bitmatrix or {}).items():
        bm_entries[str(idx)] = {
            f: put(f"bm.{idx}.{f}.npy", packed_to_disk(arr))
            for f, arr in mats.items()
        }

    extra_entries = {
        key: put(f"extra.{key}.npy", _host(arr))
        for key, arr in (extra_arrays or {}).items()
    }

    manifest = {
        "format_version": FORMAT_VERSION,
        "epoch": int(epoch),
        "domain": int(domain),
        "fingerprint": fingerprint,
        "strat_hash": stratification_hash,
        "program_source": program_source,
        "relations": relations,
        "bitmatrix": bm_entries,
        "extra_meta": dict(extra_meta or {}),
        "extra_arrays": extra_entries,
        "files": files,
    }
    mpath = os.path.join(tmp, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    _fsync_file(mpath)

    if os.path.exists(final):        # lost a race to another checkpointer
        shutil.rmtree(tmp, ignore_errors=True)
        return final
    os.rename(tmp, final)
    _fsync_dir(root)
    return final


def read_snapshot(path: str, verify: bool = True, device=None) -> RestoredSnapshot:
    """Load one finalized snapshot directory onto ``device`` (CUDA unless
    given another), validating checksums.

    Raises :class:`SnapshotError` on a missing manifest, a missing blob, or
    a checksum mismatch — callers (``latest_valid_snapshot``) treat that as
    "this snapshot does not exist" and fall back.  Every blob is hashed and
    parsed before any is copied to the device.
    """
    device = resolve_device(device)
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable manifest in {path}: {e}") from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise SnapshotError(
            f"{path}: format_version {manifest.get('format_version')} "
            f"(this codec reads {FORMAT_VERSION})"
        )

    def load(fname: str) -> np.ndarray:
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            raise SnapshotError(f"{path}: missing blob {fname}")
        if verify:
            want = manifest["files"].get(fname, {}).get("sha256")
            if want is not None and _sha256(fpath) != want:
                raise SnapshotError(f"{path}: checksum mismatch in {fname}")
        try:
            return np.load(fpath, mmap_mode="r")
        except ValueError as e:
            raise SnapshotError(f"{path}: corrupt blob {fname}: {e}") from e

    try:
        relations = {
            name: (entry["meta"],
                   {f: load(ref["file"]) for f, ref in entry["arrays"].items()})
            for name, entry in manifest["relations"].items()
        }
        bitmatrix = {
            int(idx): {f: load(ref["file"]) for f, ref in mats.items()}
            for idx, mats in manifest.get("bitmatrix", {}).items()
        }
        extra = {
            key: load(ref["file"])
            for key, ref in manifest.get("extra_arrays", {}).items()
        }
    except KeyError as e:
        raise SnapshotError(f"{path}: manifest lacks {e}") from e

    snap = RestoredSnapshot(
        path=path,
        epoch=int(manifest["epoch"]),
        domain=int(manifest["domain"]),
        fingerprint=manifest.get("fingerprint", ""),
        strat_hash=manifest.get("strat_hash", ""),
        program_source=manifest.get("program_source", ""),
        device=device,
        extra_meta=manifest.get("extra_meta", {}),
    )
    # one copy from the mapped pages onto the device (torch.tensor copies;
    # no tensor keeps the mapping, so pruning the directory is safe)
    for name, (meta, arrays) in relations.items():
        snap.handles[name] = relation_from_blocks(name, meta, arrays, device)
    for idx, mats in bitmatrix.items():
        snap.bitmatrix[idx] = {
            f: torch.tensor(np.ascontiguousarray(arr).view(np.int32), device=device)
            for f, arr in mats.items()
        }
    for key, arr in extra.items():
        snap.extra_arrays[key] = torch.tensor(np.ascontiguousarray(arr), device=device)
    return snap


def read_manifest(path: str) -> dict:
    """Just the manifest of one finalized snapshot — no blob loads/hashes.

    For cheap metadata probes (epoch, fingerprint) where full validation is
    unnecessary; raises :class:`SnapshotError` like :func:`read_snapshot`.
    """
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable manifest in {path}: {e}") from e


def list_snapshots(root: str) -> list[str]:
    """Finalized snapshot directories under ``root``, oldest → newest."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(SNAP_PREFIX) or ".tmp-" in name:
            continue
        if os.path.exists(os.path.join(root, name, MANIFEST)):
            out.append(os.path.join(root, name))
    return sorted(out)


def latest_valid_snapshot(root: str, device=None) -> RestoredSnapshot | None:
    """Newest snapshot that passes full validation (checksums included),
    read onto ``device`` (CUDA unless given another).

    Torn tmp directories are never considered; a finalized-but-corrupt
    snapshot is skipped and the previous one is tried — recovery lands on a
    consistent epoch or (no valid snapshot at all) on ``None``.
    """
    device = resolve_device(device)
    for path in reversed(list_snapshots(root)):
        try:
            return read_snapshot(path, device=device)
        except SnapshotError:
            continue
    return None


def prune_snapshots(root: str, keep: int) -> int:
    """Delete the oldest finalized snapshots beyond ``keep``; returns count.

    Torn tmp directories are always removed.
    """
    removed = 0
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith(SNAP_PREFIX) and ".tmp-" in name:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    snaps = list_snapshots(root)
    for path in snaps[: max(len(snaps) - max(keep, 1), 0)]:
        shutil.rmtree(path, ignore_errors=True)
        removed += 1
    return removed
