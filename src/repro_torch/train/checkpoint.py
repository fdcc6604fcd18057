"""Checkpointing: atomic, asynchronous, restorable onto another device.

* **Atomic**: write to a temp file, ``os.replace`` into place — a preempted
  save never corrupts the latest checkpoint.
* **Async**: the device→host copy happens on the caller's thread, the disk
  write on a background thread — training never blocks on I/O.  The
  reference's arrays are immutable; the port's steps update tensors in
  place, so the host copies are taken in full (``.detach().cpu()``, then a
  numpy copy, never a view of a CPU tensor) before the writer starts, and
  the next step cannot change what is being written.
* **Placement**: ``restore_pytree(path, like, device=)`` reloads host arrays
  and places them on ``device`` (the reference's ``target_shardings``),
  else on each ``like`` leaf's own device.

Files are the reference's: an npz of arrays keyed by their ``"/"``-joined
tree paths (dict keys, list indices, NamedTuple field names) plus
``__step__``, so a checkpoint written by either package restores in the
other.  bfloat16 leaves are stored widened to float32, as there.
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_unflatten


def _key(path) -> str:
    return "/".join(
        str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path
    )


def _host_copy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:                 # numpy has no bf16: store widened
        t = t.to(torch.float32)
    host = t.cpu().numpy()
    return host.copy() if t.device.type == "cpu" else host     # never a view of a CPU leaf


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host_copy(leaf) for path, leaf in tree_flatten_with_path(tree)[0]}


def save_pytree(path: str, tree, step: int | None = None, blocking: bool = True):
    """Atomically save a tree (npz of path-keyed arrays); with
    ``blocking=False`` returns the writer thread."""
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.array(step, np.int64)

    def write():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def restore_pytree(path: str, like, device=None):
    """Restore into the structure of ``like``: arrays matched by their path
    key, cast to each ``like`` leaf's dtype, on ``device`` (else each leaf's
    own device).  Returns (tree, step or None)."""
    leaves_with_path, spec = tree_flatten_with_path(like)
    new_leaves = []
    with np.load(path) as data:
        for p, leaf in leaves_with_path:
            key = _key(p)
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = torch.tensor(data[key])
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(device=leaf.device if device is None else device, dtype=leaf.dtype)
            elif device is not None:
                arr = arr.to(device)
            new_leaves.append(arr)
        step = int(data["__step__"]) if "__step__" in data else None
    return tree_unflatten(new_leaves, spec), step


class CheckpointManager:
    """Rolling checkpoint directory with async saves and keep-k retention."""

    def __init__(self, directory: str, save_every: int = 100, keep: int = 3):
        self.dir = directory
        self.save_every = save_every
        self.keep = keep
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every != 0:
            return False
        self.save(step, tree)
        return True

    def save(self, step: int, tree):
        if self._pending is not None:
            self._pending.join()
        self._pending = save_pytree(self._path(step), tree, step, blocking=False)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self):
        steps = self._steps()
        for s in steps[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def latest(self) -> tuple[int, str] | None:
        steps = self._steps()
        if not steps:
            return None
        return steps[-1], self._path(steps[-1])

    def restore_latest(self, like, device=None):
        self.wait()
        latest = self.latest()
        if latest is None:
            return None
        _, path = latest
        return restore_pytree(path, like, device)
