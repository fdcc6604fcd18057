"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/repro_torch/<name>-<hash>.so`` under
the repository root, where ``<hash>`` covers the source and the flags: a
changed source rebuilds, an unchanged one loads the cached library.  All
missing libraries compile at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`build_all` spent compiling, and nvcc's messages
#: (``-Xptxas -v`` register and shared-memory use) per source
stats: dict[str, object] = {"seconds": 0.0, "log": {}}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
        "are compiled at first use"
    )


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD / f"{src.stem}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; return name → path."""
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: st for name, st in targets.items() if not st[1].exists()}
    if todo:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            stats["log"][name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        stats["seconds"] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: out for name, (_src, out) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all()[name]))
    return _libs[name]


def raise_on(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
