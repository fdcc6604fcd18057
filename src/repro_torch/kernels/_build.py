"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/repro_torch/<name>-<hash>.so`` under
the repository root, where ``<hash>`` covers the source and the flags: a
changed source rebuilds, an unchanged one loads the cached library.  All
missing libraries compile at once, one ``nvcc`` process per source.  A
variant built with ``-D`` defines gets its own hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
# one build at a time: the serving layer's writer thread and a reader may
# both reach a kernel's first use
_lock = threading.Lock()
#: seconds the last :func:`build` spent compiling, and nvcc's messages
#: (``-Xptxas -v`` register and shared-memory use) per job
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


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return FLAGS + tuple(f"-D{d}" for d in defines)


def _target(src: Path, defines: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD / f"{src.stem}-{digest[:16]}.so"


def build(jobs: dict[str, tuple[Path, tuple[str, ...]]]) -> dict[str, Path]:
    """Compile every job (key → source and ``-D`` defines) whose library is
    missing, one ``nvcc`` each, all at once; return key → path."""
    targets = {key: (src, defines, _target(src, defines)) for key, (src, defines) in jobs.items()}
    todo = {key: t for key, t in targets.items() if not t[2].exists()}
    if todo:
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for key, (src, defines, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(src)]
            procs[key] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True),
                tmp,
                out,
            )
        failed = []
        for key, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            stats["log"][key] = log
            if proc.returncode != 0:
                failed.append(f"{key}:\n{log}")
            else:
                os.replace(tmp, out)
        stats["seconds"] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {key: out for key, (_src, _defines, out) in targets.items()}


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; return name → path."""
    return build({src.stem: (src, ()) for src in sorted(CSRC.glob("*.cu"))})


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, with ``defines``
    (``"NAME=value"``) passed to ``nvcc`` as ``-D`` flags.  Thread-safe: the
    first caller builds and loads, the others wait for it."""
    with _lock:
        if (name, defines) not in _libs:
            path = (build_all()[name] if not defines
                    else build({name: (CSRC / f"{name}.cu", defines)})[name])
            _libs[name, defines] = ctypes.CDLL(str(path))
        return _libs[name, defines]


def raise_on(err: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
