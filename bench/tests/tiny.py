"""A copy of the benchmark with tiny configurations added as new files, for
tests on the CPU: the same harness, the same traffic mixes and metrics."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: tiny stand-ins for the configurations: name → (file it copies, changes)
TINY = {
    "tc-tiny": ("tc-g10k", {"edb.args.n": 300, "edb.args.p": 0.01, "nodes": 300}),
}


def _set(doc: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for key in path:
        doc = doc[key]
    doc[last] = value


def tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``bench/`` with the tiny
    configurations and their cells (``<config>.eval``, ``<config>.serve``)
    added by new files and new entries only."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (base, changes) in TINY.items():
        cfg = json.loads((ROOT / "bench" / "configs" / f"{base}.json").read_text())
        for key, value in changes.items():
            _set(cfg, key, value)
        (dest / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tiny", "file":
                                 f"bench/configs/{name}.json", "reduced": ["nodes"],
                                 "why": "CPU tests"})
        for traffic in ("eval", "serve"):
            cell = f"{name}.{traffic}"
            bench["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                                       "chips": 1, "why": "CPU tests"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if f"{base}.{traffic}" in m.get("workloads", ()):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
