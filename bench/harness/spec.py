"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix.  A configuration is the JSON file its entry names; a traffic mix is
``bench/traffic/<traffic>.json``; a per-layer metric is read by
``bench/metrics/<metric>.py``; a reference is ``bench/reference/<kind>.py``.
Adding any of them is adding files: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file, with its entry's keys
    traffic: dict                # the traffic mix's parameters
    end_to_end: list[dict]       # the end-to-end metrics this cell reports
    per_layer: list[dict]        # the per-layer metrics this cell reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell named ``name`` in ``root``'s ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    config.update(name=cfg_entry["name"], source=cfg_entry["source"],
                  reduced=cfg_entry["reduced"])
    traffic_file = root / "bench" / "traffic" / f"{entry['traffic']}.json"
    traffic = json.loads(traffic_file.read_text())
    return Cell(
        name=name, chips=entry["chips"], config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _load(path: Path, prefix: str):
    """The module in ``path``, loaded once a process under a name of its own."""
    name = prefix + str(path.resolve()).replace("/", "_").replace(".", "_").replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def metric_reader(name: str, root: Path = ROOT):
    """``read(records) -> float | None`` of ``bench/metrics/<name>.py``."""
    return _load(root / "bench" / "metrics" / f"{name}.py", "bench_metric_").read


def reference(kind: str, root: Path = ROOT):
    """The plain reference module ``bench/reference/<kind>.py``."""
    return _load(root / "bench" / "reference" / f"{kind}.py", "bench_reference_")


def generator(name: str, root: Path = ROOT):
    """The input generator ``name``: ``bench/data/generators.py``'s where it
    holds that name, else the function ``name`` of ``bench/data/<name>.py``."""
    from bench.data.generators import GENERATORS

    if name in GENERATORS:
        return GENERATORS[name]
    return getattr(_load(root / "bench" / "data" / f"{name}.py", "bench_data_"), name)
