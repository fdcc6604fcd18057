"""The port stands alone: it imports neither JAX, networkx nor ``repro``,
and its engine never falls back to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "networkx", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    assert len(PORT_FILES) > 20 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'networkx', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.core.engine, repro_torch.interop, repro_torch.kernels.bitmm\n"
        "import repro_torch.data.graphs, repro_torch.configs.datalog_workloads\n"
        "import repro_torch.kernels.gather_sum, repro_torch.relational.segment\n"
        "import repro_torch.relational.embedding, repro_torch.models.recsys.two_tower\n"
        "import repro_torch.configs.two_tower_retrieval, repro_torch.data.recsys_stream\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_engine_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Engine() runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(device="cuda")
    assert Engine(device="cpu").device.type == "cpu"


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(EngineConfig(checkpoint_every=2, checkpoint_dir="ckpt"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(device="cpu").run("t(x) :- e(x).", {"e": [[1]]}, resume_from="ckpt")
    assert not hasattr(EngineConfig(), "use_pallas_bitmm")
