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
    names = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES[:-1]}
    for module in ("serve_datalog/instance.py", "serve_datalog/server.py",
                   "serve_datalog/plan_cache.py", "core/versioned_store.py",
                   "obs/profile.py", "obs/metrics.py", "persist/codec.py",
                   "persist/manager.py", "persist/wal.py", "loadgen/scenario.py",
                   "loadgen/arrivals.py", "loadgen/clock.py", "analysis/__init__.py",
                   "analysis/__main__.py", "analysis/demand.py", "analysis/diagnostics.py",
                   "analysis/linter.py", "analysis/passes.py", "analysis/rewrites.py",
                   "distributed/mesh.py", "distributed/collectives.py",
                   "distributed/context.py", "core/distributed.py", "optim/adamw.py",
                   "optim/schedule.py", "optim/grad_compress.py", "train/state.py",
                   "train/step.py", "train/checkpoint.py", "train/fault_tolerance.py",
                   "launch/train.py", "launch/serve.py", "train/serve.py",
                   "models/transformer/__init__.py", "models/transformer/config.py",
                   "models/transformer/layers.py", "models/transformer/model.py",
                   "configs/registry.py", "configs/qwen2_7b.py", "configs/deepseek_v2_lite_16b.py",
                   "configs/qwen1_5_0_5b.py", "configs/gemma_2b.py",
                   "configs/granite_moe_1b_a400m.py", "data/tokens.py",
                   "relational/sampler.py", "models/gnn/__init__.py", "models/gnn/common.py",
                   "models/gnn/gcn.py", "models/gnn/meshgraphnet.py", "models/gnn/schnet.py",
                   "models/gnn/graphcast.py", "configs/gcn_cora.py", "configs/graphcast.py",
                   "configs/meshgraphnet.py", "configs/schnet.py", "distributed/sharding.py",
                   "launch/mesh.py"):
        assert f"repro_torch/{module}" in names


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
        "import repro_torch.serve_datalog, repro_torch.serve_datalog.server\n"
        "import repro_torch.core.versioned_store, repro_torch.obs.profile\n"
        "import repro_torch.obs.metrics, repro_torch.obs.explain, repro_torch.obs.stats\n"
        "import repro_torch.persist, repro_torch.loadgen, repro_torch.analysis.__main__\n"
        "import repro_torch.distributed, repro_torch.core.distributed, repro_torch.optim\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "import repro_torch.models.transformer, repro_torch.train.serve, repro_torch.launch.serve\n"
        "import repro_torch.configs.registry, repro_torch.data.tokens\n"
        "import repro_torch.models.gnn, repro_torch.relational.sampler\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "from repro_torch.configs import registry\n"
        "for arch in registry.ALL_ARCHS:\n"
        "    registry.arch_config(arch)\n"
        "for arch, shape in registry.all_cells():\n"
        "    registry.build_cell(arch, shape, {'data': 1, 'model': 1})\n"
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
    # the reference's Pallas switch has no counterpart: the port always
    # runs its own kernels on the card
    assert not hasattr(EngineConfig(), "use_pallas_bitmm")
    with pytest.raises(TypeError, match="use_pallas_bitmm"):
        EngineConfig(use_pallas_bitmm=True)
