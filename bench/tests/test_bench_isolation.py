"""No module of the benchmark imports JAX or the JAX package, the plain
reference imports nothing of the program either, and a generator imports
only numpy and the standard library.  Top-level module names
are compared whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "dataclasses", "numpy", "torch", "math"}


@pytest.mark.parametrize("path", sorted((BENCH / "data").rglob("*.py")), ids=lambda p: p.name)
def test_generators_import_only_numpy_and_the_standard_library(path):
    assert imported(path) <= {"numpy"} | set(sys.stdlib_module_names)


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import x\n")
    assert imported(f) == {"repro_torch"} and not imported(f) & FORBIDDEN
    f.write_text("import repro.core\n")
    assert imported(f) & FORBIDDEN == {"repro"}
