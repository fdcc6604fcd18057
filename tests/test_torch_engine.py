"""End-to-end parity: ``repro_torch`` ``Engine.run`` (on the CPU) against
``repro``'s on every paper workload, every backend and every ablation of
``benchmarks/bench_optimizations.py``.

Exact equality: IDB rows, ``EvalStats`` (iterations and each record's
counts and DSD strategy; wall times excluded), every stored handle with its
pads, and the engine's trace spans.
"""

import numpy as np
import pytest

from conftest import random_edges
from repro.configs.datalog_workloads import ALL
from repro.obs.trace import TRACER as REF_TRACER
from repro_torch.data.program_facts import csda_facts, cspa_facts
from repro_torch.obs.trace import TRACER
from torch_parity import assert_runs_equal, run_both


def _edb(name: str) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(11)
    edges = random_edges(rng, 30, 70)
    src = np.array([[int(edges[0, 0])]], np.int32)
    if name in ("tc", "sg", "cc"):
        return {"arc": edges}
    if name == "reach":
        return {"id": src, "arc": edges}
    if name == "sssp":
        w = rng.integers(1, 10, size=(len(edges), 1)).astype(np.int32)
        return {"id": src, "arc": np.concatenate([edges, w], axis=1)}
    if name == "andersen":
        return {
            rel: np.unique(rng.integers(0, 15, size=(m, 2)), axis=0).astype(np.int32)
            for rel, m in (("addressOf", 12), ("assign", 20), ("load", 6), ("store", 6))
        }
    if name == "cspa":
        return cspa_facts(10)
    return csda_facts(150)


@pytest.mark.parametrize("backend", ["auto", "tuple", "bitmatrix"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_workload_matches(name, backend):
    ref, port = assert_runs_equal(ALL[name].program, _edb(name), backend=backend)
    if name in ("tc", "sg") and backend != "tuple":
        assert port.stats.backend_used[name] == "bitmatrix"


ABLATIONS = {
    "no-UIE": {"enable_uie": False},
    "no-OOF": {"enable_oof": False},
    "DSD-fixed-opsd": {"dsd": "opsd"},
    "DSD-fixed-tpsd": {"dsd": "tpsd"},
    "no-EOST": {"enable_eost": False},
    "no-dense": {"enable_dense": False},
}


@pytest.mark.parametrize("ablation", sorted(ABLATIONS))
@pytest.mark.parametrize("name", ["cspa", "andersen", "cc", "reach"])
def test_ablation_matches(name, ablation):
    assert_runs_equal(ALL[name].program, _edb(name), **ABLATIONS[ablation])


def _spans(tracer):
    return [
        (s.name, s.cat, {k: v for k, v in s.args.items() if k != "seconds"})
        for s in tracer.spans()
    ]


@pytest.mark.parametrize("name", ["tc", "cspa", "sssp"])
def test_trace_spans_match(name):
    REF_TRACER.enable()
    TRACER.enable()
    try:
        run_both(ALL[name].program, _edb(name))
        ref_spans, port_spans = _spans(REF_TRACER), _spans(TRACER)
    finally:
        REF_TRACER.disable()
        TRACER.disable()
        REF_TRACER.clear()
        TRACER.clear()
    assert len(port_spans) >= 3
    assert [s[:2] for s in port_spans] == [s[:2] for s in ref_spans]
    assert port_spans == ref_spans
