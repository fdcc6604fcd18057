"""End-to-end parity: ``repro_torch`` ``Engine.run`` (on the CPU) against
``repro``'s on every paper workload, every backend and every ablation of
``benchmarks/bench_optimizations.py``.

Exact equality: IDB rows, ``EvalStats`` (iterations and each record's
counts and DSD strategy; wall times excluded), every stored handle with its
pads, and the engine's trace spans.
"""

from collections import Counter

import numpy as np
import pytest

from conftest import random_edges
from repro.configs.datalog_workloads import ALL
from repro.obs.trace import TRACER as REF_TRACER
from repro_torch.data.program_facts import csda_facts, cspa_facts
from repro_torch.obs.trace import PORT_ONLY_SPANS, TRACER
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


def _spans_of(spans):
    return [
        (s.name, s.cat, {k: v for k, v in s.args.items() if k != "seconds"})
        for s in spans
    ]


def _traced_both(name):
    REF_TRACER.enable()
    TRACER.enable()
    try:
        run_both(ALL[name].program, _edb(name))
        return REF_TRACER.spans(), TRACER.spans()
    finally:
        REF_TRACER.disable()
        TRACER.disable()
        REF_TRACER.clear()
        TRACER.clear()


@pytest.mark.parametrize("name", ["tc", "cspa", "sssp"])
def test_trace_spans_match(name):
    """The port records every span the reference does, with the same
    attributes, in the same order; its own phase spans
    (``PORT_ONLY_SPANS``), which no reference span is named as, aside."""
    ref, port = _traced_both(name)
    ref_spans = _spans_of(ref)
    assert not {s[0] for s in ref_spans} & PORT_ONLY_SPANS
    port_spans = [s for s in _spans_of(port) if s[0] not in PORT_ONLY_SPANS]
    assert len(port_spans) >= 3
    assert [s[:2] for s in port_spans] == [s[:2] for s in ref_spans]
    assert port_spans == ref_spans


def test_port_spans_sit_under_their_parents():
    """TC on the CPU: the front end's spans under ``engine.prep``, the EDB
    dedup under its upload, PBME's phases under the bit-matrix stratum, once
    each; none carries device time or a sync on the CPU."""
    _ref, port = _traced_both("tc")
    by_id = {s.span_id: s for s in port}
    seen = Counter(
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id else None)
        for s in port if s.name in PORT_ONLY_SPANS
    )
    assert seen == {
        ("engine.prep", None): 1,
        ("engine.parse", "engine.prep"): 1,
        ("engine.analyze", "engine.prep"): 1,
        ("engine.domain", "engine.prep"): 1,
        ("edb.upload", "engine.prep"): 1,
        ("edb.dedup", "edb.upload"): 1,
        ("pbme.build", "stratum.eval"): 1,
        ("pbme.fixpoint", "stratum.eval"): 1,
        ("pbme.to_rows", "stratum.eval"): 1,
    }
    stratum = next(s for s in port if s.name == "stratum.eval")
    assert by_id[stratum.parent_id].name == "engine.run"
    upload = next(s for s in port if s.name == "edb.upload")
    edges = _edb("tc")["arc"]
    assert upload.args == {"rel": "arc", "rows_in": len(edges),
                           "rows": len(np.unique(edges, axis=0))}
    dedup = next(s for s in port if s.name == "edb.dedup")
    assert dedup.parent_id == upload.span_id
    assert dedup.args == {"dropped": upload.args["rows_in"] - upload.args["rows"]}
    to_rows = next(s for s in port if s.name == "pbme.to_rows")
    assert to_rows.args["rows"] == next(
        s for s in port if s.name == "stratum.eval").args["rows"]
    assert all(s.device_ns is None and s.syncs == 0 for s in port)
