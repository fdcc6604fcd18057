"""The serving layer: ``repro_torch.serve_datalog`` against ``repro.serve_datalog``.

Each test feeds the same seeded numpy EDB and the same transactions to the
reference instance (admission through the analyzer's rewrites, both
packages' default, and ``use_pallas_bitmm=False`` so that it runs its plain
compacted products) and
to the port's on the CPU, and compares bit for bit after every step: every
relation, every stored handle (rows with pads, counts, capacities), the
epoch, and the ``UpdateStats`` (modes, iteration counts, per-op applied
counts, derived/retracted totals, read and write sets).  The scenarios are
those of ``test_serve_datalog``, ``test_retraction``, ``test_transactions``
and ``test_snapshot_reads``; the retraction, transaction and snapshot ones
run from ``test_torch_serve_retract.py``, the server and the refusals from
``test_torch_serve_server.py``.
"""

import numpy as np
import pytest

from conftest import random_edges
from repro.configs.datalog_workloads import ALL as WORKLOADS
from repro.core import EngineConfig as RefConfig
from repro.data.program_facts import andersen_facts, csda_facts
from repro.serve_datalog import MaterializedInstance as RefInstance
from repro.serve_datalog import PlanCache as RefCache
from repro.serve_datalog.plan_cache import fingerprint as ref_fingerprint
from repro_torch.serve_datalog import MaterializedInstance, PlanCache
from repro_torch.serve_datalog.plan_cache import fingerprint
from torch_parity import NEG_PROG, SG, SSSP_COPY, TC, ServePair as Pair, stratum_of

# --------------------------------------------------------------------------
# inserts (test_serve_datalog)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["tuple", "auto"])
@pytest.mark.parametrize("seed", range(2))
def test_tc_inserts(seed, backend):
    rng = np.random.default_rng(seed)
    n = 25 + 5 * seed
    edges = random_edges(rng, n, 4 * n)
    k = len(edges) // 10
    pair = Pair(TC, {"arc": edges[:-k]}, backend=backend)
    for part in np.array_split(edges[-k:], 2):
        st = pair.insert("arc", part)
        assert st.modes.get(0, "skip") in (
            "bitmatrix" if backend == "auto" else "delta", "skip"
        )


@pytest.mark.parametrize("backend", ["tuple", "auto"])
def test_sg_inserts(backend):
    edges = random_edges(np.random.default_rng(100), 20, 55)
    pair = Pair(SG, {"arc": edges[:-6]}, backend=backend)
    st = pair.insert("arc", edges[-6:])
    assert st.modes == {0: "bitmatrix" if backend == "auto" else "delta"}


@pytest.mark.parametrize("rel", ["load"])
def test_andersen_inserts(rel):
    edb, _ = andersen_facts(1, seed=7)
    k = max(len(edb[rel]) // 8, 1)
    base = dict(edb)
    base[rel] = edb[rel][:-k]
    pair = Pair(WORKLOADS["andersen"].program, base)
    for part in np.array_split(edb[rel][-k:], 2):
        pair.insert(rel, part)


def test_csda_inserts():
    edb = csda_facts(200, seed=0)
    held = edb["arc"][100:110]                  # inside the active domain
    base = dict(edb)
    base["arc"] = np.concatenate([edb["arc"][:100], edb["arc"][110:]])
    pair = Pair(WORKLOADS["csda"].program, base, backend="tuple")
    st = pair.insert("arc", held)
    assert set(st.modes.values()) == {"delta"} and st.derived > 0


def test_dense_strata_inserts():
    """REACH (dense bit-vector), CC and SSSP (dense MIN tables, then a
    tuple-path MIN that recomputes), and a MIN improvement that retracts
    the old tuple downstream."""
    rng = np.random.default_rng(5)
    edges = random_edges(rng, 24, 70)
    ids = np.array([[0]], np.int32)
    Pair(WORKLOADS["reach"].program, {"arc": edges[:-8], "id": ids}).insert(
        "arc", edges[-8:]
    )
    Pair(WORKLOADS["cc"].program, {"arc": edges[:-8]}).insert("arc", edges[-8:])
    w = np.concatenate(
        [edges, rng.integers(1, 30, size=(len(edges), 1)).astype(np.int32)], axis=1
    )
    st = Pair(WORKLOADS["sssp"].program, {"arc": w[:-8], "id": ids}).insert(
        "arc", w[-8:]
    )
    assert "full" in st.modes.values()
    pair = Pair(SSSP_COPY, {"id": ids, "arc": np.array([[0, 1, 5]], np.int32)})
    st = pair.insert("arc", np.array([[0, 1, 2]], np.int32))
    assert st.modes[stratum_of(pair.port, "copy")] == "full"


def test_negation_forces_full_recompute():
    edges = random_edges(np.random.default_rng(40), 14, 30)
    pair = Pair(NEG_PROG, {"arc": edges[:-4]}, backend="tuple")
    st = pair.insert("arc", edges[-4:])
    assert st.modes[stratum_of(pair.port, "ntc")] == "full"
    assert st.modes[stratum_of(pair.port, "tc")] == "delta"


def test_noops_and_domain_growth():
    edges = random_edges(np.random.default_rng(9), 18, 40)
    for backend in ("tuple", "auto"):
        pair = Pair(TC, {"arc": edges}, backend=backend)
        st = pair.insert("arc", edges[:10])                 # all duplicates
        assert st.inserted == 0 and not st.modes
        pair.insert("arc", np.zeros((0, 2), np.int32))
        pair.delete("arc", np.array([[97, 99]], np.int32))  # absent
        st = pair.insert("arc", np.array([[21, 0], [1, 25]], np.int32))
        assert st.full_rebuild
        st = pair.insert("arc", np.array([[0, 21]], np.int32))
        assert not st.full_rebuild


# --------------------------------------------------------------------------
# admission: fingerprints, the plan cache, the analyzer's rewrites
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tc", "sg", "andersen", "csda", "cc", "sssp"])
def test_fingerprints_and_plans_match(name):
    prog = WORKLOADS[name].program
    assert fingerprint(prog) == ref_fingerprint(prog)
    ref_cache, port_cache = RefCache(), PlanCache()
    ref_plan = ref_cache.get(prog)
    port_plan = port_cache.get(prog)
    assert port_plan.fingerprint == ref_plan.fingerprint
    assert repr(port_plan.program) == repr(ref_plan.program)
    assert [s.preds for s in port_plan.strat.strata] == [
        s.preds for s in ref_plan.strat.strata
    ]
    assert port_cache.get(prog) is port_plan
    assert ref_cache.get(prog) is ref_plan
    assert port_cache.get(prog, analysis=None).fingerprint == ref_cache.get(
        prog, analysis=None).fingerprint
    assert port_cache.stats() == ref_cache.stats()


def test_warm_bookkeeping_matches(rng):
    edges = random_edges(rng, 20, 50)
    pair = Pair(NEG_PROG, {"arc": edges}, backend="tuple")
    assert pair.port.cache.stats() == pair.ref.cache.stats()
    assert pair.port.cache.stats()["warmed_buckets"] > 0


@pytest.mark.parametrize("name", ["tc", "sg", "andersen", "neg"])
def test_validate_only_admission_equals_reference_default(name):
    """Both packages admit through the analyzer's rewrites by default: the
    plans, fingerprints and admission diagnostics are equal, and so are the
    relations.  The rewrites preserve every IDB bit for bit, so validate-only
    admission (``analysis=None``) gives the same relations too."""
    if name == "neg":
        prog, edb = NEG_PROG, {"arc": random_edges(np.random.default_rng(4), 14, 30)}
    elif name == "andersen":
        prog, edb = WORKLOADS[name].program, andersen_facts(1, seed=7)[0]
    else:
        prog = WORKLOADS[name].program
        edb = {"arc": random_edges(np.random.default_rng(4), 20, 50)}
    ref = RefInstance(prog, edb, RefConfig(use_pallas_bitmm=False), cache=RefCache())
    port = MaterializedInstance(prog, edb, cache=PlanCache(), device="cpu")
    raw = MaterializedInstance(prog, edb, cache=PlanCache(), analysis=None, device="cpu")
    assert port.plan.fingerprint == ref.plan.fingerprint
    assert repr(port.plan.program) == repr(ref.plan.program)
    assert ([d.to_dict() for d in port.plan.report.diagnostics]
            == [d.to_dict() for d in ref.plan.report.diagnostics])
    assert raw.plan.report is None
    for rel in ref.strat.idb:
        np.testing.assert_array_equal(port.relation(rel), ref.relation(rel), err_msg=rel)
        np.testing.assert_array_equal(raw.relation(rel), ref.relation(rel), err_msg=rel)
