"""Generators are found by file, the frozen RMAT generator draws the port's
graphs, and the cells the benchmark already has keep their inputs."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from bench.data.generators import GENERATORS
from bench.harness import inputs
from bench.harness.spec import generator, load_cell
from bench.tests.tiny import tiny_root


@pytest.mark.parametrize("n_log2", [8, 12, 14])
def test_rmat_graph_draws_the_ports_graph(n_log2):
    from repro_torch.data.graphs import rmat_graph as port

    arc = generator("rmat_graph")(n_log2)["arc"]
    want = port(n_log2)
    assert arc.dtype == want.dtype == np.int32
    assert np.array_equal(arc, want)


def test_rmat_graph_keeps_the_ports_arguments():
    from repro_torch.data.graphs import rmat_graph as port

    rmat = generator("rmat_graph")
    arc = rmat(8, edge_factor=4, seed=3, a=0.45, b=0.15, c=0.15)["arc"]
    assert np.array_equal(arc, port(8, edge_factor=4, seed=3, a=0.45, b=0.15, c=0.15))
    assert not np.array_equal(arc, rmat(8)["arc"])


def test_a_generator_is_found_by_name_or_by_file(tmp_path):
    assert generator("gnp_graph") is GENERATORS["gnp_graph"]
    root = tiny_root(tmp_path)
    (root / "bench" / "data" / "two_arcs.py").write_text(
        "import numpy as np\n\n\ndef two_arcs(n):\n"
        "    return {'arc': np.array([[0, 1], [1, n - 1]], np.int32)}\n")
    assert generator("two_arcs", root)(5)["arc"].tolist() == [[0, 1], [1, 4]]
    assert generator("rmat_graph", root)(8)["arc"].shape == (1802, 2)
    with pytest.raises(FileNotFoundError):
        generator("no_such_generator", root)


def test_make_reads_a_generator_file_of_its_root(tmp_path):
    root = tiny_root(tmp_path)
    (root / "bench" / "data" / "ring.py").write_text(
        "import numpy as np\n\n\ndef ring(n):\n"
        "    i = np.arange(n, dtype=np.int32)\n"
        "    return {'arc': np.stack([i, (i + 1) % n], axis=1)}\n")
    cfg = {"edb": {"generator": "ring", "args": {"n": 7}}, "nodes": 7}
    data = inputs.make(cfg, {"kind": "eval"}, 2**31 + 7, root)
    arc = data.edb["arc"]
    assert data.n == 7 and len(arc) == 7
    inv = np.argsort(inputs.rng_of(2**31 + 7, 0).permutation(7))
    ring = inv[arc]
    assert sorted(map(tuple, ring.tolist())) == [(i, (i + 1) % 7) for i in range(7)]


def _digest(data: inputs.Inputs) -> str:
    h = hashlib.sha256()
    for k in sorted(data.edb):
        a = data.edb[k]
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    for a in (data.held, data.read_keys):
        if a is not None:
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    h.update(str(data.n).encode())
    return h.hexdigest()


S1, S2, S3 = 2**31 + 5, 3200000401, 7
#: (cell, seed) → the digest of its EDB arrays, held-out rows and read keys,
#: as the harness made them before generators could come from files
DIGESTS = {
    ("tc-g10k.eval", S1): "c0d6338cccfc0666310d40641e68dc642616e9e1d38c1e6fa4da1375bd89cf0e",
    ("tc-g10k.eval", S2): "eeda75befd0a94640894e66818939b8c7ea081af1e0f581c30662bc477260ac2",
    ("tc-g10k.eval", S3): "b52029d13fc0ffc839c11caa3e01d32e3d06a2ce491d49d53df941d260f30558",
    ("tc-g10k.serve", S1): "9e2121b70c43ca5b27d5fb3a732862c93a9c9042b326bc142cdc950b15a3a48b",
    ("tc-g10k.serve", S2): "f674339efd75724cefd8fa6afd094b498117acf5bfcb344a500fa6dd69e421d7",
    ("tc-g10k.serve", S3): "fc69c77bdb086e83afd17aff9055cd147b2e0668374d5690ef90ec3525df874a",
    ("sg-g10k.eval", S1): "c0d6338cccfc0666310d40641e68dc642616e9e1d38c1e6fa4da1375bd89cf0e",
    ("sg-g10k.eval", S2): "eeda75befd0a94640894e66818939b8c7ea081af1e0f581c30662bc477260ac2",
    ("sg-g10k.eval", S3): "b52029d13fc0ffc839c11caa3e01d32e3d06a2ce491d49d53df941d260f30558",
}


@pytest.mark.parametrize(("name", "seed"), sorted(DIGESTS), ids=str)
def test_existing_cells_keep_their_inputs(name, seed):
    c = load_cell(name)
    assert _digest(inputs.make(c.config, c.traffic, seed)) == DIGESTS[name, seed]
