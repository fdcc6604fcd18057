"""Shared helpers for the parity tests between ``repro`` and ``repro_torch``.

Every comparison here is exact: the Datalog path is integer work, so the two
packages must agree bit for bit.
"""

import numpy as np

from repro.core import Engine as RefEngine
from repro.core import EngineConfig as RefConfig
from repro_torch.core import Engine, EngineConfig


def record_key(stats):
    """EvalStats without wall times: iterations, per-record counts, backends."""
    return (
        stats.iterations,
        [
            (r.stratum, r.iteration, r.idb, r.candidates, r.deduped, r.delta, r.full,
             r.dsd_strategy)
            for r in stats.records
        ],
        stats.backend_used,
    )


def assert_blocks_equal(ref_blocks, port_blocks):
    """``{name: (meta, arrays)}`` maps equal: same meta, byte-identical arrays."""
    assert ref_blocks.keys() == port_blocks.keys()
    for name, (meta, arrays) in ref_blocks.items():
        pmeta, parrays = port_blocks[name]
        assert meta == pmeta, name
        assert arrays.keys() == parrays.keys(), name
        for k, arr in arrays.items():
            arr, parr = np.asarray(arr), np.asarray(parrays[k])
            assert arr.dtype == parr.dtype and arr.shape == parr.shape, (name, k)
            assert arr.tobytes() == parr.tobytes(), (name, k)


def run_both(program, edb, **cfg):
    """Run both engines (the port on the CPU) with the same config fields."""
    ref = RefEngine(RefConfig(**cfg))
    ref_out = ref.run(program, edb)
    port = Engine(EngineConfig(**cfg), device="cpu")
    port_out = port.run(program, edb)
    return ref, ref_out, port, port_out


def assert_runs_equal(program, edb, **cfg):
    """Rows, EvalStats and every stored handle (rows with pads, counts,
    capacities) agree exactly."""
    ref, ref_out, port, port_out = run_both(program, edb, **cfg)
    assert ref_out.keys() == port_out.keys()
    for name, rows in ref_out.items():
        assert rows.dtype == port_out[name].dtype, name
        np.testing.assert_array_equal(rows, port_out[name], err_msg=name)
    assert record_key(ref.stats) == record_key(port.stats)
    assert_blocks_equal(
        {k: h.to_blocks() for k, h in ref.store.items()},
        {k: h.to_blocks() for k, h in port.store.items()},
    )
    return ref, port
