"""Sorted-table primitives: the port against ``repro.relational.sort``.

Random int32 tables made with numpy go through both; results must be equal
exactly.  Domains cover the compact-key path (``domain**arity < SENTINEL``)
and the lexsort fallback.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.relational import sort as ref
from repro_torch.relational import sort as port

CASES = [
    # (rows, arity, domain): compact key fits / falls back to lexsort
    (300, 2, 50),
    (257, 3, 40),
    (200, 2, 60_000),
    (150, 3, 2_000),
]


def _table(seed, n, arity, domain, pads=17):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, domain, size=(n, arity)).astype(np.int32)
    rows[rng.integers(0, n, size=n // 4)] = rows[0]            # duplicates
    pad = np.full((pads, arity), ref.SENTINEL, np.int32)
    return np.concatenate([rows, pad])[rng.permutation(n + pads)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_sentinel():
    assert port.SENTINEL == int(ref.SENTINEL)


@pytest.mark.parametrize("n, arity, domain", CASES)
def test_keys_and_sorts(n, arity, domain):
    rows = _table(n, n, arity, domain)
    rk = ref.compact_key(jnp.asarray(rows), domain)
    pk = port.compact_key(torch.as_tensor(rows), domain)
    assert (rk is None) == (pk is None) == (domain**arity >= ref.SENTINEL)
    if rk is not None:
        np.testing.assert_array_equal(_np(rk), _np(pk))
    np.testing.assert_array_equal(
        _np(ref.lexsort_rows(jnp.asarray(rows))), _np(port.lexsort_rows(torch.as_tensor(rows)))
    )
    srt = np.array(ref.sort_rows(jnp.asarray(rows), domain))
    np.testing.assert_array_equal(srt, _np(port.sort_rows(torch.as_tensor(rows), domain)))
    np.testing.assert_array_equal(
        _np(ref.unique_mask(jnp.asarray(srt))), _np(port.unique_mask(torch.as_tensor(srt)))
    )


@pytest.mark.parametrize("seed", range(3))
def test_searchsorted_and_expand(seed):
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, 40, size=120).astype(np.int32))
    probe = rng.integers(-2, 45, size=90).astype(np.int32)
    rlo, rhi = ref.searchsorted_rows(jnp.asarray(key), jnp.asarray(probe))
    plo, phi = port.searchsorted_rows(torch.as_tensor(key), torch.as_tensor(probe))
    assert plo.dtype == phi.dtype == torch.int32
    np.testing.assert_array_equal(_np(rlo), _np(plo))
    np.testing.assert_array_equal(_np(rhi), _np(phi))
    counts = (np.asarray(rhi) - np.asarray(rlo)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.2] = 0
    for capacity in (int(counts.sum()), int(counts.sum()) + 37):
        expect = ref.expand_matches(rlo, jnp.asarray(counts), capacity)
        got = port.expand_matches(plo, torch.as_tensor(counts), capacity)
        for e, g in zip(expect, got):
            np.testing.assert_array_equal(_np(e), _np(g))
