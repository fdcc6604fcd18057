"""The yardstick's arithmetic by hand: percentiles, the ``bitmm`` bound, the
device trace's union of intervals and its named gaps, the inputs a serve
cell draws, and which states a read may see."""

from __future__ import annotations

import json
from collections import namedtuple

import numpy as np
import pytest
import torch

from bench.harness import cell, inputs, peaks, profile, servecell
from bench.harness.spec import load_cell

Span = namedtuple("Span", "start_ns dur_ns span_id name")


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95), (list(range(1, 101)), 99, 99),
    (list(range(100, 0, -1)), 50, 50), ([7.5], 99, 7.5), ([3, 1, 2], 95, 3),
])
def test_percentile_is_nearest_rank(values, q, want):
    assert peaks.percentile(values, q) == want


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        peaks.percentile([], 95)


@pytest.mark.parametrize("words,bits", [([0], 0), ([1, 2, 4], 3), ([-1], 32),
                                        ([-(2**31)], 1), ([0x0F0F0F0F, 0x7FFFFFFF], 47)])
def test_popcount_counts_every_bit_of_int32_words(words, bits):
    assert peaks.popcount(torch.tensor(words, dtype=torch.int32)) == bits


def test_bitmm_bound_counts_what_the_inputs_need():
    # A: 2 rows over K = 64; set bits at columns 0 and 2 (row 0) and 32 (row 1)
    a = torch.tensor([[0b101, 0], [0, 1]], dtype=torch.int32)
    want_bytes = (a.numel() + 3 * 2 + 1 * 2 * 2) * 4     # A, 3 rows of B, C
    want_ops = 2.0 * 3 * 64
    assert peaks.bitmm_bound_s(a, 64, 1) == pytest.approx(
        max(want_bytes / peaks.HBM_BYTES_PER_S, want_ops / peaks.B1_OPS_PER_S))
    # fused: M read, Δ' and M' written
    assert peaks.bitmm_bound_s(a, 64, 3) == pytest.approx(
        (a.numel() + 3 * 2 + 3 * 2 * 2) * 4 / peaks.HBM_BYTES_PER_S)


def test_busy_time_is_the_union_of_intervals_on_every_stream():
    events = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a"), (35, 50, "c")]
    spans = [Span(12, 13, 1, "outer"), Span(16, 3, 2, "inner")]
    red = profile.reduce(events, 0, 40, spans)
    assert red["busy_s"] == pytest.approx(30e-9)      # 0-15, 20-30, 35-40: not 10 + 10 + 10 + 15
    assert red["window_s"] == pytest.approx(40e-9)
    ops = dict(red["breakdown"]["device_ops"])
    assert ops == pytest.approx({"a": 20e-9, "b": 10e-9, "c": 15e-9})
    gaps = dict(red["breakdown"]["idle_gaps"])
    # 15-20 falls under the innermost open span; 30-35 under none
    assert gaps == pytest.approx({"inner": 5e-9, "(no span)": 5e-9})


def test_a_read_may_see_every_state_published_while_it_was_in_flight():
    txns = [{"submitted": 1.0, "done": 2.0}, {"submitted": 3.0, "done": 5.0},
            {"submitted": 6.0}]
    assert servecell.states_allowed({"submitted": 2.5, "done": 5.5}, txns) == range(1, 3)
    assert servecell.states_allowed({"submitted": 0.5, "done": 0.9}, txns) == range(0, 1)
    assert servecell.states_allowed({"submitted": 5.5, "done": 7.0}, txns) == range(2, 4)
    ops = ["delete", "insert"]
    assert [cell._state_after(ops, j) for j in range(5)] == [
        "full", "held_out", "full", "held_out", "full"]


def test_serve_inputs_hold_out_a_share_of_the_rows_and_draw_keys_over_the_nodes():
    c = load_cell("tc-g10k.serve")
    cfg = json.loads(json.dumps(c.config))
    cfg["edb"]["args"].update(n=400, p=0.02)
    cfg["nodes"] = 400
    data = inputs.make(cfg, c.traffic, 2**31 + 77)
    arc = data.edb["arc"]
    assert len(data.held) == round(len(arc) * cfg["serve"]["update"]["share"])
    key = arc[:, 0].astype(np.int64) * 400 + arc[:, 1]
    held = data.held[:, 0].astype(np.int64) * 400 + data.held[:, 1]
    assert np.isin(held, key).all() and len(np.unique(held)) == len(held)
    assert len(data.read_keys) == inputs.READ_DRAWS
    assert data.read_keys.min() >= 0 and data.read_keys.max() < 400
    # Zipf(0.99): the most drawn key takes far more than a uniform share
    assert np.bincount(data.read_keys).max() > 20 * inputs.READ_DRAWS / 400
