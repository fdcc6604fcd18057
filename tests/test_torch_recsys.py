"""The two-tower serving path: the port against ``repro`` on the CPU.

Inputs are made from a seed with numpy and handed to both packages; weights
cross with ``two_tower_from_reference``.  Tolerances: 1e-5 on bags, tower
outputs and the relational ops (float32, other summation order), 1e-4 on
scores (tower outputs ÷ temperature 0.05).  The port runs with
``device="cpu"``, where every bag takes the gather-sum kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as ref_configs
from repro.data.recsys_stream import RecsysStream as RefStream
from repro.models.recsys import two_tower as ref_tt
from repro.relational import embedding as ref_emb
from repro.relational import segment as ref_seg
from repro_torch.configs import two_tower_retrieval as configs
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.interop import two_tower_from_reference
from repro_torch.kernels import gather_sum as kg
from repro_torch.models.common import dense_init, mlp_apply, mlp_init
from repro_torch.models.recsys import RecsysConfig, TwoTower
from repro_torch.relational import embedding, segment

TOL = 1e-5
SCORE_TOL = 1e-4


def _t(arr):
    return torch.tensor(np.asarray(arr))


def _close(got, expect, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=tol, rtol=tol)


# -- embedding_bag ----------------------------------------------------------


def _bag_inputs(seed, n=30, d=6, bags=7, k=5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    dense = rng.integers(-1, n, size=(bags, k)).astype(np.int32)
    dense[0] = -1                                                 # an empty bag
    weights = rng.standard_normal((bags, k)).astype(np.float32)
    nnz = 20
    flat = rng.integers(-1, n, size=nnz).astype(np.int32)
    bag_ids = np.sort(rng.integers(0, bags, size=nnz)).astype(np.int32)
    return table, dense, weights, flat, bag_ids, bags


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_embedding_bag_matches_reference(layout, weighted, mode):
    table, dense, weights, flat, bag_ids, bags = _bag_inputs(3)
    if layout == "dense":
        args, kw = (dense,), {}
    else:
        args, kw = (flat, bag_ids), {"num_bags": bags}
        weights = weights.reshape(-1)[: len(flat)]
    w = weights if weighted else None
    expect = ref_emb.embedding_bag(
        jnp.asarray(table), *map(jnp.asarray, args), mode=mode,
        weights=None if w is None else jnp.asarray(w), **kw)
    got = embedding.embedding_bag(
        _t(table), *map(_t, args), mode=mode, weights=None if w is None else _t(w), **kw)
    _close(got, expect)


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_embedding_bag_out_of_range_id_is_nan(layout):
    table, dense, _, flat, bag_ids, bags = _bag_inputs(4)
    dense[2, 1] = flat[5] = 30
    args = (dense,) if layout == "dense" else (flat, bag_ids)
    kw = {} if layout == "dense" else {"num_bags": bags}
    for mode in ("sum", "mean"):
        expect = np.asarray(ref_emb.embedding_bag(
            jnp.asarray(table), *map(jnp.asarray, args), mode=mode, **kw))
        assert np.isnan(expect).any()
        got = embedding.embedding_bag(_t(table), *map(_t, args), mode=mode, **kw)
        _close(got, expect)


def test_embedding_bag_dense_sum_takes_the_kernel_route(monkeypatch):
    calls = []
    real = embedding.gather_sum
    monkeypatch.setattr(embedding, "gather_sum", lambda i, t: calls.append(1) or real(i, t))
    table, dense, weights, flat, bag_ids, bags = _bag_inputs(5)
    embedding.embedding_bag(_t(table), _t(dense))
    assert calls == [1]
    embedding.embedding_bag(_t(table), _t(dense), mode="mean")
    embedding.embedding_bag(_t(table), _t(dense), weights=_t(weights))
    embedding.embedding_bag(_t(table), _t(flat), _t(bag_ids), num_bags=bags)
    assert calls == [1]


def test_embedding_bag_refuses_bad_arguments():
    table, dense, _, flat, bag_ids, _ = _bag_inputs(6)
    with pytest.raises(ValueError, match="mode"):
        embedding.embedding_bag(_t(table), _t(dense), mode="max")
    with pytest.raises(ValueError, match="num_bags"):
        embedding.embedding_bag(_t(table), _t(flat), _t(bag_ids))


@pytest.mark.parametrize("log_q", [False, True])
def test_sampled_softmax_loss_matches_reference(log_q):
    rng = np.random.default_rng(7)
    q, v = (rng.standard_normal((9, 4)).astype(np.float32) for _ in range(2))
    lq = np.log(rng.random(9)).astype(np.float32) if log_q else None
    expect = ref_emb.sampled_softmax_loss(
        jnp.asarray(q), jnp.asarray(v), log_q=None if lq is None else jnp.asarray(lq),
        temperature=0.05)
    got = embedding.sampled_softmax_loss(
        _t(q), _t(v), log_q=None if lq is None else _t(lq), temperature=0.05)
    np.testing.assert_allclose(float(got), float(expect), rtol=TOL)


# -- segment ops --------------------------------------------------------------


def _segment_inputs(seed, e=40, num=9, d=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        data = rng.standard_normal((e, d)).astype(dtype)
    else:
        data = rng.integers(-100, 100, size=(e, d)).astype(dtype)
    ids = rng.integers(0, num - 3, size=e).astype(np.int32)      # segments num-3.. empty
    ids[:3] = [num + 2, -1, num]                                 # dropped, as JAX drops them
    return data, ids, num


SEGMENT_CASES = [(op, dt) for op in ("segment_sum", "segment_max", "segment_min")
                 for dt in (np.float32, np.int32)] + [("segment_mean", np.float32)]


@pytest.mark.parametrize("op, dtype", SEGMENT_CASES,
                         ids=[f"{op}-{np.dtype(dt).name}" for op, dt in SEGMENT_CASES])
def test_segment_ops_match_reference(op, dtype):
    data, ids, num = _segment_inputs(8, dtype=dtype)
    expect = np.asarray(getattr(ref_seg, op)(jnp.asarray(data), jnp.asarray(ids), num))
    got = getattr(segment, op)(_t(data), _t(ids), num)
    assert got.numpy().dtype == expect.dtype
    np.testing.assert_allclose(got.numpy(), expect, atol=TOL, rtol=TOL)
    if op in ("segment_max", "segment_min"):
        assert (got.numpy()[num - 3:] == expect[num - 3:]).all()    # identities for empties


def test_segment_softmax_and_degree_match_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal(30).astype(np.float32) * 10
    ids = rng.integers(0, 5, size=30).astype(np.int32)
    _close(segment.segment_softmax(_t(logits), _t(ids), 7),
           ref_seg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), 7))
    _close(segment.degree(_t(ids), 7), ref_seg.degree(jnp.asarray(ids), 7))


@pytest.mark.parametrize("agg", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_gather_scatter_matches_reference(agg, weighted):
    rng = np.random.default_rng(10)
    feats = rng.standard_normal((12, 4)).astype(np.float32)
    src = rng.integers(0, 12, size=25).astype(np.int32)
    dst = rng.integers(0, 9, size=25).astype(np.int32)            # nodes 9..11 receive nothing
    w = rng.random(25).astype(np.float32) if weighted else None
    expect = ref_seg.gather_scatter(
        jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), 12,
        edge_weight=None if w is None else jnp.asarray(w), agg=agg)
    got = segment.gather_scatter(_t(feats), _t(src), _t(dst), 12,
                                 edge_weight=None if w is None else _t(w), agg=agg)
    _close(got, expect)


def test_gather_scatter_refuses_unknown_aggregator():
    with pytest.raises(ValueError, match="aggregator"):
        segment.gather_scatter(torch.zeros((2, 1)), torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), 2, agg="prod")


# -- the click stream ---------------------------------------------------------


@pytest.mark.parametrize("vocab, batch, seed", [((1000, 500), 16, 0), ((7, 3), 5, 3),
                                                ((50_000, 20_000), 64, 11)])
def test_recsys_stream_is_byte_identical(vocab, batch, seed):
    args = (*vocab, 3, 2, 4, 5)
    ref, port = RefStream(*args, batch=batch, seed=seed), RecsysStream(*args, batch=batch, seed=seed)
    assert port.item_p.tobytes() == ref.item_p.tobytes()
    for step in (0, 1, 17):
        want, got = ref.batch(step), port.batch(step)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


# -- the model ----------------------------------------------------------------

FULL_WIDTHS = dataclasses.replace(configs.FULL, user_vocab=3000, item_vocab=2000)


def _port_cfg(cfg) -> RecsysConfig:
    return RecsysConfig(**dataclasses.asdict(cfg))


def test_configs_match_reference():
    for name in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(configs, name)) == dataclasses.asdict(
            getattr(ref_configs, name))


def _pair(cfg, batch, seed=0):
    """Reference params and batch, and the port's model and batch, same numbers."""
    ref_cfg = ref_tt.RecsysConfig(**dataclasses.asdict(cfg))
    params = jax.tree.map(np.asarray, ref_tt.init_params(jax.random.PRNGKey(seed), ref_cfg))
    model = two_tower_from_reference(params, cfg, "cpu")
    stream = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                          cfg.field_hots, cfg.n_dense_feat, batch=batch, seed=seed)
    b = stream.batch(0)
    return (params, ref_cfg, {k: jnp.asarray(v) for k, v in b.items()},
            model, {k: _t(v) for k, v in b.items()})


@pytest.fixture(scope="module", params=["smoke", "full_widths"])
def pair(request):
    cfg = configs.SMOKE if request.param == "smoke" else FULL_WIDTHS
    return _pair(cfg, batch=32)


def test_towers_match_reference(pair):
    params, ref_cfg, rb, model, pb = pair
    q, v = ref_tt.forward(params, rb, ref_cfg)
    pq, pv = model(pb)
    assert tuple(pq.shape) == q.shape and tuple(pv.shape) == v.shape
    _close(pq, q)
    _close(pv, v)
    _close(model.user_tower(pb["user_ids"], pb["user_dense"]),
           ref_tt.user_tower(params, rb["user_ids"], rb["user_dense"], ref_cfg))
    _close(model.item_tower(pb["item_ids"]), ref_tt.item_tower(params, rb["item_ids"], ref_cfg))


def test_serve_scores_match_reference(pair):
    params, ref_cfg, rb, model, pb = pair
    expect = ref_tt.serve_scores(params, rb, ref_cfg)
    _close(model.serve_scores(pb), expect, SCORE_TOL)
    assert kg.gather_sum.launches == 0            # the CPU route never launches


def assert_topk_close(values, indices, ref_values, ref_indices, tol):
    """Values within ``tol``; indices equal wherever the reference's scores on
    both sides of a slot (``ref_values`` carries one score past the top k)
    differ by more than ``tol``."""
    k = values.shape[1]
    np.testing.assert_allclose(values, ref_values[:, :k], atol=tol, rtol=0)
    gaps = -np.diff(ref_values, axis=1) > tol                     # [B, k]
    apart = gaps & np.concatenate([np.ones_like(gaps[:, :1]), gaps[:, :-1]], axis=1)
    assert apart.mean() > 0.5
    np.testing.assert_array_equal(indices[apart], ref_indices[:, :k][apart])


@pytest.mark.parametrize("top_k", [1, 10])
def test_retrieval_scores_match_reference(pair, top_k):
    params, ref_cfg, rb, model, pb = pair
    rng = np.random.default_rng(12)
    cand = rng.standard_normal((300, ref_cfg.tower_dims[-1])).astype(np.float32)
    cand /= np.linalg.norm(cand, axis=1, keepdims=True)
    ref_v, ref_i = ref_tt.retrieval_scores(params, rb, jnp.asarray(cand), ref_cfg,
                                           top_k=top_k + 1)
    vals, idx = model.retrieval_scores(pb, _t(cand), top_k=top_k)
    assert tuple(vals.shape) == (32, top_k) and idx.dtype == torch.int64
    assert_topk_close(vals.numpy(), idx.numpy(), np.asarray(ref_v), np.asarray(ref_i),
                      SCORE_TOL)


def test_heads_on_plain_bags_equal_the_towers(pair):
    """``chip_smoke.py`` builds its plain side from the heads and the plain
    version's bags; on the CPU the two are the same computation."""
    _, _, _, model, pb = pair
    from repro_torch.kernels.ref import gather_sum_plain

    fields = pb["user_ids"].transpose(0, 1).contiguous()
    bags = [gather_sum_plain(f, model.user_table) for f in fields]
    assert torch.equal(model.user_head(bags, pb["user_dense"]),
                       model.user_tower(pb["user_ids"], pb["user_dense"]))


def _zipf_field_ids(seed, b=64, f=3, k=8, n=40):
    """Multi-hot ids drawn from Zipf(1) over ``n`` rows (most slots repeat a
    row), a fifth of the slots padded and one id past the table (a NaN bag)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n + 1)
    ids = rng.choice(n, size=(b, f, k), p=p / p.sum()).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[5, 1, 2] = n
    return ids


@pytest.mark.parametrize("case", ["smoke", "zipf"])
def test_field_bags_fold_every_field_into_one_call(case, monkeypatch):
    """``field_bags`` hands all B·F bags of a table to one gather-sum call as a
    [B·F, K] view and returns field f as the strided view ``out[:, f]``: the
    sums of the reference's per-field ``embedding_bag``."""
    from repro_torch.models.recsys import two_tower

    if case == "smoke":
        cfg = configs.SMOKE
        ids = RecsysStream(cfg.user_vocab, cfg.item_vocab, cfg.user_fields, cfg.item_fields,
                           cfg.field_hots, cfg.n_dense_feat, batch=32, seed=3).batch(0)["user_ids"]
        n, d = cfg.user_vocab, cfg.embed_dim
    else:
        ids, n, d = _zipf_field_ids(4), 40, 16
    table = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    calls = []
    real = embedding.gather_sum
    monkeypatch.setattr(embedding, "gather_sum",
                        lambda i, t: calls.append(tuple(i.shape)) or real(i, t))
    bags = two_tower.field_bags(_t(table), _t(ids))
    b, f, k = ids.shape
    assert calls == [(b * f, k)]
    assert len(bags) == f and all(bag.shape == (b, d) and bag.stride() == (f * d, 1)
                                  for bag in bags)
    for field in range(f):
        _close(bags[field], ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids[:, field])))
    if case == "zipf":
        assert bags[1][5].isnan().all() and not bags[0][5].isnan().any()


def test_serve_scores_match_reference_on_repeat_heavy_items():
    """Items drawn from Zipf(1) over 40 rows: most of a batch's item lookups
    repeat a row; the scores are the reference's."""
    cfg = dataclasses.replace(configs.SMOKE, item_vocab=40)
    params, ref_cfg, rb, model, pb = _pair(cfg, batch=64, seed=2)
    items = pb["item_ids"][pb["item_ids"] >= 0]
    assert torch.unique(items).numel() < items.numel() / 4
    _close(model.serve_scores(pb), ref_tt.serve_scores(params, rb, ref_cfg), SCORE_TOL)
    _close(model.item_tower(pb["item_ids"]), ref_tt.item_tower(params, rb["item_ids"], ref_cfg))


def test_two_tower_from_reference_refuses_mismatched_params():
    cfg = configs.SMOKE
    params = jax.tree.map(np.asarray, ref_tt.init_params(
        jax.random.PRNGKey(0), ref_tt.RecsysConfig(**dataclasses.asdict(cfg))))
    with pytest.raises(ValueError, match="shape"):
        two_tower_from_reference(params, dataclasses.replace(cfg, embed_dim=8), "cpu")
    params["user_mlp"] = {k: v for k, v in params["user_mlp"].items() if k != "b0"}
    with pytest.raises(ValueError, match="parameters"):
        two_tower_from_reference(params, cfg, "cpu")


def test_two_tower_init_is_seeded_and_frozen():
    cfg = configs.SMOKE
    a = TwoTower(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TwoTower(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = TwoTower(cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert shapes == {
        "user_table": (1000, 16), "item_table": (500, 16),
        "user_mlp.w0": (37, 32), "user_mlp.b0": (32,), "user_mlp.w1": (32, 16),
        "user_mlp.b1": (16,),
        "item_mlp.w0": (32, 32), "item_mlp.b0": (32,), "item_mlp.w1": (32, 16),
        "item_mlp.b1": (16,),
    }
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in shapes)
    assert not torch.equal(a.user_table, c.user_table)
    assert not any(p.requires_grad for p in a.parameters())
    assert abs(float(a.user_table.std()) - 0.01) < 1e-3


def test_two_tower_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: TwoTower() runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TwoTower(configs.SMOKE)
    assert TwoTower(configs.SMOKE, device="cpu").user_table.device.type == "cpu"


def test_common_mlp_matches_reference_layout():
    from repro.models import common as ref_common

    gen = torch.Generator().manual_seed(0)
    params = mlp_init(gen, (5, 7, 3))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w0": (5, 7), "b0": (7,), "w1": (7, 3), "b1": (3,)}
    x = np.random.default_rng(13).standard_normal((4, 5)).astype(np.float32)
    expect = ref_common.mlp_apply({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                                  jnp.asarray(x))
    _close(mlp_apply(params, _t(x)), expect)
    w = dense_init(gen, 400, 300)
    assert abs(float(w.std()) - 400 ** -0.5) < 2e-3
