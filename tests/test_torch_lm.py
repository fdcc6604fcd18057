"""The transformer LMs: ``repro_torch.models.transformer`` against
``repro.models.transformer`` at the five SMOKE configs.

Each case feeds the same weights (the reference's ``init_params``, carried
over by ``interop.transformer_params_from_reference``) and the same numpy
tokens to both packages on the CPU.  Tolerance: 1e-5 of each output's
largest absolute value in float32, 2e-2 in bfloat16.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map

from repro.configs import registry as ref_registry
from repro.data.tokens import TokenStream as RefTokenStream
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.models.transformer import layers as ref_layers
from repro.models.transformer import model as ref_model
from repro_torch.configs import registry
from repro_torch.data import TokenStream
from repro_torch.distributed.context import mesh_context
from repro_torch.interop import (
    transformer_params_from_reference,
    transformer_params_to_reference,
)
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import layers, model

ARCHS = list(ref_registry.LM_ARCHS)
MOE_ARCHS = [a for a in ARCHS if ref_registry.arch_config(a, smoke=True).moe]
TOL, BF16_TOL = 1e-5, 2e-2
DECODE_STEPS = 8
# the reference's functions, compiled once per config (op by op they take minutes)
ref_forward = jax.jit(ref_tf.forward, static_argnums=2)
ref_lm_loss = jax.jit(ref_tf.lm_loss, static_argnums=2)
ref_prefill = jax.jit(ref_tf.prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(ref_tf.decode_step, static_argnums=4)


def close(got, want, tol=TOL):
    """|got − want| ≤ tol · max |want|, elementwise over the whole output."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, err


def configs(arch, **changes):
    ref = dataclasses.replace(ref_registry.arch_config(arch, smoke=True), **changes)
    port = dataclasses.replace(registry.arch_config(arch, smoke=True), **changes)
    return ref, port


def both_params(ref_cfg, port_cfg, seed=0):
    ref = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref, transformer_params_from_reference(jax.tree.map(np.asarray, ref), port_cfg, "cpu")


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    ref_cfg, cfg = configs(request.param)
    ref_p, p = both_params(ref_cfg, cfg)
    return ref_cfg, cfg, ref_p, p


# -- the model -----------------------------------------------------------------


def test_forward_and_loss(pair):
    ref_cfg, cfg, ref_p, p = pair
    toks = tokens(cfg, (2, 12))
    want, want_aux = ref_forward(ref_p, jnp.asarray(toks), ref_cfg)
    got, aux = tf.forward(p, torch.as_tensor(toks), cfg)
    close(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * max(abs(float(want_aux)), 1.0)
    assert (float(aux) > 0) == cfg.moe
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    batch["labels"][0, -3:] = -1                                     # ignored labels
    want_loss = ref_lm_loss(ref_p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    got_loss = tf.lm_loss(p, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    assert abs(float(got_loss) - float(want_loss)) <= TOL * abs(float(want_loss))


def test_prefill_and_every_cache_tensor(pair):
    ref_cfg, cfg, ref_p, p = pair
    toks = tokens(cfg, (2, 7))
    want, want_cache = ref_prefill(ref_p, jnp.asarray(toks), ref_cfg, 16)
    got, cache = tf.prefill(p, torch.as_tensor(toks), cfg, 16)
    close(got, want)
    assert cache.keys() == want_cache.keys()
    for key in want_cache:
        close(cache[key], want_cache[key])


def test_decode_steps(pair):
    ref_cfg, cfg, ref_p, p = pair
    toks = tokens(cfg, (2, 5 + DECODE_STEPS))
    _, ref_cache = ref_prefill(ref_p, jnp.asarray(toks[:, :5]), ref_cfg, 16)
    _, cache = tf.prefill(p, torch.as_tensor(toks[:, :5]), cfg, 16)
    for pos in range(5, 5 + DECODE_STEPS):
        want, ref_cache = ref_decode_step(ref_p, ref_cache, jnp.asarray(toks[:, pos]), pos,
                                             ref_cfg)
        got, cache = tf.decode_step(p, cache, torch.as_tensor(toks[:, pos]), pos, cfg)
        close(got, want)
    for key in ref_cache:
        close(cache[key], ref_cache[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone: decoding position t after a prefill of t tokens gives
    ``forward``'s logits at t (the reference's test, on the port)."""
    cfg = registry.arch_config(arch, smoke=True)
    p = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(tokens(cfg, (2, 10), seed=2))
    full, _ = tf.forward(p, toks, cfg)
    _, cache = tf.prefill(p, toks[:, :9], cfg, max_len=12)
    logits, _ = tf.decode_step(p, cache, toks[:, 9], 9, cfg)
    torch.testing.assert_close(logits, full[:, 9], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b"], ids=["gqa", "mla"])
def test_bfloat16_forward_and_decode(arch):
    ref_cfg, cfg = configs(arch, dtype="bfloat16", param_dtype="bfloat16")
    ref_p, p = both_params(ref_cfg, cfg)
    assert p["embed"].dtype == torch.bfloat16
    toks = tokens(cfg, (2, 9))
    want, _ = ref_forward(ref_p, jnp.asarray(toks), ref_cfg)
    got, _ = tf.forward(p, torch.as_tensor(toks), cfg)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16_TOL)
    _, ref_cache = ref_prefill(ref_p, jnp.asarray(toks[:, :8]), ref_cfg, 9)
    _, cache = tf.prefill(p, torch.as_tensor(toks[:, :8]), cfg, 9)
    want, _ = ref_decode_step(ref_p, ref_cache, jnp.asarray(toks[:, 8]), 8, ref_cfg)
    got, _ = tf.decode_step(p, cache, torch.as_tensor(toks[:, 8]), 8, cfg)
    close(got, want, BF16_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """``forward(remat=True)`` recomputes each stacked layer in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    cfg = registry.arch_config(arch, smoke=True)
    toks = torch.as_tensor(tokens(cfg, (2, 8)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    grads = []
    for remat in (False, True):
        p = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        loss = tf.lm_loss(p, batch, cfg, remat=remat)
        loss.backward()
        grads.append((float(loss.detach()), [t.grad for t in leaves]))
    (loss0, g0), (loss1, g1) = grads
    assert loss0 == loss1
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(g0, g1))
    assert all(bool(g.abs().sum() > 0) for g in g0[:3])


# -- the layers ----------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_output_and_aux(arch):
    ref_cfg, cfg = configs(arch)
    ref_p, p = both_params(ref_cfg, cfg)
    ref_ffn = jax.tree.map(lambda a: a[0], ref_p["layers"]["ffn"])
    ffn = model.layer_views(p)[0]["ffn"]
    x = np.random.default_rng(3).standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_layers.moe_apply(ref_ffn, jnp.asarray(x), ref_cfg)
    got, aux = layers.moe_apply(ffn, torch.as_tensor(x), cfg)
    close(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_records_the_routed_experts(arch):
    """``layers.ROUTED`` gets, per call, the distinct experts of the
    reference's top-k choices."""
    ref_cfg, cfg = configs(arch)
    ref_p, p = both_params(ref_cfg, cfg)
    ref_ffn = jax.tree.map(lambda a: a[0], ref_p["layers"]["ffn"])
    x = np.random.default_rng(5).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model) @ ref_ffn["router"])
    want = np.unique(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])).size
    layers.ROUTED = routed = []
    try:
        layers.moe_apply(model.layer_views(p)[0]["ffn"], torch.as_tensor(x), cfg)
    finally:
        layers.ROUTED = None
    assert routed == [want]


def test_layer_views_are_the_stacked_layers():
    ref_cfg, cfg = configs("deepseek-v2-lite-16b")
    p = tf.init_params(cfg, device="cpu")
    views = model.layer_views(p)
    assert len(views) == cfg.n_layers - cfg.n_dense_prefix
    for i, view in enumerate(views):
        want = tree_leaves(tree_map(lambda t: t[i], p["layers"]))
        assert all(torch.equal(g, w) for g, w in zip(tree_leaves(view), want, strict=True))


def test_moe_apply_under_a_mesh_raises(monkeypatch):
    """Under a mesh ``moe_apply`` runs the expert-parallel form, never the
    dense dispatch: a mesh that is no process grid raises rather than
    falling back (``test_torch_distributed.py`` holds the form itself)."""
    ref_cfg, cfg = configs("granite-moe-1b-a400m")
    p = tf.init_params(cfg, device="cpu")
    ffn, x = model.layer_views(p)[0]["ffn"], torch.zeros(1, 2, cfg.d_model)
    with mesh_context(object()), pytest.raises(AttributeError):
        layers.moe_apply(ffn, x, cfg)
    monkeypatch.setattr(layers, "_moe_apply_ep", lambda *args: ("ep", args))
    with mesh_context(object()):
        assert layers.moe_apply(ffn, x, cfg) == ("ep", (ffn, x, cfg))


@pytest.mark.parametrize("kv_heads, bq, bk", [(2, 4, 8), (4, 8, 4), (1, 16, 16)])
def test_sdpa_chunked_matches_sdpa(kv_heads, bq, bk):
    rng = np.random.default_rng(kv_heads)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, kv_heads, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, kv_heads, 8)).astype(np.float32)
    scale = 8 ** -0.5
    mask = torch.tril(torch.ones(16, 16, dtype=torch.bool))
    q_t, k_t, v_t = map(torch.as_tensor, (q, k, v))
    got = layers._sdpa_chunked(q_t, k_t, v_t, scale, bq=bq, bk=bk)
    close(got, layers._sdpa(q_t, k_t, v_t, mask, scale))
    close(got, ref_layers._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                        bq=bq, bk=bk))


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; torch's default is erf."""
    ref_cfg, cfg = configs("gemma-2b")
    assert cfg.activation == "geglu"
    ref_p, p = both_params(ref_cfg, cfg)
    ref_ffn = jax.tree.map(lambda a: a[0], ref_p["layers"]["ffn"])
    ffn = model.layer_views(p)[0]["ffn"]
    x = 3 * np.random.default_rng(4).standard_normal((5, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_layers.glu_apply(ref_ffn, jnp.asarray(x), "geglu"))
    close(layers.glu_apply(ffn, torch.as_tensor(x), "geglu"), want)
    xt = torch.as_tensor(x)
    erf = (F.gelu(xt @ ffn["w_gate"]) * (xt @ ffn["w_up"])) @ ffn["w_down"]
    with pytest.raises(AssertionError):
        close(erf, want)


def test_scale_embeddings_rounds_sqrt_to_the_compute_dtype_first():
    """gemma-2b at its FULL width: sqrt(2048) = 45.2548 rounds to 45.25 in
    bfloat16 before the product, as in the reference."""
    ref_cfg, cfg = configs("gemma-2b", d_model=2048, vocab=32, dtype="bfloat16",
                           param_dtype="bfloat16")
    table = np.random.default_rng(5).standard_normal((32, 2048)).astype(np.float32)
    toks = np.arange(32, dtype=np.int32).reshape(4, 8)
    want = ref_model._embed({"embed": jnp.asarray(table, jnp.bfloat16)}, jnp.asarray(toks),
                            ref_cfg)
    embed = torch.as_tensor(table).to(torch.bfloat16)
    got = model._embed({"embed": embed}, torch.as_tensor(toks), cfg)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    unrounded = (embed[torch.as_tensor(toks)] * math.sqrt(2048)).float().numpy()
    assert not np.array_equal(unrounded, np.asarray(want, np.float32))


def test_norms_rope_and_cross_entropy():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)) + 3
    close(common.rope(torch.as_tensor(x), torch.as_tensor(pos), 500.0),
          ref_common.rope(jnp.asarray(x), jnp.asarray(pos), 500.0))
    h = rng.standard_normal((4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    close(common.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(h)),
          ref_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h)))
    close(common.layernorm({"scale": torch.as_tensor(scale), "bias": torch.as_tensor(bias)},
                           torch.as_tensor(h)),
          ref_common.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                               jnp.asarray(h)))
    assert torch.equal(common.rmsnorm_init(16)["scale"], torch.zeros(16))
    ln = common.layernorm_init(16)
    assert torch.equal(ln["scale"], torch.ones(16)) and torch.equal(ln["bias"], torch.zeros(16))
    logits = rng.standard_normal((3, 4, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 4)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 3] = 12                        # out of the vocabulary: gold logit 0
    want = ref_common.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    got = common.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels))
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


# -- the cache -------------------------------------------------------------------


def test_cache_write_past_its_end_raises_where_the_reference_clamps():
    """``dynamic_update_slice`` clamps a start past the end to the last
    slot; the port raises instead (ROADMAP §C, known differences)."""
    ref_cfg, cfg = configs("qwen1.5-0.5b")
    ref_p, p = both_params(ref_cfg, cfg)
    toks = tokens(cfg, (2, 4))
    _, ref_cache = ref_prefill(ref_p, jnp.asarray(toks), ref_cfg, 4)
    _, ref_after = ref_decode_step(ref_p, ref_cache, jnp.asarray(toks[:, 0]), 4, ref_cfg)
    assert not np.array_equal(np.asarray(ref_after["a"])[:, :, 3],
                              np.asarray(ref_cache["a"])[:, :, 3])   # slot 3 overwritten
    _, cache = tf.prefill(p, torch.as_tensor(toks), cfg, max_len=4)
    with pytest.raises(ValueError, match="does not fit"):
        tf.decode_step(p, cache, torch.as_tensor(toks[:, 0]), 4, cfg)
    with pytest.raises(ValueError, match="does not fit"):
        tf.prefill(p, torch.as_tensor(tokens(cfg, (2, 5))), cfg, max_len=4)


def test_decode_writes_the_cache_in_place():
    cfg = registry.arch_config("deepseek-v2-lite-16b", smoke=True)
    p = tf.init_params(cfg, device="cpu")
    toks = torch.as_tensor(tokens(cfg, (1, 3)))
    _, cache = tf.prefill(p, toks, cfg, max_len=4)
    before = {k: v.clone() for k, v in cache.items()}
    _, after = tf.decode_step(p, cache, toks[:, 0], 3, cfg)
    for key in cache:
        assert after[key] is cache[key]
        assert torch.equal(cache[key][:, :, :3], before[key][:, :, :3])
        assert not torch.equal(cache[key][:, :, 3], before[key][:, :, 3])


# -- weights, configs and data ---------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_the_full_configs(arch):
    """Counted from the configs alone: no full-width weights are built."""
    ref, port = ref_registry.arch_config(arch), registry.arch_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.compute_dtype == torch.bfloat16 and port.params_dtype == torch.bfloat16
    meta = tf.init_params(port, torch.Generator(), device="meta")
    n = sum(t.numel() for t in tree_leaves(meta))
    extra = port.n_layers * (port.n_heads + 2 * port.n_kv_heads) * port.head_dim * port.qkv_bias
    if port.attention == "mla":
        extra = port.n_layers * port.kv_lora_rank
    assert n - extra == port.param_count()       # biases and kv_norm are not in the count


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_equal_the_reference(arch):
    ref, port = ref_registry.arch_config(arch, smoke=True), registry.arch_config(arch, smoke=True)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.compute_dtype == torch.float32
    assert registry.RECSYS_ARCHS.keys() == ref_registry.RECSYS_ARCHS.keys()
    assert registry.arch_config("gcn-cora", smoke=True).arch == "gcn"     # the GNNs resolve too
    with pytest.raises(KeyError, match="unknown arch"):
        registry.arch_config("gcn")


def test_params_round_trip_and_wrong_shapes_are_refused():
    ref_cfg, cfg = configs("deepseek-v2-lite-16b")
    ref_p, p = both_params(ref_cfg, cfg)
    back = transformer_params_to_reference(p)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(ref_p)):
        assert np.array_equal(got, np.asarray(want))
    ref_np = jax.tree.map(np.asarray, ref_p)
    ref_np["layers"]["attn"]["wq"] = ref_np["layers"]["attn"]["wq"][:, :, 1:]
    with pytest.raises(ValueError, match="layers.attn.wq"):
        transformer_params_from_reference(ref_np, cfg, "cpu")
    with pytest.raises(ValueError, match="prefix"):
        transformer_params_from_reference({**jax.tree.map(np.asarray, ref_p), "prefix": []},
                                          cfg, "cpu")


def test_bfloat16_weights_cross_bit_for_bit():
    ref_cfg, cfg = configs("qwen2-7b", dtype="bfloat16", param_dtype="bfloat16")
    ref_p, p = both_params(ref_cfg, cfg)
    want = np.asarray(ref_p["layers"]["attn"]["wq"]).view(np.uint16)
    assert np.array_equal(p["layers"]["attn"]["wq"].view(torch.int16).numpy().view(np.uint16),
                          want)


@pytest.mark.parametrize("vocab, batch, seq, seed", [(256, 2, 16, 0), (1000, 3, 7, 5),
                                                     (152064, 4, 33, 1)])
def test_token_stream_batches_bit_for_bit(vocab, batch, seq, seed):
    port, ref = TokenStream(vocab, batch, seq, seed), RefTokenStream(vocab, batch, seq, seed)
    for step in (0, 1, 17):
        got, want = port.batch(step), ref.batch(step)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])
    assert port.state(3) == ref.state(3)
