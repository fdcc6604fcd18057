"""Transformer LM: init / forward / loss / prefill / decode.

The reference's stacked layout is kept so that its weights cross unchanged:
``params["layers"]`` holds each weight of the repeated layers with a
leading ``[n_stack]`` axis, and ``params["prefix"]`` is a list of the
leading dense layers (DeepSeek-V2-Lite's first).  The reference's
``lax.scan`` over the stack is a loop over that axis here.

Everything runs on CUDA unless ``device="cpu"`` is given to
``init_params``; the other functions run where the parameters are.  The
KV cache is written in place (``layers._write_cache``): ``decode_step``
returns a new dict holding the same tensors, now one entry longer.
"""

from __future__ import annotations

import math

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    new_generator, randn, rmsnorm, rmsnorm_init, softmax_xent,
)
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.layers import (
    _causal,
    _write_cache,
    glu_apply,
    glu_init,
    gqa_attention,
    gqa_init,
    mla_attention,
    mla_init,
    moe_apply,
    moe_init,
)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layer_init(generator: torch.Generator, cfg: TransformerConfig, moe_layer: bool,
                device=None):
    attn = (mla_init if cfg.attention == "mla" else gqa_init)(generator, cfg, device=device)
    if moe_layer:
        ffn = moe_init(generator, cfg, device=device)
    else:
        ffn = glu_init(generator, cfg.d_model, cfg.d_ff, cfg.params_dtype, device=device)
    return {
        "attn": attn,
        "ffn": ffn,
        "ln1": rmsnorm_init(cfg.d_model, cfg.params_dtype, device=device),
        "ln2": rmsnorm_init(cfg.d_model, cfg.params_dtype, device=device),
    }


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device=None):
    """Random weights in the reference's layout, drawn on ``device`` from
    ``generator`` (a fresh one on ``device`` seeded with 0 when None).
    ``device=None`` means CUDA; where CUDA is absent that raises (pass
    ``device="cpu"``).  The stacked layers are drawn one at a time into
    their slot of the stack, so a full-width model needs no second copy."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch's transformer runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU')
    if generator is None:
        generator = new_generator(device)
    dt = cfg.params_dtype
    params = {
        "embed": randn((cfg.vocab, cfg.d_model), generator, dt, device).mul_(0.02),
        "final_norm": rmsnorm_init(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = randn((cfg.d_model, cfg.vocab), generator, dt, device).mul_(0.02)
    if cfg.n_dense_prefix:
        params["prefix"] = [_layer_init(generator, cfg, moe_layer=False, device=device)
                            for _ in range(cfg.n_dense_prefix)]
    n_stack = cfg.n_layers - cfg.n_dense_prefix
    stack = None
    for i in range(n_stack):
        layer = _layer_init(generator, cfg, moe_layer=cfg.moe, device=device)
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((n_stack,) + tuple(t.shape)), layer)
        tree_map(lambda slot, t: slot[i].copy_(t), stack, layer)
        del layer
    params["layers"] = stack
    return params


def layer_views(params) -> list:
    """Views of every layer of the stack, one ``unbind`` per weight."""
    leaves, spec = tree_flatten(params["layers"])
    rows = [t.unbind(0) for t in leaves]
    return [tree_unflatten([r[i] for r in rows], spec) for i in range(len(rows[0]))]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _block(layer, x, positions, cfg: TransformerConfig, moe_layer: bool,
           kv_cache=None, cache_len=None, mask=None):
    attn_fn = mla_attention if cfg.attention == "mla" else gqa_attention
    h, new_kv = attn_fn(layer["attn"], rmsnorm(layer["ln1"], x), positions, cfg,
                        kv_cache=kv_cache, cache_len=cache_len, mask=mask)
    x = x + h
    y = rmsnorm(layer["ln2"], x)
    if moe_layer:
        f, aux = moe_apply(layer["ffn"], y, cfg)
    else:
        f, aux = glu_apply(layer["ffn"], y, cfg.activation), 0.0
    return x + f, new_kv, aux


def _embed(params, tokens, cfg: TransformerConfig):
    x = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.scale_embeddings:
        # sqrt(d_model) in float32, rounded to the compute dtype before the product
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32, device=x.device)
        x = x * scale.to(cfg.compute_dtype)
    return x


def _unembed(params, x, cfg: TransformerConfig):
    x = rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cfg.compute_dtype).T
    return x @ params["unembed"].to(cfg.compute_dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def forward(params, tokens, cfg: TransformerConfig, remat: bool = False):
    """tokens int[B,S] → (logits [B,S,V], MoE aux loss)."""
    b, s = tokens.shape
    device = params["embed"].device
    positions = _positions(b, s, device)
    x = _embed(params, tokens, cfg)

    for layer in params.get("prefix", []):
        x, _, _ = _block(layer, x, positions, cfg, moe_layer=False)

    def body(x, layer):
        x, _, a = _block(layer, x, positions, cfg, moe_layer=cfg.moe)
        return x, a

    aux = torch.zeros((), dtype=torch.float32, device=device)
    for layer in layer_views(params):
        if remat:
            x, a = checkpoint(body, x, layer, use_reentrant=False)
        else:
            x, a = body(x, layer)
        aux = aux + a
    return _unembed(params, x, cfg), aux


def lm_loss(params, batch, cfg: TransformerConfig, remat: bool = False):
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    return softmax_xent(logits, batch["labels"]) + aux


# --------------------------------------------------------------------------
# serving: prefill + decode with a stacked KV cache
# --------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    """Zeroed caches: ``a``/``b`` with a leading ``[n_stack]`` axis (GQA: k
    and v ``[B,T,KV,D]``; MLA: the latent ``[B,T,r]`` and rope key
    ``[B,T,dr]``), and ``prefix_a``/``prefix_b`` for the dense prefix.
    ``device=None`` means CUDA."""
    dtype = dtype or cfg.compute_dtype
    device = torch.device("cuda" if device is None else device)
    n_stack = cfg.n_layers - cfg.n_dense_prefix
    if cfg.attention == "mla":
        shape_a = (batch, max_len, cfg.kv_lora_rank)
        shape_b = (batch, max_len, cfg.qk_rope_head_dim)
    else:
        shape_a = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shape_b = shape_a
    cache = {
        "a": torch.zeros((n_stack,) + shape_a, dtype=dtype, device=device),
        "b": torch.zeros((n_stack,) + shape_b, dtype=dtype, device=device),
    }
    if cfg.n_dense_prefix:
        cache["prefix_a"] = torch.zeros((cfg.n_dense_prefix,) + shape_a, dtype=dtype,
                                        device=device)
        cache["prefix_b"] = torch.zeros((cfg.n_dense_prefix,) + shape_b, dtype=dtype,
                                        device=device)
    return cache


def prefill(params, tokens, cfg: TransformerConfig, max_len: int):
    """Full-sequence forward that also fills the KV cache's first S entries.
    Returns (last position's logits [B,V], cache)."""
    b, s = tokens.shape
    device = params["embed"].device
    positions = _positions(b, s, device)
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, b, max_len, device=device)

    for i, layer in enumerate(params.get("prefix", [])):
        x, kv, _ = _block(layer, x, positions, cfg, moe_layer=False)
        _write_cache(cache["prefix_a"][i], kv[0], 0)
        _write_cache(cache["prefix_b"][i], kv[1], 0)

    for i, layer in enumerate(layer_views(params)):
        x, kv, _ = _block(layer, x, positions, cfg, moe_layer=cfg.moe)
        _write_cache(cache["a"][i], kv[0], 0)
        _write_cache(cache["b"][i], kv[1], 0)
    logits = _unembed(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, cache, tokens, cache_len: int, cfg: TransformerConfig):
    """One decode step.  tokens int[B]; ``cache_len``: the filled prefix
    length, a host integer.

    Returns (logits [B,V], cache with the step's entries written at
    ``cache_len``).  GQA caches (k, v); MLA caches the compressed latent
    (c_kv, k_rope) and attends in the latent space (absorbed)."""
    b = tokens.shape[0]
    cache_len = int(cache_len)
    device = params["embed"].device
    positions = torch.full((b, 1), cache_len, dtype=torch.int32, device=device)
    mask = _causal(1, cache["a"].shape[2], cache_len, device)   # one for every layer
    x = _embed(params, tokens[:, None], cfg)

    for i, layer in enumerate(params.get("prefix", [])):
        kv = (cache["prefix_a"][i], cache["prefix_b"][i])
        x, _, _ = _block(layer, x, positions, cfg, moe_layer=False,
                         kv_cache=kv, cache_len=cache_len, mask=mask)

    for i, layer in enumerate(layer_views(params)):
        kv = (cache["a"][i], cache["b"][i])
        x, _, _ = _block(layer, x, positions, cfg, moe_layer=cfg.moe,
                         kv_cache=kv, cache_len=cache_len, mask=mask)
    logits = _unembed(params, x, cfg)
    return logits[:, 0], dict(cache)
