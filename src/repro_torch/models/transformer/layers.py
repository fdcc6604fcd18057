"""Attention (GQA/MQA + MLA) and FFN (dense GLU + MoE) layers.

The reference's numerics are kept: attention scores in float32, masked with
``NEG_INF``, softmax probabilities cast to the values' dtype before the PV
product; GELU is the tanh approximation (``jax.nn.gelu``'s default); the MoE
router runs in float32.

A KV cache is written in place: ``_write_cache`` copies the new entries into
the cache's tensors and raises where the entries do not fit, where the
reference's ``dynamic_update_slice`` would clamp the start index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.distributed.collectives import grad_psum, pmean, psum
from repro_torch.distributed.context import get_data_group, get_dp_axes, get_mesh
from repro_torch.distributed.mesh import axes_group, axis_index, axis_size
from repro_torch.models.common import dense_init, rmsnorm, rmsnorm_init, rope
from repro_torch.models.transformer.config import TransformerConfig

NEG_INF = -1e30

# When a list, ``moe_apply`` appends to it the number of experts each call
# routed to, read from the group sizes it already holds on the host.  Under
# ``forward(remat=True)`` the backward pass recomputes each layer, reading its
# group sizes again: the layers' counts then follow once more, last layer first.
ROUTED: list[int] | None = None


def _write_cache(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """Copy ``new`` into ``buf`` along axis 1 from ``start``, in place."""
    start, s, t = int(start), new.shape[1], buf.shape[1]
    if start < 0 or start + s > t:
        raise ValueError(f"cache write of {s} entries at {start} does not fit a cache of {t}")
    buf[:, start:start + s] = new


def _causal(s: int, t: int, qpos, device) -> torch.Tensor:
    """``[s, t]`` mask: key position ≤ query position ``qpos + i``.  A
    decode step builds it once (``model.decode_step``) and passes it to
    every layer as ``mask``."""
    query = qpos + torch.arange(s, device=device)
    return torch.arange(t, device=device)[None, :] <= query[:, None]


def _act(activation: str):
    if activation == "swiglu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------


def gqa_init(generator: torch.Generator, cfg: TransformerConfig, device=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.params_dtype
    p = {
        "wq": dense_init(generator, d, h * hd, dt, device=device),
        "wk": dense_init(generator, d, kv * hd, dt, device=device),
        "wv": dense_init(generator, d, kv * hd, dt, device=device),
        "wo": dense_init(generator, h * hd, d, dt, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    return p


def _qkv(p, x, cfg: TransformerConfig):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)


def _sdpa(q, k, v, mask, scale):
    """q: [B,S,H,D], k/v: [B,T,KV,D] (KV divides H).  f32 softmax."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


CHUNK_THRESHOLD = 8192   # switch to online-softmax attention above this S
BQ, BK = 512, 1024       # query/key block sizes (f32 score block ≤ B·H·BQ·BK)


def _sdpa_chunked(q, k, v, scale, bq: int = BQ, bk: int = BK):
    """Causal attention by the online-softmax recurrence over key blocks.

    The reference's double ``lax.scan`` as two loops over (query blocks ×
    key blocks) carrying the running (max, denominator, accumulator) in
    float32, so the ``S × T`` score matrix never materialises.  Fully masked
    key blocks still run, as the reference's do."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    bq = bq if s % bq == 0 and s >= bq else s
    bk = bk if t % bk == 0 and t >= bk else t
    nq, nk = s // bq, t // bk
    dv = v.shape[-1]

    qb = q.reshape(b, nq, bq, kvh, g, d).permute(1, 0, 3, 4, 2, 5)    # [nq,b,kv,g,bq,d]
    kb = k.reshape(b, nk, bk, kvh, d).permute(1, 0, 3, 2, 4)          # [nk,b,kv,bk,d]
    vb = v.reshape(b, nk, bk, kvh, dv).permute(1, 0, 3, 2, 4)
    q_pos = torch.arange(bq, device=q.device)
    k_pos = torch.arange(bk, device=q.device)

    outs = []
    for qi in range(nq):
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, bq, dv), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            scores = torch.einsum("bkgqd,bktd->bkgqt", qb[qi], kb[ki]).float() * scale
            causal = (qi * bq + q_pos)[:, None] >= (ki * bk + k_pos)[None, :]
            scores = torch.where(causal, scores, NEG_INF)
            new_m = torch.maximum(m, scores.amax(dim=-1))
            safe_m = torch.where(new_m > NEG_INF / 2, new_m, 0.0)
            p = torch.exp(scores - safe_m[..., None])
            p = torch.where(causal, p, 0.0)
            corr = torch.exp(torch.where(m > NEG_INF / 2, m - safe_m, NEG_INF))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,bktd->bkgqd", p, vb[ki].float())
            m = new_m
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, dv)
    return out.to(q.dtype)


def gqa_attention(p, x, positions, cfg: TransformerConfig, kv_cache=None, cache_len=None,
                  mask=None):
    """Returns (out, new_kv).  ``kv_cache`` = (k, v) buffers ``[B,T,KV,D]``
    for decode, written in place from ``cache_len``; ``mask``, the cache's
    ``[S,T]`` causal mask, is built here when None."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5

    if kv_cache is None:
        if s >= CHUNK_THRESHOLD:
            out = _sdpa_chunked(q, k, v, scale)
        else:
            out = _sdpa(q, k, v, _causal(s, s, 0, x.device), scale)
        return out.reshape(b, s, -1) @ p["wo"], (k, v)

    ck, cv = kv_cache
    _write_cache(ck, k, cache_len)
    _write_cache(cv, v, cache_len)
    if mask is None:
        qpos = positions[0] if positions.dim() else positions
        mask = _causal(s, ck.shape[1], qpos, x.device)
    out = _sdpa(q, ck, cv, mask, scale)
    return out.reshape(b, s, -1) @ p["wo"], (ck, cv)


# --------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# --------------------------------------------------------------------------


def mla_init(generator: torch.Generator, cfg: TransformerConfig, device=None):
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.params_dtype
    return {
        "wq": dense_init(generator, d, h * (dn + dr), dt, device=device),
        "w_dkv": dense_init(generator, d, r + dr, dt, device=device),  # joint compress + rope key
        "w_uk": dense_init(generator, r, h * dn, dt, device=device),
        "w_uv": dense_init(generator, r, h * dv, dt, device=device),
        "wo": dense_init(generator, h * dv, d, dt, device=device),
        "kv_norm": rmsnorm_init(r, dt, device=device),
    }


def mla_attention(p, x, positions, cfg: TransformerConfig, kv_cache=None, cache_len=None,
                  mask=None):
    """MLA with a compressed-KV cache.  Prefill expands per-head keys and
    values; decode uses the *absorbed* form (W_uk folded into the query,
    attention in the latent space) against the latent cache ``(c_kv,
    k_rope)``, ``[B,T,r]`` and ``[B,T,dr]``, so a step costs O(T·r), not
    O(T·H·dn)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5

    q = (x @ p["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv = x @ p["w_dkv"]                                  # [B,S,r+dr]
    c_kv, k_rope = ckv[..., :r], ckv[..., r:]
    c_kv = rmsnorm(p["kv_norm"], c_kv)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if kv_cache is None:
        k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
        v = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        if s >= CHUNK_THRESHOLD:
            out = _sdpa_chunked(qf, k, v, scale)
        else:
            out = _sdpa(qf, k, v, _causal(s, s, 0, x.device), scale)
        return out.reshape(b, s, -1) @ p["wo"], (c_kv, k_rope)

    cc, cr = kv_cache
    _write_cache(cc, c_kv, cache_len)
    _write_cache(cr, k_rope, cache_len)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["w_uk"].reshape(r, h, dn))
    scores = (
        torch.einsum("bshr,btr->bhst", q_lat, cc) + torch.einsum("bshd,btd->bhst", q_rope, cr)
    ).float() * scale
    if mask is None:
        qpos = positions[0] if positions.dim() else positions
        mask = _causal(s, cc.shape[1], qpos, x.device)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, cc)   # attend in the latent space
    out = torch.einsum("bshr,rhd->bshd", out_lat, p["w_uv"].reshape(r, h, dv))
    return out.reshape(b, s, -1) @ p["wo"], (cc, cr)


# --------------------------------------------------------------------------
# FFN: GLU + MoE (sort dispatch + one product per expert segment)
# --------------------------------------------------------------------------


def glu_init(generator: torch.Generator, d: int, d_ff: int, dtype, device=None):
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype, device=device),
        "w_up": dense_init(generator, d, d_ff, dtype, device=device),
        "w_down": dense_init(generator, d_ff, d, dtype, device=device),
    }


def glu_apply(p, x, activation: str):
    return (_act(activation)(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def moe_init(generator: torch.Generator, cfg: TransformerConfig, device=None):
    d, e, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.params_dtype
    p = {
        "router": dense_init(generator, d, e, torch.float32, device=device),
        "w_gate": dense_init(generator, d, e * dff, dt, device=device).reshape(e, d, dff),
        "w_up": dense_init(generator, d, e * dff, dt, device=device).reshape(e, d, dff),
        "w_down": dense_init(generator, e * dff, d, dt, device=device).reshape(e, dff, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = glu_init(generator, d, cfg.d_ff_expert * cfg.n_shared_experts, dt,
                               device=device)
    return p


def _grouped_matmul(xs, w, sizes: list[int]):
    """``jax.lax.ragged_dot``: rows of ``xs`` in contiguous groups of
    ``sizes``, group ``i`` times ``w[i]``."""
    parts, start = [], 0
    for i, n in enumerate(sizes):
        if n:
            parts.append(xs[start:start + n] @ w[i])
            start += n
    return torch.cat(parts) if parts else xs.new_empty((0, w.shape[-1]))


def _host_sizes(group_sizes: torch.Tensor, rows: int, groups: int) -> list[int]:
    """The first ``groups`` segment sizes, read on the host.  A fake tensor
    (a shapes-only trace, ``launch/dryrun.py``) has no values: its ``rows``
    (T·k) are split evenly over the ``groups``, the reference's static
    ``ragged_dot`` shapes, so memory and FLOPs bound the real step's."""
    if is_fake(group_sizes):
        return [rows // groups + (i < rows % groups) for i in range(groups)]
    return group_sizes.tolist()[:groups]


def moe_apply(p, x, cfg: TransformerConfig):
    """Token-choice top-k MoE by sort dispatch (MegaBlocks-style).

    A stable sort of the (token, expert) pairs by expert makes each expert's
    rows contiguous; one product per expert segment and projection; the
    rows go back to their tokens weighted by the router's renormalised
    probabilities.  Reading the segment sizes costs one host
    synchronisation.  Returns (out, Switch-style load-balance aux loss).

    Under an active mesh (``distributed.mesh_context``) the explicit
    expert-parallel form runs instead (``_moe_apply_ep``).  Inside the
    sharded train step (``distributed.context.data_group``) each rank holds
    a data block of the batch, and the aux loss takes the expert densities
    and router means of the whole batch, as the reference's GSPMD step."""
    if get_mesh() is not None and cfg.n_experts > 1:
        return _moe_apply_ep(p, x, cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, d)
    t = xt.shape[0]

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)               # [T,k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_i.reshape(-1)                                 # [T*k]
    order = torch.argsort(flat_e, stable=True)
    xs = xt[order // k]                                        # [T*k, d] sorted by expert
    # bincount(length=e), counted by index_add_: torch.bincount reads the ids'
    # min and max on the host, two more synchronisations on the card
    group_sizes = torch.zeros(e, dtype=flat_e.dtype, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    sizes = _host_sizes(group_sizes, t * k, e)
    if ROUTED is not None:
        ROUTED.append(sum(1 for n in sizes if n))

    act = _act(cfg.activation)
    h = act(_grouped_matmul(xs, p["w_gate"], sizes)) * _grouped_matmul(xs, p["w_up"], sizes)
    ys = _grouped_matmul(h, p["w_down"], sizes)                # [T*k, d]

    # back to (token, choice) order: each token's k rows summed
    w = top_p.reshape(-1)[order].to(ys.dtype)
    weighted = torch.empty_like(ys)
    weighted[order] = ys * w[:, None]
    out = weighted.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        out = out + glu_apply(p["shared"], xt, cfg.activation)

    density = group_sizes.float() / (t * k)                   # mean of the one-hot choices
    router_mean = probs.mean(0)
    group = get_data_group()
    if group is not None:
        density, router_mean = pmean(density, group), pmean(router_mean, group)
    aux = cfg.router_aux_coef * e * torch.sum(density * router_mean) * k
    if group is not None:
        # the same aux on every data rank, added to each rank's own loss: the
        # data-parallel mean of those losses hands each copy 1/n of its cotangent
        aux = grad_psum(aux, group)
    return out.reshape(b, s, d), aux


def _moe_apply_ep(p, x, cfg: TransformerConfig):
    """Explicit expert-parallel MoE: experts sharded over ``model``; each
    rank computes ONLY its local experts' contributions to its data block
    of the tokens (replicated over ``model``), then one psum over ``model``
    in the compute dtype combines them.

    ``w_gate``/``w_up``/``w_down`` are this rank's ``e // tp`` experts when
    ``distributed.place`` cut them, or the whole stack, which is narrowed
    here.  Assignments to other ranks' experts go to a drop bin of weight
    zero.  The aux loss is this rank's, ``pmean``-ed over ``model`` and then
    over the last DP axis only, as the reference's: at dp > 1 that mean of
    per-block products differs from the dense form's global aux."""
    mesh, dp = get_mesh(), get_dp_axes()
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tp = axis_size(mesh, "model")
    if e % tp:
        raise ValueError(f"expert parallelism: {e} experts do not split over {tp} ranks")
    e_loc = e // tp
    lo = axis_index(mesh, "model") * e_loc
    model = axes_group(mesh, "model")
    experts = [p[w] if p[w].shape[0] == e_loc else p[w].narrow(0, lo, e_loc)
               for w in ("w_gate", "w_up", "w_down")]
    # the tokens and the router are the same on every model rank, and each
    # rank uses them for its own experts only: their gradients sum over model
    xt = grad_psum(x, model).reshape(-1, d)
    router = grad_psum(p["router"], model)
    t = xt.shape[0]

    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    local_e = top_i - lo
    mine = (local_e >= 0) & (local_e < e_loc)
    flat_e = torch.where(mine, local_e, e_loc).reshape(-1)    # e_loc = drop bin
    order = torch.argsort(flat_e, stable=True)
    group_sizes = torch.zeros(e_loc + 1, dtype=flat_e.dtype, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    sizes = _host_sizes(group_sizes, t * k, e_loc)
    if ROUTED is not None:
        ROUTED.append(sum(1 for n in sizes if n))
    kept = order[:sum(sizes)]                                  # the drop bin sorts last

    act = _act(cfg.activation)
    xs = xt[kept // k]
    h = act(_grouped_matmul(xs, experts[0], sizes)) * _grouped_matmul(xs, experts[1], sizes)
    ys = _grouped_matmul(h, experts[2], sizes)

    w = top_p.reshape(-1)[kept].to(ys.dtype)
    weighted = ys.new_zeros((t * k, d))
    weighted[kept] = ys * w[:, None]
    out = psum(weighted.reshape(t, k, d).sum(dim=1), model)   # the ONE combine

    density = torch.zeros(e, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
    aux_l = cfg.router_aux_coef * e * torch.sum(density * probs.mean(0)) * k
    data = axes_group(mesh, dp[-1])
    # replicated over the last DP axis; each data rank adds it to its own loss
    aux = grad_psum(pmean(pmean(aux_l, model), data), data)

    if cfg.n_shared_experts:
        out = out + glu_apply(p["shared"], x.reshape(-1, d), cfg.activation)
    return out.reshape(b, s, d), aux
