"""Shared building blocks as dicts of tensors: dense layers, MLPs, norms,
rotary embeddings and the token cross-entropy.

Weights keep the reference's layout, ``[d_in, d_out]`` used as ``x @ w``,
so parameters cross from the reference unchanged.  Random draws come from
an explicit ``torch.Generator``, never the global one.
"""

from __future__ import annotations

import math

import torch


def new_generator(device, seed: int = 0) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed`` (on the CPU for
    ``meta``, where nothing is drawn: see ``randn``)."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


def randn(shape, generator: torch.Generator, dtype: torch.dtype = torch.float32,
          device=None) -> torch.Tensor:
    """Standard normal draws from ``generator``; on ``meta`` the shape alone
    (the registry's cells take their arguments as meta tensors)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def dense_init(
    generator: torch.Generator,
    d_in: int,
    d_out: int,
    dtype: torch.dtype = torch.float32,
    scale: float | None = None,
    device=None,
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = randn((d_in, d_out), generator, dtype, device)
    return w.mul_(scale)


def mlp_init(
    generator: torch.Generator,
    dims: tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    bias: bool = True,
    device=None,
) -> dict[str, torch.Tensor]:
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = dense_init(generator, a, b, dtype, device=device)
        if bias:
            params[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=device)
    return params


def mlp_apply(params, x: torch.Tensor, act=torch.relu, final_act: bool = False):
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"]
        if f"b{i}" in params:
            x = x + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def layernorm_init(d: int, dtype: torch.dtype = torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}   # gemma's (1 + w)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + params["scale"].float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split.  x: [..., S, H, D]; positions: [..., S]."""
    half = x.shape[-1] // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., :, None, None].float() * freqs            # [..., S, 1, half]
    cos, sin = angles.cos(), angles.sin()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32 over the labels that are not
    ``ignore``.  A label outside ``[0, V)`` has gold logit 0, as the
    reference's one-hot contraction gives it."""
    logits = logits.float()
    vocab = logits.shape[-1]
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    in_range = (labels >= 0) & (labels < vocab)
    gold = logits.gather(-1, labels.clamp(0, vocab - 1)[..., None])[..., 0]
    gold = torch.where(in_range, gold, 0.0)
    mask = (labels != ignore).float()
    loss = (logz - gold) * mask
    return loss.sum() / mask.sum().clamp_min(1.0)
