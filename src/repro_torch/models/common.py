"""Shared building blocks: dense layers and MLPs as dicts of tensors.

Weights keep the reference's layout, ``[d_in, d_out]`` used as ``x @ w``,
so parameters cross from the reference unchanged.  Random draws come from
an explicit ``torch.Generator``, never the global one.
"""

from __future__ import annotations

import math

import torch


def dense_init(
    generator: torch.Generator,
    d_in: int,
    d_out: int,
    dtype: torch.dtype = torch.float32,
    scale: float | None = None,
    device=None,
) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype, device=device)
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
