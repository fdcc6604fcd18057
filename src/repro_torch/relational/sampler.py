"""Fanout neighbor sampling for minibatched GNN training (``minibatch_lg``).

Builds CSR from an edge list, then per layer uniformly samples ``fanout``
in-neighbors per frontier node, with replacement.  Output subgraphs have
static shapes with -1 sentinels and an edge mask.  The CSR lives on the
sampler's device (CUDA unless ``device="cpu"``) and every draw comes from an
explicit ``torch.Generator`` on that device.

``sample_layer`` takes the draws ``u`` as an argument, so a caller can hand
it any integers in ``[0, 2^31 - 1)``: JAX's ``jax.random`` draws cannot be
reproduced by a ``torch.Generator``, and given the same draws the blocks are
the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """CSR over incoming edges: for node v, neighbors(v) = sources of v's in-edges."""
    order = np.argsort(dst, kind="stable")
    col = np.asarray(src)[order].astype(np.int32)
    counts = np.bincount(np.asarray(dst), minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, col


class SampledBlock(NamedTuple):
    """One sampled bipartite layer: frontier nodes ← sampled neighbors."""

    src: torch.Tensor        # int32[n_dst * fanout]  (global ids, -1 pad)
    dst: torch.Tensor        # int32[n_dst * fanout]  (position in frontier)
    nodes: torch.Tensor      # int32[n_dst]           frontier global ids
    mask: torch.Tensor       # bool[n_dst * fanout]


class NeighborSampler:
    """GraphSAGE-style layered uniform sampler over a static CSR."""

    def __init__(self, row_ptr, col, fanouts: tuple[int, ...], device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch's NeighborSampler runs on CUDA by default and no CUDA device "
                'is available; pass device="cpu" to run on the CPU')
        self.row_ptr = torch.as_tensor(np.asarray(row_ptr), device=self.device).long()
        self.col = torch.as_tensor(np.asarray(col), device=self.device).int()
        self.fanouts = tuple(fanouts)

    def draws(self, generator: torch.Generator, n: int, fanout: int) -> torch.Tensor:
        """int32[n, fanout] uniform in ``[0, 2^31 - 1)``, as the reference's
        ``jax.random.randint(key, (n, fanout), 0, iinfo(int32).max)``."""
        return torch.randint(0, INT32_MAX, (n, fanout), generator=generator,
                             dtype=torch.int32, device=self.device)

    def sample_layer(self, frontier: torch.Tensor, fanout: int, u: torch.Tensor) -> SampledBlock:
        """One layer from the draws ``u`` (int32[len(frontier), fanout])."""
        n = frontier.shape[0]
        f = frontier.long()
        start = self.row_ptr[f]
        deg = self.row_ptr[f + 1] - start
        has = deg > 0
        # uniform-with-replacement sample of `fanout` in-neighbors
        pick = torch.where(has[:, None], u.long() % deg.clamp_min(1)[:, None], 0)
        idx = (start[:, None] + pick).clamp(0, max(self.col.shape[0] - 1, 0))
        mask = has[:, None].expand(n, fanout)
        if self.col.numel():
            src = torch.where(mask, self.col[idx], -1)
        else:
            src = torch.full((n, fanout), -1, dtype=torch.int32, device=self.device)
        dst = torch.arange(n, dtype=torch.int32, device=self.device)[:, None].expand(n, fanout)
        return SampledBlock(src=src.reshape(-1).int(), dst=dst.reshape(-1),
                            nodes=frontier, mask=mask.reshape(-1))

    def sample(self, generator: torch.Generator, seeds) -> list[SampledBlock]:
        """Sample L layers outward from seed nodes; returns innermost-first."""
        blocks: list[SampledBlock] = []
        frontier = torch.as_tensor(seeds, device=self.device)
        for fanout in self.fanouts:
            block = self.sample_layer(frontier, fanout,
                                      self.draws(generator, frontier.shape[0], fanout))
            blocks.append(block)
            # next frontier: the sampled sources (pad -1 → 0, masked later)
            frontier = torch.where(block.mask, block.src, 0)
        return blocks
