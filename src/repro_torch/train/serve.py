"""Serving: prefill + batched decode with temperature sampling.

``generate`` is the host driver (prefill once, decode N steps) on the
device that holds the parameters.  ``BatchedServer`` keeps a fixed decode
batch and drains a request queue in groups (continuous-batching-lite).

Sampling draws from a ``torch.Generator`` seeded by ``seed``: JAX's draws
cannot be reproduced, so only greedy decoding (``temperature=0``) equals
the reference's tokens.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.models.transformer import TransformerConfig, decode_step, prefill


def sample_token(generator: torch.Generator, logits: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(
    params,
    prompt,
    cfg: TransformerConfig,
    *,
    steps: int = 32,
    max_len: int | None = None,
    temperature: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """prompt int[B, S] → int32[B, steps] sampled continuations, on the
    parameters' device."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    max_len = max_len or (s + steps)
    generator = torch.Generator(device=device).manual_seed(seed)
    logits, cache = prefill(params, prompt, cfg, max_len)
    tok = sample_token(generator, logits, temperature)
    out = [tok]
    pos = s
    for _ in range(steps - 1):
        logits, cache = decode_step(params, cache, tok, pos, cfg)
        tok = sample_token(generator, logits, temperature)
        out.append(tok)
        pos += 1
    return torch.stack(out, dim=1)


class BatchedServer:
    """Fixed-batch decode server with slot refill (continuous-batching-lite)."""

    def __init__(self, params, cfg: TransformerConfig, batch: int, max_len: int):
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.queue: deque = deque()
        self.done: dict[int, list[int]] = {}
        self._next_id = 0

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"a prompt is a 1-D token array, got shape {prompt.shape}")
        if len(prompt) and (prompt.min() < 0 or prompt.max() >= self.cfg.vocab):
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab})")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, max_new))
        return rid

    def run(self, seed: int = 0) -> dict[int, list[int]]:
        """Drain the queue in groups of ``batch``, each left-padded with
        token 0 to its longest prompt (no padding mask; positions start at 0,
        as in the reference)."""
        # the reference draws each group's seed from one key it never splits,
        # so every group gets the same seed
        generator = torch.Generator().manual_seed(seed)
        group_seed = int(torch.randint(0, 1 << 30, (), generator=generator))
        while self.queue:
            group = [self.queue.popleft() for _ in range(min(self.batch, len(self.queue)))]
            max_prompt = max(len(p) for _, p, _ in group)
            max_new = max(n for _, _, n in group)
            toks = np.zeros((len(group), max_prompt), np.int32)
            for i, (_, p, _) in enumerate(group):
                toks[i, max_prompt - len(p):] = p       # left-pad
            outs = generate(self.params, toks, self.cfg, steps=max_new,
                            max_len=max_prompt + max_new, seed=group_seed)
            outs = outs.cpu().numpy()
            for i, (rid, _, n) in enumerate(group):
                self.done[rid] = outs[i, :n].tolist()
        return self.done
