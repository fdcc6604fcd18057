"""Synthetic LM token stream: Zipf-distributed tokens, deterministic,
checkpointable via an explicit step cursor (fault-tolerant data pipeline).

numpy only; for the same arguments, seed and step its batches are byte for
byte those of ``repro.data.tokens``."""

from __future__ import annotations

import numpy as np


class TokenStream:
    """Infinite deterministic batch stream.

    ``batch(step)`` is a pure function of (seed, step): any worker can
    resume from a checkpointed step with no data loss or duplication —
    the data-pipeline half of checkpoint/restart fault tolerance.
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch_size = batch
        self.seq_len = seq_len
        self.seed = seed
        # Zipf-ish ranks for realistic token frequencies
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(
            self.vocab, size=(self.batch_size, self.seq_len + 1), p=self.probs
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step}
