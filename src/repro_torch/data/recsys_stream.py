"""Synthetic recsys click stream: Zipf item popularity + logQ statistics.

numpy only; for the same arguments, seed and step its batches are byte for
byte those of ``repro.data.recsys_stream``.
"""

from __future__ import annotations

import numpy as np


class RecsysStream:
    def __init__(
        self,
        user_vocab: int,
        item_vocab: int,
        user_fields: int,
        item_fields: int,
        field_hots: int,
        n_dense: int,
        batch: int,
        seed: int = 0,
    ):
        self.uv, self.iv = user_vocab, item_vocab
        self.uf, self.if_, self.k = user_fields, item_fields, field_hots
        self.nd = n_dense
        self.batch_size = batch
        self.seed = seed
        ranks = np.arange(1, item_vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.item_p = p / p.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b = self.batch_size
        user_ids = rng.integers(
            0, self.uv, size=(b, self.uf, self.k), dtype=np.int64
        ).astype(np.int32)
        # sparsify bags: drop ~¼ of slots
        drop = rng.random((b, self.uf, self.k)) < 0.25
        user_ids = np.where(drop, -1, user_ids)
        item_flat = rng.choice(self.iv, size=b * self.if_ * self.k, p=self.item_p)
        item_ids = item_flat.reshape(b, self.if_, self.k).astype(np.int32)
        user_dense = rng.standard_normal((b, self.nd)).astype(np.float32)
        # logQ of the positive item (first id of field 0)
        log_q = np.log(self.item_p[item_ids[:, 0, 0]]).astype(np.float32)
        return {
            "user_ids": user_ids,
            "item_ids": item_ids,
            "user_dense": user_dense,
            "log_q": log_q,
        }
