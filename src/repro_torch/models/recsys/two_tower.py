"""Two-tower retrieval (Yi et al., RecSys'19 / Covington, RecSys'16): serving.

Huge sparse embedding tables → EmbeddingBag (the relational hot path: on a
CUDA device each bag is one launch of the hand-written gather-sum kernel)
→ per-tower MLP 1024-512-256 → normalized dot interaction.
``retrieval_scores`` scores one query batch against a pre-embedded candidate
corpus as one batched GEMM + top-k.

The module serves only: its parameters do not require gradients and the
gather-sum kernel has no backward.  Training (the sampled-softmax loss
step) and the vocab-sharded forms wait for later slices (ROADMAP A11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.common import mlp_apply, mlp_init
from repro_torch.relational.embedding import embedding_bag


@dataclass(frozen=True)
class RecsysConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 5_000_000
    item_vocab: int = 2_000_000
    user_fields: int = 4            # multi-hot categorical fields per user
    item_fields: int = 2
    field_hots: int = 8             # ids per field (bag size)
    n_dense_feat: int = 13
    temperature: float = 0.05
    dtype: str = "float32"


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


class TwoTower(nn.Module):
    """The two towers' tables and MLPs, drawn from ``generator``.

    ``device=None`` means CUDA; where CUDA is absent that raises (pass
    ``device="cpu"`` to run on the CPU).  ``generator=None`` means a fresh
    generator on ``device`` seeded with 0.  Batches are dicts of tensors on
    the module's device, shaped as the reference's: ``user_ids``
    int32[B, F_u, K], ``item_ids`` int32[B, F_i, K] (pad = −1),
    ``user_dense`` float32[B, n_dense].
    """

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch TwoTower runs on CUDA by default and no CUDA device is "
                'available; pass device="cpu" to run on the CPU'
            )
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        d = cfg.embed_dim

        def table(vocab):
            t = torch.randn((vocab, d), generator=generator, dtype=dtype, device=device)
            return nn.Parameter(t.mul_(0.01), requires_grad=False)

        def mlp(dims):
            return nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False)
                for k, v in mlp_init(generator, dims, dtype, device=device).items()
            })

        self.user_table = table(cfg.user_vocab)
        self.item_table = table(cfg.item_vocab)
        self.user_mlp = mlp((cfg.user_fields * d + cfg.n_dense_feat,) + cfg.tower_dims)
        self.item_mlp = mlp((cfg.item_fields * d,) + cfg.tower_dims)

    # -- bags and heads: the towers in two halves ---------------------------

    @staticmethod
    def _bags(table: torch.Tensor, ids: torch.Tensor) -> list[torch.Tensor]:
        """One embedding bag per field of ``ids`` int32[B, F, K] → F × [B, D]."""
        fields = ids.transpose(0, 1).contiguous()            # each field contiguous
        return [embedding_bag(table, fields[f]) for f in range(fields.shape[0])]

    def user_bags(self, user_ids: torch.Tensor) -> list[torch.Tensor]:
        return self._bags(self.user_table, user_ids)

    def item_bags(self, item_ids: torch.Tensor) -> list[torch.Tensor]:
        return self._bags(self.item_table, item_ids)

    def user_head(self, bags: list[torch.Tensor], user_dense: torch.Tensor) -> torch.Tensor:
        x = torch.cat(bags + [user_dense], dim=-1)
        return _normalize(mlp_apply(self.user_mlp, x, act=torch.relu))

    def item_head(self, bags: list[torch.Tensor]) -> torch.Tensor:
        return _normalize(mlp_apply(self.item_mlp, torch.cat(bags, dim=-1), act=torch.relu))

    # -- the reference's entry points ----------------------------------------

    def user_tower(self, user_ids: torch.Tensor, user_dense: torch.Tensor) -> torch.Tensor:
        """user_ids: int32[B, F_u, K] multi-hot; user_dense: f32[B, n_dense] → [B, D]."""
        return self.user_head(self.user_bags(user_ids), user_dense)

    def item_tower(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.item_head(self.item_bags(item_ids))

    def forward(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        q = self.user_tower(batch["user_ids"], batch["user_dense"])
        v = self.item_tower(batch["item_ids"])
        return q, v

    def serve_scores(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Online/offline scoring of (user, item) pairs → scores [B]."""
        q, v = self(batch)
        return (q * v).sum(dim=-1) / self.cfg.temperature

    def retrieval_scores(self, batch: dict[str, torch.Tensor], candidate_vecs: torch.Tensor,
                         top_k: int = 100):
        """Score queries against a pre-embedded corpus ``candidate_vecs``
        f32[n_candidates, D]: one batched GEMM, then top-k → (values, indices)."""
        q = self.user_tower(batch["user_ids"], batch["user_dense"])
        scores = q @ candidate_vecs.T / self.cfg.temperature
        return torch.topk(scores, top_k)
