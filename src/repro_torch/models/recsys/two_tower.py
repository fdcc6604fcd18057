"""Two-tower retrieval (Yi et al., RecSys'19 / Covington, RecSys'16).

Huge sparse embedding tables → EmbeddingBag (the relational hot path) →
per-tower MLP 1024-512-256 → normalized dot interaction → in-batch sampled
softmax with logQ correction.  ``retrieval_scores`` scores one query batch
against a pre-embedded candidate corpus as one batched GEMM + top-k.

Two forms over the same weights:

* functions of a parameter dict, as the reference's: ``init_params``,
  ``forward``, ``loss``, ``serve_scores``, ``retrieval_scores``, and the
  vocab-sharded ``sharded_bags``, ``forward_sharded``, ``loss_sharded``,
  whose ranks form a ``repro_torch.distributed`` mesh;
* ``TwoTower``, the serving module (frozen parameters), whose ``params()``
  is that dict.

A bag takes the hand-written gather-sum kernel on a CUDA device when no
gradient is needed (serving) and torch ops under autograd (training): the
kernel has no backward, and the reference trains through ``jnp.take`` + sum
too (``relational/embedding.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils._pytree import tree_map

from repro_torch.distributed.collectives import all_gather, grad_psum, psum, psum_scatter
from repro_torch.distributed.mesh import axes_group, axis_index, shard_rows
from repro_torch.models.common import mlp_apply, mlp_init, new_generator, randn
from repro_torch.relational.embedding import embedding_bag, sampled_softmax_loss


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


def init_params(cfg: RecsysConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """The tables and MLPs, drawn from ``generator`` in the order user table,
    item table, user MLP, item MLP.  ``device=None`` means CUDA; where CUDA is
    absent that raises (pass ``device="cpu"``).  ``generator=None`` means a
    fresh generator on ``device`` seeded with 0."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch TwoTower runs on CUDA by default and no CUDA device is "
            'available; pass device="cpu" to run on the CPU'
        )
    if generator is None:
        generator = new_generator(device)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.embed_dim

    def table(vocab):
        return randn((vocab, d), generator, dtype, device).mul_(0.01)

    user_table, item_table = table(cfg.user_vocab), table(cfg.item_vocab)
    return {
        "user_table": user_table,
        "item_table": item_table,
        "user_mlp": mlp_init(generator, (cfg.user_fields * d + cfg.n_dense_feat,)
                             + cfg.tower_dims, dtype, device=device),
        "item_mlp": mlp_init(generator, (cfg.item_fields * d,) + cfg.tower_dims, dtype,
                             device=device),
    }


# -- bags and heads: the towers in two halves ------------------------------------


def field_bags(table: torch.Tensor, ids: torch.Tensor) -> list[torch.Tensor]:
    """One embedding bag per field of ``ids`` int32[B, F, K] → F × [B, D].

    All B·F bags go to ``embedding_bag`` as one [B·F, K] view (one kernel
    launch per table, no copy); field f's bags are the strided view
    ``out[:, f]``, the sums the reference's per-field loop computes."""
    b, f, k = ids.shape
    out = embedding_bag(table, ids.reshape(b * f, k))
    return list(out.view(b, f, table.shape[1]).unbind(1))


def user_head(params, bags: list[torch.Tensor], user_dense: torch.Tensor) -> torch.Tensor:
    x = torch.cat(bags + [user_dense], dim=-1)
    return _normalize(mlp_apply(params["user_mlp"], x, act=torch.relu))


def item_head(params, bags: list[torch.Tensor]) -> torch.Tensor:
    return _normalize(mlp_apply(params["item_mlp"], torch.cat(bags, dim=-1), act=torch.relu))


def user_tower(params, user_ids, user_dense, cfg: RecsysConfig) -> torch.Tensor:
    """user_ids: int32[B, F_u, K] multi-hot; user_dense: f32[B, n_dense] → [B, D]."""
    return user_head(params, field_bags(params["user_table"], user_ids), user_dense)


def item_tower(params, item_ids, cfg: RecsysConfig) -> torch.Tensor:
    return item_head(params, field_bags(params["item_table"], item_ids))


def forward(params, batch, cfg: RecsysConfig):
    q = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    v = item_tower(params, batch["item_ids"], cfg)
    return q, v


def loss(params, batch, cfg: RecsysConfig):
    q, v = forward(params, batch, cfg)
    return sampled_softmax_loss(
        q, v, log_q=batch.get("log_q"), temperature=cfg.temperature
    )


# --------------------------------------------------------------------------
# sharded path: vocab-sharded tables with masked local lookup + a collective
# --------------------------------------------------------------------------
#
# Each rank passes its own shards: a table's vocab block (rows
# [r·V/tp, (r+1)·V/tp) for its coordinate r along ``tp``) and the batch's rows
# for its coordinate along ``dp_axes`` (``distributed.shard_rows``).  Tables
# and MLPs are replicated over the data-parallel ranks, which see other rows:
# their gradients are summed over those ranks inside the backward
# (``grad_psum``), so every rank's ``backward`` of the replicated loss gives
# the reference's gradient of its shard.


def sharded_bags(
    table, ids, mesh, dp_axes, tp: str = "model", scatter: bool = False,
    wire_dtype=None,
):
    """EmbeddingBag over a vocab-sharded table without materializing it.

    Each rank looks up only the ids that fall in its vocab range (others
    contribute zero) and one collective over ``tp`` assembles the full bags —
    the canonical sharded-embedding pattern.

    ``scatter=False`` (baseline): a sum over ``tp`` — every rank gets all
    B_loc bags (bytes ∝ B_loc·F·D per rank).
    ``scatter=True``: a reduce-scatter — bags come back sharded over ``tp``
    along the batch dim (bytes ∝ B_loc·F·D / tp), and the tower MLPs run
    batch-parallel on the tp axis too.
    ids: int32[B_loc, F, K] (-1 pad) → f32[B_loc(/tp), F, D].
    """
    table = grad_psum(table, axes_group(mesh, dp_axes))
    vloc = table.shape[0]
    lo = axis_index(mesh, tp) * vloc
    rel = ids - lo
    ok = (ids >= 0) & (rel >= 0) & (rel < vloc)
    rows = table[rel.clamp(0, vloc - 1).long()]
    rows = torch.where(ok[..., None], rows, 0.0)
    bags = rows.sum(dim=2)                               # [B_loc, F, D]
    if wire_dtype is not None:
        bags = bags.to(wire_dtype)                       # compress payload
    group = axes_group(mesh, tp)
    out = psum_scatter(bags, group) if scatter else psum(bags, group)
    return out.to(table.dtype)


def forward_sharded(
    params, batch, cfg: RecsysConfig, mesh, dp_axes, scatter=False, wire_dtype=None
):
    """(q, v) of the global batch, [B, D] each, on every rank."""
    dp_axes = tuple(dp_axes)
    ub = sharded_bags(params["user_table"], batch["user_ids"], mesh, dp_axes,
                      scatter=scatter, wire_dtype=wire_dtype)
    ib = sharded_bags(params["item_table"], batch["item_ids"], mesh, dp_axes,
                      scatter=scatter, wire_dtype=wire_dtype)
    b = ub.shape[0]
    dense = batch["user_dense"]
    batch_axes = dp_axes + ("model",) if scatter else dp_axes
    if scatter:
        dense = shard_rows(dense, mesh, "model")        # the rows of the scattered bags
    group = axes_group(mesh, batch_axes)
    mlps = {k: tree_map(lambda w: grad_psum(w, group), params[k])
            for k in ("user_mlp", "item_mlp")}
    x = torch.cat([ub.reshape(b, -1), dense], dim=-1)
    q = _normalize(mlp_apply(mlps["user_mlp"], x, act=torch.relu))
    v = _normalize(mlp_apply(mlps["item_mlp"], ib.reshape(b, -1), act=torch.relu))
    return all_gather(q, group), all_gather(v, group)


def loss_sharded(
    params, batch, cfg: RecsysConfig, mesh=None, dp_axes=("data",),
    scatter=False, wire_dtype=None,
):
    if mesh is None:
        raise ValueError("loss_sharded: pass the mesh its shards live on")
    q, v = forward_sharded(
        params, batch, cfg, mesh, dp_axes, scatter=scatter, wire_dtype=wire_dtype
    )
    log_q = batch.get("log_q")
    if log_q is not None:
        log_q = all_gather(log_q, axes_group(mesh, dp_axes))
    return sampled_softmax_loss(q, v, log_q=log_q, temperature=cfg.temperature)


def serve_scores(params, batch, cfg: RecsysConfig, mesh=None, dp_axes=("data",)):
    """Online/offline scoring of (user, item) pairs → scores [B]."""
    if mesh is not None:
        q, v = forward_sharded(params, batch, cfg, mesh, dp_axes)
    else:
        q, v = forward(params, batch, cfg)
    return (q * v).sum(dim=-1) / cfg.temperature


def retrieval_scores(params, batch, candidate_vecs, cfg: RecsysConfig, top_k: int = 100):
    """Score queries against a pre-embedded corpus ``candidate_vecs``
    f32[n_candidates, D]: one batched GEMM, then top-k → (values, indices)."""
    q = user_tower(params, batch["user_ids"], batch["user_dense"], cfg)
    scores = q @ candidate_vecs.T / cfg.temperature
    return torch.topk(scores, top_k)


class TwoTower(nn.Module):
    """The two towers' tables and MLPs (``init_params``) as a serving module.

    Batches are dicts of tensors on the module's device, shaped as the
    reference's: ``user_ids`` int32[B, F_u, K], ``item_ids`` int32[B, F_i, K]
    (pad = −1), ``user_dense`` float32[B, n_dense].  The parameters do not
    require gradients; train on ``params()`` with ``repro_torch.train``.
    """

    def __init__(self, cfg: RecsysConfig, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        p = init_params(cfg, generator, device)
        self.user_table = nn.Parameter(p["user_table"], requires_grad=False)
        self.item_table = nn.Parameter(p["item_table"], requires_grad=False)
        self.user_mlp, self.item_mlp = (
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in p[m].items()})
            for m in ("user_mlp", "item_mlp"))

    def params(self) -> dict:
        """The parameter dict of the functions above, sharing this module's tensors."""
        return {"user_table": self.user_table, "item_table": self.item_table,
                "user_mlp": dict(self.user_mlp), "item_mlp": dict(self.item_mlp)}

    # -- bags and heads: the towers in two halves ---------------------------

    def user_bags(self, user_ids: torch.Tensor) -> list[torch.Tensor]:
        return field_bags(self.user_table, user_ids)

    def item_bags(self, item_ids: torch.Tensor) -> list[torch.Tensor]:
        return field_bags(self.item_table, item_ids)

    def user_head(self, bags: list[torch.Tensor], user_dense: torch.Tensor) -> torch.Tensor:
        return user_head(self.params(), bags, user_dense)

    def item_head(self, bags: list[torch.Tensor]) -> torch.Tensor:
        return item_head(self.params(), bags)

    # -- the reference's entry points ----------------------------------------

    def user_tower(self, user_ids: torch.Tensor, user_dense: torch.Tensor) -> torch.Tensor:
        """user_ids: int32[B, F_u, K] multi-hot; user_dense: f32[B, n_dense] → [B, D]."""
        return user_tower(self.params(), user_ids, user_dense, self.cfg)

    def item_tower(self, item_ids: torch.Tensor) -> torch.Tensor:
        return item_tower(self.params(), item_ids, self.cfg)

    def forward(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self.params(), batch, self.cfg)

    def serve_scores(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Online/offline scoring of (user, item) pairs → scores [B]."""
        return serve_scores(self.params(), batch, self.cfg)

    def retrieval_scores(self, batch: dict[str, torch.Tensor], candidate_vecs: torch.Tensor,
                         top_k: int = 100):
        """Score queries against a pre-embedded corpus ``candidate_vecs``
        f32[n_candidates, D]: one batched GEMM, then top-k → (values, indices)."""
        return retrieval_scores(self.params(), batch, candidate_vecs, self.cfg, top_k)
