"""Relational primitives on torch tensors: sorted tables, segment
aggregates, embedding bags and neighbor sampling.

The Datalog engine and the recsys model sit on the same primitives: sorted
integer tables, compact-key dedup, searchsorted joins and segment
aggregation; an embedding bag is a join with an embedding table plus SUM.
"""

from repro_torch.relational.sort import (
    SENTINEL,
    compact_key,
    lexsort_rows,
    sort_rows,
    unique_mask,
    searchsorted_rows,
)
from repro_torch.relational.segment import (
    segment_sum,
    segment_max,
    segment_min,
    segment_mean,
    segment_softmax,
    degree,
)
from repro_torch.relational.embedding import embedding_bag, sampled_softmax_loss
from repro_torch.relational.sampler import NeighborSampler, SampledBlock, build_csr

__all__ = [
    "SENTINEL",
    "compact_key",
    "lexsort_rows",
    "sort_rows",
    "unique_mask",
    "searchsorted_rows",
    "segment_sum",
    "segment_max",
    "segment_min",
    "segment_mean",
    "segment_softmax",
    "degree",
    "embedding_bag",
    "sampled_softmax_loss",
    "NeighborSampler",
    "SampledBlock",
    "build_csr",
]
