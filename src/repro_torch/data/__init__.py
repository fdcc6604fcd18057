"""Seeded synthetic data: graphs, program-analysis facts, the LM token stream
and the recsys click stream (numpy only).  Deterministic given a seed."""

from repro_torch.data.graphs import (
    batched_molecules,
    gnp_graph,
    grid_mesh_graph,
    rmat_graph,
)
from repro_torch.data.program_facts import andersen_facts, csda_facts, cspa_facts
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.data.tokens import TokenStream

__all__ = [
    "gnp_graph",
    "rmat_graph",
    "grid_mesh_graph",
    "batched_molecules",
    "andersen_facts",
    "csda_facts",
    "cspa_facts",
    "RecsysStream",
    "TokenStream",
]
