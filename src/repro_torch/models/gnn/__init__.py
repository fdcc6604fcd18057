"""Graph neural networks on the relational substrate: GCN, MeshGraphNet,
SchNet and GraphCast as functions of a parameter dict and a
:class:`GraphBatch`."""

from repro_torch.models.gnn.common import GraphBatch, GNNConfig
from repro_torch.models.gnn import gcn, meshgraphnet, schnet, graphcast

MODELS = {
    "gcn": gcn,
    "meshgraphnet": meshgraphnet,
    "schnet": schnet,
    "graphcast": graphcast,
}

__all__ = ["GraphBatch", "GNNConfig", "MODELS", "gcn", "meshgraphnet", "schnet", "graphcast"]
