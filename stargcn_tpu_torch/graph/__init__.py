"""Host-side graph structures (NumPy) and the device-side edge arrays."""

from stargcn_tpu_torch.graph.csr import (
    CSRMat,
    NodeFeatures,
    merge_node_ids_dict,
    merge_nodes,
)
from stargcn_tpu_torch.graph.device import BipartiteGraphData
from stargcn_tpu_torch.graph.hetero import HeterGraph

__all__ = ["CSRMat", "NodeFeatures", "HeterGraph", "BipartiteGraphData",
           "merge_nodes", "merge_node_ids_dict"]
