"""Host-side graph structures (NumPy) and the device-side edge arrays."""

from stargcn_tpu_torch.graph.csr import CSRMat
from stargcn_tpu_torch.graph.device import BipartiteGraphData
from stargcn_tpu_torch.graph.hetero import HeterGraph

__all__ = ["CSRMat", "HeterGraph", "BipartiteGraphData"]
