"""MovieLens loading, synthetic datasets and the graph-variant iterator."""

from stargcn_tpu_torch.data.iterators import DataIterator, NegEdgeGenerator
from stargcn_tpu_torch.data.movielens import LoadData

__all__ = ["DataIterator", "LoadData", "NegEdgeGenerator"]
