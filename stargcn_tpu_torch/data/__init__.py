"""Synthetic datasets and the graph-variant iterator."""

from stargcn_tpu_torch.data.iterators import DataIterator

__all__ = ["DataIterator"]
