"""Per-rating-level GCN aggregator.

The port of ``MultiLinkGCNAggregator`` from
``stargcn_tpu/models/aggregators.py``, on the ``bitdense`` backend:

* 'stack' accumulation splits ``units`` across links (``units //
  num_links`` each, concatenated); 'sum' gives every link ``units`` and
  adds;
* optional ordinal weight sharing ``W_i = sum_{j<=i} w_j``;
* the per-link bias rides through the degree-normalised pooling on a ones
  column.

Parameters: ``weight`` ``(num_links, in_units, link_units)`` and ``bias``
``(num_links, link_units)``, the flax layout.
"""

from __future__ import annotations

import torch
from torch import nn

from stargcn_tpu_torch.models.common import get_activation, xavier_in_
from stargcn_tpu_torch.ops.bitdense import bit_multi_link_aggregate


class MultiLinkGCNAggregator(nn.Module):
    """Multi-link graph-conv aggregator (eval mode: dropout is the
    identity)."""

    def __init__(self, in_units: int, units: int, num_links: int,
                 act=None, ordinal_sharing: bool = False,
                 accum: str = "stack", generator=None):
        super().__init__()
        if accum == "stack":
            assert units % num_links == 0, (
                "units must be divisible by num_links for 'stack'")
            link_units = units // num_links
        elif accum == "sum":
            link_units = units
        else:
            raise NotImplementedError(accum)
        self.act = act
        self.ordinal_sharing = ordinal_sharing
        self.accum = accum
        self.weight = nn.Parameter(xavier_in_(
            torch.empty(num_links, in_units, link_units),
            num_links * in_units, generator))
        self.bias = nn.Parameter(torch.zeros(num_links, link_units))

    def forward(self, x_src, bit_static=None):
        if bit_static is None:
            raise NotImplementedError(
                "only the bitdense backend is ported; the flat-edge (xla) "
                "and dense backends come with the training slice")
        out = bit_multi_link_aggregate(
            x_src, bit_static, self.weight, self.bias,
            ordinal_sharing=self.ordinal_sharing, accum=self.accum)
        return get_activation(self.act)(out)
