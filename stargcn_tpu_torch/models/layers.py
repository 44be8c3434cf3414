"""Heterogeneous GCN layers (PyTorch).

The port of ``stargcn_tpu/models/layers.py``: a layer aggregates each
(target <- neighbor) relation with a multi-link aggregator, concatenates
across relations, and applies a per-type output Dense + activation.
Module names match the flax tree (``agg_{t}_{s}``, ``out_fc_{t}``,
``l{i}``), so ``convert.params_from_flax`` maps parameters one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
from torch import nn

from stargcn_tpu_torch.models.aggregators import MultiLinkGCNAggregator
from stargcn_tpu_torch.models.common import dense, get_activation


@dataclasses.dataclass(frozen=True)
class BitStatic:
    """Bit-packed dense aggregation operands for one direction (see
    ``ops.bitdense``): this direction's 1-bit multi-link adjacency
    (``p_fwd``), the transpose layout its backward will read (``p_bwd``),
    and the separable degree-scale vectors.  The removed-batch-edge
    correction arrays come with the training slice."""

    p_fwd: torch.Tensor                 # (R * d8_dst, S_pad) uint8
    p_bwd: torch.Tensor                 # (R * d8_src, D_pad) uint8
    dst_scale: torch.Tensor             # (num_dst,)
    src_scale: torch.Tensor             # (num_src,)
    d8_dst: int
    d8_src: int
    impl: str = "kernel"                # 'kernel' | 'plain'


class HeterGCNLayer(nn.Module):
    """One heterogeneous GCN layer.

    Args:
      meta: target type -> neighbor types.
      in_units: feature width of every node type's input.
      agg_units / out_units: aggregator and output widths (every target).
    """

    def __init__(self, meta: Dict[str, Sequence[str]], in_units: int,
                 agg_units: int, out_units: int, num_links: int,
                 agg_ordinal_sharing: bool = False, agg_accum: str = "stack",
                 agg_act="relu", out_act=None, generator=None):
        super().__init__()
        self.meta = {t: list(s) for t, s in meta.items()}
        self.out_act = out_act
        for t, sources in self.meta.items():
            for s in sources:
                self.add_module(f"agg_{t}_{s}", MultiLinkGCNAggregator(
                    in_units, agg_units, num_links, act=agg_act,
                    ordinal_sharing=agg_ordinal_sharing, accum=agg_accum,
                    generator=generator))
            self.add_module(f"out_fc_{t}", dense(
                agg_units * len(sources), out_units, generator))

    def forward(self, features, relations):
        """``relations[(t, s)]`` is the ``BitStatic`` of aggregation into
        ``t`` from ``s``."""
        act = get_activation(self.out_act)
        out = {}
        for t, sources in self.meta.items():
            pooled = [getattr(self, f"agg_{t}_{s}")(features[s],
                                                    relations[(t, s)])
                      for s in sources]
            acc = pooled[0] if len(pooled) == 1 else torch.cat(pooled, -1)
            out[t] = act(getattr(self, f"out_fc_{t}")(acc))
        return out


class StackedHeterGCNLayers(nn.Module):
    """``len(layer_cfgs)`` stacked layers, named ``l0``, ``l1``, ...  Each
    cfg holds ``HeterGCNLayer`` keyword arguments."""

    def __init__(self, layer_cfgs: Sequence[dict], generator=None):
        super().__init__()
        self.num_layers = len(layer_cfgs)
        for i, cfg in enumerate(layer_cfgs):
            self.add_module(f"l{i}", HeterGCNLayer(**cfg,
                                                   generator=generator))

    def forward(self, features, relations):
        for i in range(self.num_layers):
            features = getattr(self, f"l{i}")(features, relations)
        return features


class InnerProductLayer(nn.Module):
    """Row-wise inner product (the parameter-free ``gen_ratings`` head;
    ``mid_units=None`` in every configuration)."""

    def forward(self, data1, data2):
        return (data1 * data2).float().sum(dim=-1, keepdim=True)
