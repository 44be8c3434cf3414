"""Heterogeneous GCN layers (PyTorch).

The port of ``stargcn_tpu/models/layers.py``: a layer aggregates each
(target <- neighbor) relation with a multi-link aggregator, concatenates
across relations, and applies a per-type output Dense + activation.  A
``Relation`` carries what the aggregation reads, whichever backend filled
it: edge arrays and a per-edge support (``xla``), a dense support
(``dense`` without an adjacency), a ``DenseStatic`` (``dense``), a
``BitStatic`` (``bitdense``) or an ``EllStatic`` (``ell``).
Module names match the flax tree (``agg_{t}_{s}``, ``out_fc_{t}``,
``l{i}``), so ``convert.params_from_flax`` maps parameters one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from stargcn_tpu_torch.models.aggregators import MultiLinkGCNAggregator
from stargcn_tpu_torch.models.common import dense, dropout, get_activation


@dataclasses.dataclass(frozen=True)
class DenseStatic:
    """Static-adjacency aggregation operands for one direction: the 0/1
    per-rating adjacency of the graph variant (never rebuilt per step),
    the separable degree-scale vectors, and the optional arrays of batch
    edges to correct for (see ``ops.agg.scaled_dense_aggregate``)."""

    adj: torch.Tensor                   # (R, D, S), or (R, S, D) transposed
    dst_scale: torch.Tensor             # (num_dst,)
    src_scale: torch.Tensor             # (num_src,)
    rem_src: Optional[torch.Tensor] = None     # (B,) removed edges
    rem_dst: Optional[torch.Tensor] = None
    rem_rating: Optional[torch.Tensor] = None
    rem_weight: Optional[torch.Tensor] = None
    transposed: bool = False


@dataclasses.dataclass(frozen=True)
class EllStatic:
    """Chunked-ELL aggregation operands for one direction (see
    ``ops.chunked_ell``): the variant's static index arrays for the
    forward (``f_*``, rows = dst nodes) and the transpose (``b_*``, rows =
    src nodes, read by the backward), the separable degree-scale vectors,
    and the optional arrays of the batch edges removed from this step's
    graph.  ``chunk`` is ``KERNEL.ELL_CHUNK``, ``bf16``
    ``KERNEL.ELL_BF16``."""

    f_idx: torch.Tensor                 # (V, K) int32, pad -> num_src
    f_rat: torch.Tensor                 # (V, K) int32
    f_row: torch.Tensor                 # (V,) int32 sorted dst rows
    b_idx: torch.Tensor                 # (V', K) transpose arrays
    b_rat: torch.Tensor
    b_row: torch.Tensor
    dst_scale: torch.Tensor             # (num_dst,)
    src_scale: torch.Tensor             # (num_src,)
    rem_src: Optional[torch.Tensor] = None     # (B,) removed edges
    rem_dst: Optional[torch.Tensor] = None
    rem_rating: Optional[torch.Tensor] = None
    rem_weight: Optional[torch.Tensor] = None
    chunk: Optional[int] = None
    bf16: bool = False


@dataclasses.dataclass(frozen=True)
class BitStatic:
    """Bit-packed dense aggregation operands for one direction (see
    ``ops.bitdense``): this direction's 1-bit multi-link adjacency
    (``p_fwd``), the transpose layout its backward reads (``p_bwd``), the
    separable degree-scale vectors, and the optional arrays of the batch
    edges removed from this step's graph."""

    p_fwd: torch.Tensor                 # (R * d8_dst, S_pad) uint8
    p_bwd: torch.Tensor                 # (R * d8_src, D_pad) uint8
    dst_scale: torch.Tensor             # (num_dst,)
    src_scale: torch.Tensor             # (num_src,)
    rem_src: Optional[torch.Tensor] = None     # (B,) int64 removed edges
    rem_dst: Optional[torch.Tensor] = None
    rem_rating: Optional[torch.Tensor] = None
    rem_weight: Optional[torch.Tensor] = None  # (B,) 1 for a real edge
    d8_dst: int = 0
    d8_src: int = 0
    impl: str = "kernel"                # 'kernel' | 'kernel16' | 'plain'
    # On a device mesh, the 'model' group of each pack split by rows over
    # it (None: that pack is whole), and the first packed row of this
    # rank's p_fwd and p_bwd.
    fwd_group: object = None
    bwd_group: object = None
    fwd_row0: int = 0
    bwd_row0: int = 0


@dataclasses.dataclass(frozen=True)
class Relation:
    """What one (target <- neighbor) aggregation reads.

    ``edge_src`` indexes the neighbor type's nodes, ``edge_dst`` the
    target type's; ``support`` carries mask x degree normalisation (0 on
    removed and padded edges).  ``dense_support`` is a prebuilt ``(R,
    num_dst, num_src)`` support, or ``(R, num_src, num_dst)`` with
    ``dense_transposed``.  Where ``dense_static``, ``bit_static`` or
    ``ell_static`` is set, the aggregation reads only that.  On a device
    mesh ``shard`` (a ``parallel.shardings.ShardedGraph``) says that the
    edge arrays are one rank's slice, whose partial sums are added over
    its group.
    """

    num_links: int
    edge_src: Optional[torch.Tensor] = None
    edge_dst: Optional[torch.Tensor] = None
    edge_rating: Optional[torch.Tensor] = None
    support: Optional[torch.Tensor] = None
    dense_support: Optional[torch.Tensor] = None
    dense_transposed: bool = False
    dense_static: Optional[DenseStatic] = None
    bit_static: Optional[BitStatic] = None
    ell_static: Optional[EllStatic] = None
    shard: object = None


class HeterGCNLayer(nn.Module):
    """One heterogeneous GCN layer.

    Args:
      meta: target type -> neighbor types.
      in_units: feature width of every node type's input.
      agg_units / out_units: aggregator and output widths (every target).
      dropout_rate: in training, on each aggregator's source features and
        on its output.
      backend / edge_chunk / dropout_per_edge: the aggregators'
        (``MultiLinkGCNAggregator``).
      dtype: the compute dtype of the aggregators and the output Dense
        (``None``: float32); the output is in it.
    """

    def __init__(self, meta: Dict[str, Sequence[str]], in_units: int,
                 agg_units: int, out_units: int, num_links: int,
                 dropout_rate: float = 0.0,
                 agg_ordinal_sharing: bool = False, agg_accum: str = "stack",
                 agg_act="relu", out_act=None, backend: str = "xla",
                 edge_chunk: Optional[int] = None,
                 dropout_per_edge: bool = False, dtype=None,
                 generator=None):
        super().__init__()
        self.meta = {t: list(s) for t, s in meta.items()}
        self.out_act = out_act
        self.dropout_rate = dropout_rate
        for t, sources in self.meta.items():
            for s in sources:
                self.add_module(f"agg_{t}_{s}", MultiLinkGCNAggregator(
                    in_units, agg_units, num_links, act=agg_act,
                    dropout_rate=dropout_rate,
                    ordinal_sharing=agg_ordinal_sharing, accum=agg_accum,
                    backend=backend, edge_chunk=edge_chunk,
                    dropout_per_edge=dropout_per_edge, dtype=dtype,
                    generator=generator))
            self.add_module(f"out_fc_{t}", dense(
                agg_units * len(sources), out_units, generator, dtype))

    def forward(self, features, relations, *, train: bool = False,
                generator=None):
        """``relations[(t, s)]`` is the ``Relation`` of aggregation into
        ``t`` from ``s``."""
        act = get_activation(self.out_act)
        out = {}
        for t, sources in self.meta.items():
            pooled = [dropout(getattr(self, f"agg_{t}_{s}")(
                features[s], relations[(t, s)], features[t].shape[0],
                train=train, generator=generator), self.dropout_rate, train,
                generator) for s in sources]
            acc = pooled[0] if len(pooled) == 1 else torch.cat(pooled, -1)
            out[t] = act(getattr(self, f"out_fc_{t}")(acc))
        return out


class StackedHeterGCNLayers(nn.Module):
    """``len(layer_cfgs)`` stacked layers, named ``l0``, ``l1``, ...  Each
    cfg holds ``HeterGCNLayer`` keyword arguments.  With
    ``recurrent_layer_num`` (``GCN.USE_RECURRENT``) ``layer_cfgs`` holds one
    cfg, and its one layer ``l0`` runs that many times."""

    def __init__(self, layer_cfgs: Sequence[dict], generator=None,
                 recurrent_layer_num: Optional[int] = None):
        super().__init__()
        if recurrent_layer_num is not None:
            assert len(layer_cfgs) == 1
            self.depth = recurrent_layer_num
        else:
            self.depth = len(layer_cfgs)
        self.num_layers = len(layer_cfgs)
        for i, cfg in enumerate(layer_cfgs):
            self.add_module(f"l{i}", HeterGCNLayer(**cfg,
                                                   generator=generator))

    def forward(self, features, relations, *, train: bool = False,
                generator=None):
        for i in range(self.depth):
            features = getattr(self, f"l{i % self.num_layers}")(
                features, relations, train=train, generator=generator)
        return features


class InnerProductLayer(nn.Module):
    """Row-wise inner product (the parameter-free ``gen_ratings`` head;
    ``mid_units=None`` in every configuration), accumulated in float32
    whatever the operands' dtype: the elementwise products are in their
    dtype, the sum is not."""

    def forward(self, data1, data2):
        return (data1 * data2).float().sum(dim=-1, keepdim=True)
