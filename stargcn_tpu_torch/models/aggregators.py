"""Per-rating-level GCN aggregators.

The port of ``MultiLinkGCNAggregator`` and ``GCNAggregator`` from
``stargcn_tpu/models/aggregators.py``, on the ``bitdense``, ``ell``,
``dense`` and ``xla`` backends:

* 'stack' accumulation splits ``units`` across links (``units //
  num_links`` each, concatenated); 'sum' gives every link ``units`` and
  adds;
* optional ordinal weight sharing ``W_i = sum_{j<=i} w_j``;
* the per-link bias rides through the degree-normalised pooling (on a
  ones column on ``bitdense`` and ``ell``, which aggregate the raw
  features and project after; through the projection elsewhere);
* in training, dropout falls on the source features before the
  projection, so the bias is never dropped; with ``dropout_per_edge``
  (``GCN.DROPOUT_PER_EDGE``, the reference's granularity) it falls on each
  edge's gathered copy of its source row instead, on the flat edge arrays
  (``xla``) only;
* with a compute ``dtype`` (``MODEL.COMPUTE_DTYPE``) the source features,
  weight and bias are cast to it on every call; the parameters stay
  float32.

Parameters: ``weight`` ``(num_links, in_units, link_units)`` and ``bias``
``(num_links, link_units)``, the flax layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stargcn_tpu_torch.models.common import (
    dropout,
    get_activation,
    xavier_in_,
)
from stargcn_tpu_torch.ops.agg import (
    multi_link_aggregate,
    multi_link_project,
    removed_edges_correction,
    scaled_dense_aggregate,
)
from stargcn_tpu_torch.ops.gather import take_rows
from stargcn_tpu_torch.ops.bitdense import bit_multi_link_aggregate
from stargcn_tpu_torch.ops.chunked_ell import ell_multi_link_aggregate


class MultiLinkGCNAggregator(nn.Module):
    """Multi-link graph-conv aggregator; ``dropout_rate`` applies to the
    source features (per edge with ``dropout_per_edge``) when ``forward``
    is called with ``train``.  ``backend`` and ``edge_chunk`` are
    ``multi_link_aggregate``'s, read when the relation carries no static
    operands; ``dtype`` is the compute dtype (``None``: float32)."""

    def __init__(self, in_units: int, units: int, num_links: int,
                 act=None, dropout_rate: float = 0.0,
                 ordinal_sharing: bool = False,
                 accum: str = "stack", backend: str = "xla",
                 edge_chunk: Optional[int] = None,
                 dropout_per_edge: bool = False, dtype=None,
                 generator=None):
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
        self.dropout_rate = dropout_rate
        self.ordinal_sharing = ordinal_sharing
        self.accum = accum
        self.backend = backend
        self.edge_chunk = edge_chunk
        self.dropout_per_edge = dropout_per_edge
        self.dtype = dtype
        self.weight = nn.Parameter(xavier_in_(
            torch.empty(num_links, in_units, link_units),
            num_links * in_units, generator))
        self.bias = nn.Parameter(torch.zeros(num_links, link_units))

    def forward(self, x_src, rel, num_dst: Optional[int] = None,
                *, train: bool = False, generator=None):
        """Aggregate ``x_src`` ``(num_src, in_units)`` into ``num_dst``
        target nodes through ``rel``, a ``models.layers.Relation``."""
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x_src = x_src.to(self.dtype)
            weight, bias = weight.to(self.dtype), bias.to(self.dtype)
        act = get_activation(self.act)
        if self.dropout_per_edge:
            return act(self._per_edge(x_src, weight, bias, rel, num_dst,
                                      train, generator))
        x = dropout(x_src, self.dropout_rate, train, generator)
        if rel.bit_static is not None:
            return act(bit_multi_link_aggregate(
                x, rel.bit_static, weight, bias,
                ordinal_sharing=self.ordinal_sharing, accum=self.accum))
        if rel.ell_static is not None:
            return act(ell_multi_link_aggregate(
                x, rel.ell_static, weight, bias,
                ordinal_sharing=self.ordinal_sharing, accum=self.accum))
        proj = multi_link_project(x, weight, bias,
                                  ordinal_sharing=self.ordinal_sharing)
        if rel.dense_static is not None:
            # Static adjacency: degree scalings folded around the product,
            # removal (when the arrays are set) as a batch-sized
            # correction.
            ds = rel.dense_static
            pooled = scaled_dense_aggregate(proj, ds.adj, ds.dst_scale,
                                            ds.src_scale,
                                            transposed=ds.transposed)
            if ds.rem_src is not None:
                pooled = pooled - removed_edges_correction(
                    proj, ds.rem_src, ds.rem_dst, ds.rem_rating,
                    ds.rem_weight, pooled.shape[0])
            out = (pooled.reshape(pooled.shape[0], -1)
                   if self.accum == "stack" else pooled.sum(dim=1))
        else:
            out = multi_link_aggregate(
                proj, rel.edge_src, rel.edge_dst, rel.edge_rating,
                rel.support, num_dst, accum=self.accum,
                backend=self.backend, dense_support=rel.dense_support,
                dense_transposed=rel.dense_transposed,
                edge_chunk=self.edge_chunk)
        return act(out)

    def _per_edge(self, x_src, weight, bias, rel, num_dst, train,
                  generator):
        """``GCN.DROPOUT_PER_EDGE``: gather each edge's source row, drop
        elements of the gathered ``(E, F)`` rows (two edges from one source
        get masks of their own), append an undropped ones column that
        carries the bias, pool with the support into (dst, rating) slots,
        then project per rating level.  Linear in the rows, so in eval it
        equals the per-node aggregation.  The edges go through in one
        piece, as in the JAX package: its ``(E, F + 1)`` float32 messages
        (2.6 GB at ML-10M with F = 64) are what this mode costs."""
        if (rel.bit_static is not None or rel.dense_static is not None
                or rel.ell_static is not None):
            raise ValueError("GCN.DROPOUT_PER_EDGE reads the flat edge "
                             "arrays (the xla backend)")
        R = self.weight.shape[0]
        msg = dropout(take_rows(x_src, rel.edge_src.long()),
                      self.dropout_rate, train, generator)
        msg = torch.cat([msg, msg.new_ones(msg.shape[0], 1)], dim=1) \
            * rel.support[:, None]
        seg = rel.edge_dst.long() * R + rel.edge_rating.long()
        pooled = msg.new_zeros(num_dst * R, msg.shape[1]).index_add_(
            0, seg, msg).reshape(num_dst, R, -1)
        w_aug = torch.cat([weight, bias[:, None, :]], dim=1)
        if self.ordinal_sharing:
            w_aug = torch.cumsum(w_aug, dim=0)
        out = torch.einsum("drf,rfu->dru", pooled,
                           w_aug.to(pooled.dtype)).to(x_src.dtype)
        if self.accum == "stack":
            return out.reshape(num_dst, -1)
        return out.sum(dim=1)


class GCNAggregator(nn.Module):
    """Single-link aggregator: ``MultiLinkGCNAggregator`` with one link
    (every edge at rating level 0).  The submodule's name is flax's
    automatic one, so the JAX package's parameters map one to one."""

    def __init__(self, in_units: int, units: int, act=None,
                 dropout_rate: float = 0.0, backend: str = "xla",
                 generator=None):
        super().__init__()
        self.MultiLinkGCNAggregator_0 = MultiLinkGCNAggregator(
            in_units, units, 1, act=act, dropout_rate=dropout_rate,
            backend=backend, generator=generator)

    def forward(self, x_src, edge_src, edge_dst, support, num_dst, *,
                train: bool = False, generator=None):
        # layers.py imports this module, so Relation is imported here.
        from stargcn_tpu_torch.models.layers import Relation

        rel = Relation(num_links=1, edge_src=edge_src, edge_dst=edge_dst,
                       edge_rating=torch.zeros_like(edge_src),
                       support=support)
        return self.MultiLinkGCNAggregator_0(x_src, rel, num_dst,
                                             train=train,
                                             generator=generator)
