"""Segment operators over CSR-style ``indptr`` segments.

The port's own copy of ``stargcn_tpu/ops/segment.py``: the same functions
by name and by what they compute.  The JAX package picks between a
segmented associative scan and a scatter by the position of the reduced
axis in its TPU tile layout; here every reduction is one ``index_add_``
or ``scatter_reduce`` over per-element segment ids, the natural form on a
CUDA card.

Conventions:

* ``data``: ``(batch, nnz)`` or ``(batch, nnz, feat)`` float tensor.
* ``indptr``: ``(num_seg + 1,)`` integer tensor, ``indptr[0] == 0``,
  ``indptr[-1] == nnz``; segment ``i`` covers ``[indptr[i], indptr[i+1])``.
* Empty segments reduce to ``0``.

Gradients come from autograd.  Where a segment's maximum (or minimum) is
reached by several elements, ``scatter_reduce`` splits the gradient evenly
between them; the JAX package's scan-chained ``maximum`` splits it
unevenly, so the two agree on gradients only where there are no ties.
"""

from __future__ import annotations

import torch


def indptr_to_segment_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand a CSR ``indptr`` into ``(nnz,)`` int64 per-element segment
    ids (element ``j`` of segment ``i`` gets ``i``)."""
    indptr = indptr.long()
    num_seg = indptr.shape[0] - 1
    seg = torch.arange(num_seg, device=indptr.device)
    return torch.repeat_interleave(seg, indptr[1:] - indptr[:-1],
                                   output_size=nnz)


def _seg_reduce(data: torch.Tensor, indptr: torch.Tensor, op: str,
                axis: int = -1) -> torch.Tensor:
    """Per-segment ``op`` ('sum' | 'amax' | 'amin') over ``axis``; empty
    segments give 0."""
    axis = axis % data.dim()
    nnz = data.shape[axis]
    num_seg = indptr.shape[0] - 1
    seg_ids = indptr_to_segment_ids(indptr, nnz)
    moved = data.movedim(axis, 0)
    out = moved.new_zeros((num_seg,) + tuple(moved.shape[1:]))
    if op == "sum":
        out = out.index_add(0, seg_ids, moved)
    else:
        # include_self=False: a segment that receives no element keeps
        # the 0 it starts from.
        idx = seg_ids.view((-1,) + (1,) * (moved.dim() - 1)).expand_as(moved)
        out = out.scatter_reduce(0, idx, moved, reduce=op,
                                 include_self=False)
    return out.movedim(0, axis)


def seg_sum(data: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = sum(data[..., indptr[i]:indptr[i+1]])``."""
    return _seg_reduce(data, indptr, "sum")


def seg_max(data: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Segment max over the last axis (empty segments -> 0)."""
    return _seg_reduce(data, indptr, "amax")


def seg_min(data: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Segment min over the last axis (empty segments -> 0)."""
    return _seg_reduce(data, indptr, "amin")


def seg_broadcast_to(rhs: torch.Tensor, indptr: torch.Tensor,
                     nnz: int) -> torch.Tensor:
    """``out[..., j] = rhs[..., seg_id(j)]``: per-segment values broadcast
    to their elements (also the gradient of ``seg_sum``)."""
    return rhs.index_select(-1, indptr_to_segment_ids(indptr, nnz))


def seg_broadcast_add(lhs: torch.Tensor, rhs: torch.Tensor,
                      indptr: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = lhs[..., j] + rhs[..., seg_id(j)]``."""
    return lhs + seg_broadcast_to(rhs, indptr, lhs.shape[-1])


def seg_broadcast_mul(lhs: torch.Tensor, rhs: torch.Tensor,
                      indptr: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = lhs[..., j] * rhs[..., seg_id(j)]``."""
    return lhs * seg_broadcast_to(rhs, indptr, lhs.shape[-1])


def seg_softmax(data: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Softmax within each segment of the last axis, max-subtracted."""
    nnz = data.shape[-1]
    shifted = torch.exp(data - seg_broadcast_to(seg_max(data, indptr),
                                                indptr, nnz))
    denom = seg_sum(shifted, indptr)
    return shifted / seg_broadcast_to(denom, indptr, nnz)


def seg_take_k_corr(embed1: torch.Tensor, embed2: torch.Tensor,
                    neighbor_ids: torch.Tensor,
                    indptr: torch.Tensor) -> torch.Tensor:
    """Segment inner product (a node with each of its neighbours):
    ``out[k, j] = dot(embed1[k, seg_id(j)], embed2[k, neighbor_ids[j]])``.

    Args:
      embed1: ``(K, num_nodes, feat)``.
      embed2: ``(K, num_neighbor_nodes, feat)``.
      neighbor_ids: ``(nnz,)`` indices into ``embed2``'s node axis.
      indptr: ``(num_nodes + 1,)`` segments over ``nnz``.

    Returns ``(K, nnz)``.
    """
    nnz = neighbor_ids.shape[0]
    seg_ids = indptr_to_segment_ids(indptr, nnz)
    lhs = embed1.index_select(1, seg_ids)
    rhs = embed2.index_select(1, neighbor_ids.long())
    return (lhs * rhs).sum(dim=-1)


def seg_weighted_pool(data: torch.Tensor, weights: torch.Tensor,
                      indices: torch.Tensor,
                      indptr: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour pooling:
    ``out[b, i] = sum_{j in segment i} weights[b, j] * data[b, indices[j]]``.

    Args:
      data: ``(batch, num_neighbor_nodes, feat)``.
      weights: ``(batch, nnz)``.
      indices: ``(nnz,)`` indices into ``data``'s node axis.
      indptr: ``(num_seg + 1,)`` segments over ``nnz``.

    Returns ``(batch, num_seg, feat)``.
    """
    gathered = data.index_select(1, indices.long()) * weights[:, :, None]
    return _seg_reduce(gathered, indptr, "sum", axis=1)


def seg_pool(data: torch.Tensor, indices: torch.Tensor,
             indptr: torch.Tensor, pool_type: str = "sum") -> torch.Tensor:
    """Unweighted neighbour pooling over each segment: ``sum``, ``avg``
    (an empty segment gives 0) or ``max`` (an empty segment gives 0).

    Args as ``seg_weighted_pool`` without the weights.
    """
    if pool_type not in ("sum", "avg", "max"):
        raise ValueError(f"unknown pool_type: {pool_type!r}")
    gathered = data.index_select(1, indices.long())
    if pool_type == "max":
        return _seg_reduce(gathered, indptr, "amax", axis=1)
    out = _seg_reduce(gathered, indptr, "sum", axis=1)
    if pool_type == "avg":
        seg_len = (indptr[1:] - indptr[:-1]).to(data.dtype)
        out = out / seg_len.clamp_min(1.0)[None, :, None]
    return out
