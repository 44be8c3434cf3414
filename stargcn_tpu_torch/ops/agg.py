"""Multi-link (per-rating-level) graph aggregation over flat edge arrays.

The port of ``stargcn_tpu/ops/agg.py``.  The edge set is one static array
with a per-edge rating index; the multi-link aggregation is one flat
gather over ``rating * num_src + src`` and one segment sum over
``dst * num_links + rating``.  'stack' and 'sum' accumulation reshape or
sum the ``(num_dst, num_links, units)`` result.

Backends of ``multi_link_aggregate``:

* ``"xla"``: the gather and the segment sum (``index_add_``), as one
  autograd function that keeps no ``(E, units)`` message buffer for its
  backward; with ``edge_chunk`` both directions walk the edges in chunks.
* ``"dense"``: a per-rating dense support contracted by ``torch.bmm``.
  ``scaled_dense_aggregate`` is its static-adjacency form: a 0/1
  adjacency built once per graph variant, with the degree scalings
  folded around the product.

These are library calls (cuBLAS, ``index_add_``): the JAX package writes
them in XLA, outside its Pallas kernels.
"""

from __future__ import annotations

import torch

from stargcn_tpu_torch.ops.gather import onehot_segment_sum
from stargcn_tpu_torch.parallel.collectives import all_reduce_


class _GatherScatter(torch.autograd.Function):
    """``out[s] = sum_{e: seg[e] == s} weights[e] * values[gather[e]]``,
    over edge chunks of ``chunk``.  Saves only the index arrays and the
    weights (and ``values`` when the weights need a gradient); the
    backward is the transposed gather/scatter,
    ``grad_values[gather[e]] += weights[e] * grad_out[seg[e]]``."""

    @staticmethod
    def forward(ctx, values, weights, gather_idx, seg_ids, num_segments,
                chunk):
        E = gather_idx.shape[0]
        step = int(chunk) if chunk else max(E, 1)
        out = values.new_zeros((num_segments, values.shape[1]))
        for s in range(0, E, step):
            e = min(s + step, E)
            out.index_add_(0, seg_ids[s:e],
                           values.index_select(0, gather_idx[s:e])
                           * weights[s:e, None])
        ctx.step = step
        ctx.num_values = values.shape[0]
        saved = (weights, gather_idx, seg_ids)
        if ctx.needs_input_grad[1]:
            saved = saved + (values,)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        weights, gather_idx, seg_ids = ctx.saved_tensors[:3]
        E, step = gather_idx.shape[0], ctx.step
        grad_out = grad_out.contiguous()
        grad_values = grad_weights = None
        if ctx.needs_input_grad[0]:
            grad_values = grad_out.new_zeros((ctx.num_values,
                                              grad_out.shape[1]))
            for s in range(0, E, step):
                e = min(s + step, E)
                grad_values.index_add_(0, gather_idx[s:e],
                                       grad_out.index_select(0, seg_ids[s:e])
                                       * weights[s:e, None])
        if ctx.needs_input_grad[1]:
            values = ctx.saved_tensors[3]
            grad_weights = torch.empty_like(weights)
            for s in range(0, E, step):
                e = min(s + step, E)
                grad_weights[s:e] = (
                    values.index_select(0, gather_idx[s:e])
                    * grad_out.index_select(0, seg_ids[s:e])).sum(dim=1)
        return grad_values, grad_weights, None, None, None, None


def gather_weighted_segment_sum(values: torch.Tensor,
                                gather_idx: torch.Tensor,
                                weights: torch.Tensor,
                                segment_ids: torch.Tensor,
                                num_segments: int,
                                chunk: int | None = None) -> torch.Tensor:
    """``out[s] = sum_{e: segment_ids[e]==s} weights[e] *
    values[gather_idx[e]]``: one row gather, one scale, one scatter-add,
    differentiable in ``values`` and ``weights``.  With ``chunk`` the
    edges go through in chunks of that many, forward and backward, so no
    more than ``(chunk, units)`` messages are live at a time."""
    return _GatherScatter.apply(values, weights, gather_idx.long(),
                                segment_ids.long(), int(num_segments), chunk)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) accumulated and returned in float32:
    for two bf16 operands on a CUDA card one tensor-core product with
    float32 output; elsewhere the float32 product of the same values."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if a.dim() == 2:
            return torch.bmm(a[None], b[None], out_dtype=torch.float32)[0]
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` with float32 accumulation and output for operands in a
    reduced precision.  The backward is the JAX package's transpose of a
    product with ``preferred_element_type=float32``: the float32 cotangent
    times the other operand, in float32, rounded to each operand's
    dtype.  With ``b_group`` the float32 cotangent of ``b`` is summed over
    that process group before the rounding."""

    @staticmethod
    def forward(ctx, a, b, b_group=None):
        ctx.save_for_backward(a, b)
        ctx.b_group = b_group
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = torch.matmul(grad, b.float().transpose(-1, -2)).to(
                a.dtype)
        if ctx.needs_input_grad[1]:
            grad_b = torch.matmul(a.float().transpose(-1, -2), grad)
            if ctx.b_group is not None:
                grad_b = all_reduce_(grad_b.contiguous(), ctx.b_group)
            grad_b = grad_b.to(b.dtype)
        return grad_a, grad_b, None


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               b_group=None) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) accumulated and returned in float32,
    as a JAX contraction with ``preferred_element_type=float32``: the
    compute-dtype products of ``MODEL.COMPUTE_DTYPE``.  ``b_group`` (a
    process group of a device mesh over whose ranks ``a`` is split by
    rows): ``b``'s cotangent is the sum of the ranks' partial cotangents,
    added in float32 before it is rounded to ``b``'s dtype."""
    if a.dtype == b.dtype == torch.float32 and b_group is None:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b, b_group)


def multi_link_project(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       ordinal_sharing: bool = False) -> torch.Tensor:
    """Project source features through per-rating weight matrices:
    ``proj[r] = x @ W_r + b_r`` with optional ordinal weight sharing
    ``W_r := sum_{j<=r} w_j``.

    Args:
      x: ``(num_src, feat_in)``.
      weight: ``(num_links, feat_in, units)``.
      bias: ``(num_links, units)``.

    Returns ``(num_links, num_src, units)``, float32 whatever the operands'
    dtype (bf16 operands: the product accumulates in float32 and the bias
    is added in float32, as in the JAX package).
    """
    if ordinal_sharing:
        weight = torch.cumsum(weight, dim=0)
        bias = torch.cumsum(bias, dim=0)
    if x.dtype == weight.dtype == torch.float32:
        # One batched product over all rating levels.
        return torch.baddbmm(bias[:, None, :],
                             x.expand(weight.shape[0], -1, -1), weight)
    R, f, units = weight.shape
    # Every rating level in one product: (N, F) @ (F, R * U).
    proj = matmul_f32(x, weight.permute(1, 0, 2).reshape(f, R * units))
    return (proj.reshape(-1, R, units) + bias.float()).permute(1, 0, 2)


def multi_link_aggregate(proj: torch.Tensor, edge_src: torch.Tensor,
                         edge_dst: torch.Tensor, edge_rating: torch.Tensor,
                         support: torch.Tensor, num_dst: int,
                         accum: str = "stack", backend: str = "xla",
                         dense_support: torch.Tensor | None = None,
                         dense_transposed: bool = False,
                         edge_chunk: int | None = None) -> torch.Tensor:
    """Per-rating-level weighted aggregation into destination nodes:
    ``out[d, r] = sum_{e: dst(e)=d, rating(e)=r} support[e] *
    proj[r, src(e)]``, then 'stack' (``(num_dst, num_links*units)``) or
    'sum' (``(num_dst, units)``).

    Args:
      proj: ``(num_links, num_src, units)``.
      edge_src / edge_dst / edge_rating: ``(E,)`` integer arrays.
      support: ``(E,)`` per-edge weight (0 for masked or padded edges).
      backend: ``"xla"`` | ``"dense"``.
      dense_support: for ``"dense"``, a prebuilt ``(num_links, num_dst,
        num_src)`` support, or ``(num_links, num_src, num_dst)`` with
        ``dense_transposed`` (one tensor serves both directions of a
        symmetric-normalised graph); built from the edges when None.
      edge_chunk: for ``"xla"``, edges per chunk (None: all at once).
    """
    num_links, num_src, units = proj.shape
    if backend == "dense":
        if dense_support is None:
            dense_support = build_dense_support(
                edge_src, edge_dst, edge_rating, support, num_links,
                num_dst, num_src)
        ds = dense_support.to(proj.dtype)
        if dense_transposed:
            ds = ds.transpose(1, 2)
        pooled = torch.bmm(ds, proj).permute(1, 0, 2)
    elif backend == "xla":
        gather_idx = edge_rating.long() * num_src + edge_src.long()
        seg_ids = edge_dst.long() * num_links + edge_rating.long()
        pooled = gather_weighted_segment_sum(
            proj.reshape(num_links * num_src, units), gather_idx, support,
            seg_ids, num_dst * num_links, chunk=edge_chunk,
        ).reshape(num_dst, num_links, units)
    else:
        raise ValueError(f"unknown backend: {backend!r}")
    if accum == "stack":
        return pooled.reshape(num_dst, num_links * units)
    if accum == "sum":
        return pooled.sum(dim=1)
    raise ValueError(f"unknown accum: {accum!r}")


def _adj_product(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``adj @ x`` batched, accumulated and returned in float32, for a
    ``(R, D, S)`` adjacency (any strides) and ``x`` ``(R, S, U)`` in the
    adjacency's dtype, or float32 (then ``x`` is taken as it is).  On a
    CUDA card a bf16 pair is one tensor-core product with float32 output;
    on the CPU, which has no such call, the float32 product of the same
    bf16 values."""
    if adj.dtype == torch.float32 or x.dtype == torch.float32:
        return torch.bmm(adj.float(), x.float())
    if adj.is_cuda:
        return torch.bmm(adj, x, out_dtype=torch.float32)
    return torch.bmm(adj.float(), x.float())


class _AdjacencyProduct(torch.autograd.Function):
    """``pooled = adj @ x`` (float32 out) for a constant 0/1 adjacency and
    ``x`` in its dtype.  The backward is the JAX package's transpose of a
    product with ``preferred_element_type=float32``: the float32
    cotangent times the adjacency, accumulated in float32, then rounded
    to ``x``'s dtype.  On the card, where a bf16 product takes no float32
    operand, the cotangent is split into two bf16 parts (its rounding and
    the rounding of what is left); the adjacency's entries are small
    integers, exact in bf16, so the two tensor-core products sum to the
    float32 product to within about 2^-16 of each term before the final
    rounding."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj)
        ctx.x_dtype = x.dtype
        return _adj_product(adj, x)

    @staticmethod
    def backward(ctx, grad):
        (adj,) = ctx.saved_tensors
        adj_t = adj.transpose(1, 2)
        grad = grad.contiguous()
        if adj.dtype == torch.bfloat16 and adj.is_cuda:
            hi = grad.to(torch.bfloat16)
            lo = (grad - hi.float()).to(torch.bfloat16)
            gx = _adj_product(adj_t, hi) + _adj_product(adj_t, lo)
        else:
            gx = torch.bmm(adj_t.float(), grad)
        return None, gx.to(ctx.x_dtype)


def scaled_dense_aggregate(proj: torch.Tensor, dense_adj: torch.Tensor,
                           dst_scale: torch.Tensor, src_scale: torch.Tensor,
                           transposed: bool = False) -> torch.Tensor:
    """Aggregate through a static dense 0/1 adjacency with the degree
    scalings folded around the product:
    ``out[d, r] = dst_scale[d] * sum_s adj[r, d, s] * src_scale[s] *
    proj[r, s]``.

    The scaled projection is rounded to the adjacency's dtype (bf16 by
    default; the 0/1 matrix is exact there) and the product accumulates
    in float32, as the JAX package's ``preferred_element_type=float32``
    contraction does; its gradient reaches ``proj`` rounded the same way.

    Args:
      proj: ``(R, num_src, U)``.
      dense_adj: ``(R, num_dst, num_src)``, or ``(R, num_src, num_dst)``
        with ``transposed`` (read through a transposed view, not copied).
      dst_scale: ``(num_dst,)``; src_scale: ``(num_src,)``.

    Returns ``(num_dst, R, U)``.
    """
    scaled = (proj * src_scale[None, :, None]).to(dense_adj.dtype)
    adj = dense_adj.transpose(1, 2) if transposed else dense_adj
    pooled = _AdjacencyProduct.apply(adj, scaled)
    return pooled.permute(1, 0, 2).to(proj.dtype) * dst_scale[:, None, None]


def removed_edges_correction(proj: torch.Tensor, rem_src: torch.Tensor,
                             rem_dst: torch.Tensor, rem_rating: torch.Tensor,
                             rem_weight: torch.Tensor,
                             num_dst: int) -> torch.Tensor:
    """Contribution of a small removed-edge set, to subtract from a
    static-adjacency aggregate; ``rem_weight`` carries the same dst*src
    scaling as the main term (0 for invalid slots).  Returns
    ``(num_dst, R, U)``."""
    num_links, num_src, units = proj.shape
    flat = proj.reshape(num_links * num_src, units)
    gathered = flat.index_select(
        0, rem_rating.long() * num_src + rem_src.long())
    seg = rem_dst.long() * num_links + rem_rating.long()
    return onehot_segment_sum(gathered * rem_weight[:, None], seg,
                              num_dst * num_links).reshape(
                                  num_dst, num_links, units)


def build_dense_adjacency(edge_src, edge_dst, edge_rating, edge_mask,
                          num_links, num_dst, num_src,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """The 0/1 adjacency ``(R, num_dst, num_src)`` of a graph variant,
    built once per variant: a float32 scatter of the mask, ``min(., 1)``,
    then a cast to ``dtype`` (bf16 by default: 0/1 is exact there)."""
    flat = torch.zeros(num_links * num_dst * num_src, dtype=torch.float32,
                       device=edge_src.device)
    idx = ((edge_rating.long() * num_dst + edge_dst.long()) * num_src
           + edge_src.long())
    flat.index_add_(0, idx, edge_mask.float())
    return flat.clamp_(max=1.0).reshape(num_links, num_dst, num_src).to(
        dtype)


def build_dense_support(edge_src, edge_dst, edge_rating, support,
                        num_links, num_dst, num_src,
                        dtype=torch.float32) -> torch.Tensor:
    """Scatter the per-edge support into ``(num_links, num_dst,
    num_src)`` for the ``"dense"`` backend (sensible only where that
    tensor fits in device memory: ML-100k and ML-1M)."""
    flat = torch.zeros(num_links * num_dst * num_src, dtype=dtype,
                       device=edge_src.device)
    idx = ((edge_rating.long() * num_dst + edge_dst.long()) * num_src
           + edge_src.long())
    flat = flat.index_add(0, idx, support.to(dtype))
    return flat.reshape(num_links, num_dst, num_src)


def masked_degrees(edge_src, edge_dst, edge_mask, num_src: int,
                   num_dst: int):
    """Total (cross-rating) degrees ``(deg_src, deg_dst)`` of the masked
    graph: one segment sum each."""
    deg_src = edge_mask.new_zeros(num_src).index_add_(
        0, edge_src.long(), edge_mask)
    deg_dst = edge_mask.new_zeros(num_dst).index_add_(
        0, edge_dst.long(), edge_mask)
    return deg_src, deg_dst


def edge_support(deg_src, deg_dst, edge_src, edge_dst, edge_mask,
                 symm: bool = True) -> torch.Tensor:
    """Per-edge GCN normalisation on the masked graph: ``1/sqrt(d_src *
    d_dst)`` (``symm``) or ``1/d_src``, 0 for a zero-degree endpoint and
    for masked edges."""
    d_s = deg_src.index_select(0, edge_src.long())
    zero = d_s.new_zeros(())
    if symm:
        denom = d_s * deg_dst.index_select(0, edge_dst.long())
        sup = torch.where(denom > 0, torch.rsqrt(denom.clamp_min(1e-12)),
                          zero)
    else:
        sup = torch.where(d_s > 0, 1.0 / d_s.clamp_min(1e-12), zero)
    return sup * edge_mask
