"""Chunked-ELL sparse aggregation: the ``ell`` full-graph backend.

The port of ``stargcn_tpu/ops/chunked_ell.py``.  The aggregation over a
rating graph is reformulated so that no E-row scatter appears in the
forward or the backward:

1. **Packing** (``build_chunked_ell``): each destination node's edge
   segment is split into width-``K`` virtual rows, giving ``(V, K)``
   index / rating arrays with ``V = sum_d ceil(deg(d) / K) ~ E / K``, the
   virtual rows sorted by destination.
2. **Pre-reduction**: gather the K source rows of each virtual row and
   contract them with a per-slot rating one-hot (a batched product) into
   one partial row per rating.
3. **Sorted segment sum**: the V partial rows (about K times fewer than E)
   ``index_add_`` into the per-(dst, rating) output.
4. **Backward through the transpose**: ``EllPoolRated`` routes the
   cotangent through the other direction's arrays (the same edges seen
   from the other side), i.e. the backward is another chunked pool.

Degree normalisation stays outside as separable scale vectors, so the
arrays are static per graph variant and a batch's edge removal is a rank-B
correction.  The path aggregates the raw source features and projects
afterwards, which equals the reference's project-then-pool because the
per-rating projection is linear.

Contract with the reference:

* ``build_chunked_ell`` / ``build_ell_pack`` give the reference's arrays
  array for array (its NumPy path: stable grouping by destination, the
  sentinel ``num_src`` in padded slots, padded rows pointing at
  ``num_dst - 1``, ``V`` padded to a multiple of ``row_pad``).  The pack is
  built with torch ops on the target device (one stable sort, a bincount,
  a cumulative sum and a scatter), int32 as in the reference.
* ``ell_pool_rated`` and ``ell_multi_link_aggregate`` compute the
  reference's sums in another order (``index_add_`` is atomic on the
  card), so they agree to float32 rounding, not bit for bit; with
  ``bf16`` the gathers read bf16 and the partial sums stay float32.  The
  backward accumulates in float32 in both modes (the reference's bf16
  backward sums in bf16) and casts the result to the input's dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stargcn_tpu_torch.ops.gather import onehot_segment_sum
from stargcn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EllArrays:
    """Chunked-ELL arrays for ONE aggregation direction, int32 tensors.

    ``src_idx[v, k]`` indexes the source-type nodes (``num_src`` = the
    zero-row sentinel for padded slots), ``rating[v, k]`` the rating level
    (0 on padded slots), ``row_dst[v]`` the destination of virtual row
    ``v`` (non-decreasing; ``num_dst - 1`` on padded rows, whose slots are
    all sentinels and contribute nothing).
    """

    src_idx: torch.Tensor   # (V, K) int32
    rating: torch.Tensor    # (V, K) int32
    row_dst: torch.Tensor   # (V,) int32, sorted non-decreasing
    num_src: int
    num_dst: int
    num_real_edges: int


def _as_long(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def build_chunked_ell(edge_src, edge_dst, edge_rating, num_src, num_dst,
                      K: int = 64, row_pad: int = 8, mask=None,
                      device="cuda") -> EllArrays:
    """Pack COO edges into width-``K`` virtual rows on ``device``.

    Edges are grouped by destination (a stable sort keeps their order
    within a node); each destination's segment is split into
    ``ceil(deg / K)`` rows; ``V`` is padded to a multiple of ``row_pad``.
    ``mask`` (optional float array, > 0 = keep) filters the edges.
    """
    dev = resolve_device(device)
    src = _as_long(edge_src, dev)
    dst = _as_long(edge_dst, dev)
    rat = _as_long(edge_rating, dev)
    if mask is not None:
        m = (mask if isinstance(mask, torch.Tensor)
             else torch.from_numpy(np.asarray(mask)))
        keep = m.to(dev) > 0
        src, dst, rat = src[keep], dst[keep], rat[keep]
    E = src.numel()

    dst_sorted, order = torch.sort(dst, stable=True)
    deg = torch.bincount(dst_sorted, minlength=num_dst)
    rows_per_dst = (deg + (K - 1)) // K                # ceil(deg / K)
    row_offset = torch.cumsum(rows_per_dst, 0) - rows_per_dst
    V = int(rows_per_dst.sum())
    V_pad = max(row_pad, -(-V // row_pad) * row_pad)

    # Rank of each edge within its destination segment.
    seg_start = torch.cumsum(deg, 0) - deg
    rank = torch.arange(E, device=dev) - seg_start[dst_sorted]
    flat = (row_offset[dst_sorted] + rank // K) * K + rank % K

    src_idx = torch.full((V_pad * K,), num_src, dtype=torch.int32,
                         device=dev)
    rating = torch.zeros(V_pad * K, dtype=torch.int32, device=dev)
    src_idx[flat] = src[order].to(torch.int32)
    rating[flat] = rat[order].to(torch.int32)
    row_dst = torch.full((V_pad,), max(num_dst - 1, 0), dtype=torch.int32,
                         device=dev)
    row_dst[:V] = torch.repeat_interleave(
        torch.arange(num_dst, dtype=torch.int32, device=dev), rows_per_dst,
        output_size=V)
    return EllArrays(src_idx=src_idx.reshape(V_pad, K),
                     rating=rating.reshape(V_pad, K), row_dst=row_dst,
                     num_src=int(num_src), num_dst=int(num_dst),
                     num_real_edges=int(E))


def build_ell_pack(edge_user, edge_item, edge_rating, edge_mask,
                   num_users, num_items, K: int = 64, device="cuda"):
    """Both directions' ELL arrays for one graph variant, as the dict the
    model reads (``{"user"|"item": {"idx", "rat", "row"}}``, the direction
    named by its destination type); each direction's arrays double as the
    other's backward arrays."""
    pack_u = build_chunked_ell(edge_item, edge_user, edge_rating,
                               num_src=num_items, num_dst=num_users, K=K,
                               mask=edge_mask, device=device)
    pack_i = build_chunked_ell(edge_user, edge_item, edge_rating,
                               num_src=num_users, num_dst=num_items, K=K,
                               mask=edge_mask, device=device)
    return {t: {"idx": p.src_idx, "rat": p.rating, "row": p.row_dst}
            for t, p in (("user", pack_u), ("item", pack_i))}


def pack_bytes(pack) -> int:
    """Device bytes of an ``build_ell_pack`` dict."""
    return sum(t.numel() * t.element_size() for d in pack.values()
               for t in d.values())


# --------------------------- device primitives ---------------------------


def _chunks(V, chunk):
    """``(start, end)`` of each chunk of ``chunk`` virtual rows (one chunk
    of all ``V`` when ``chunk`` is None or not smaller)."""
    step = V if chunk is None or chunk >= V else int(chunk)
    return [(s, min(s + step, V)) for s in range(0, V, max(step, 1))]


def _pool_rated_impl(x_pad, src_idx, rating, row_dst, num_dst, R, chunk):
    """``pooled[d, r, f] = sum over slots (v in rows(d), k) with
    rating[v, k] == r of x_pad[src_idx[v, k], f]``, ``(num_dst, R, F)`` in
    ``x_pad``'s dtype, the partial sums in float32.  Each chunk of virtual
    rows is gathered ``(C, K, F)``, contracted with its rating one-hot into
    ``(C, R, F)`` and added into its destination rows."""
    V, K = src_idx.shape
    F = x_pad.shape[1]
    ar = torch.arange(R, dtype=rating.dtype, device=rating.device)
    out = torch.zeros(num_dst, R * F, dtype=torch.float32,
                      device=x_pad.device)
    for s, e in _chunks(V, chunk):
        C = e - s
        msg = x_pad.index_select(0, src_idx[s:e].reshape(-1)).reshape(
            C, K, F)
        onehot = (rating[s:e, :, None] == ar).to(torch.float32)
        partial = torch.bmm(onehot.transpose(1, 2), msg.float())
        out.index_add_(0, row_dst[s:e], partial.reshape(C, R * F))
    return out.reshape(num_dst, R, F).to(x_pad.dtype)


def _pool_flat_impl(table_pad, flat_idx, row_dst, num_rows, chunk):
    """``out[s, f] = sum over slots (v in rows(s), k) of
    table_pad[flat_idx[v, k], f]``, float32: the flat pool of the
    backward."""
    V, K = flat_idx.shape
    F = table_pad.shape[1]
    out = torch.zeros(num_rows, F, dtype=torch.float32,
                      device=table_pad.device)
    for s, e in _chunks(V, chunk):
        partial = table_pad.index_select(0, flat_idx[s:e].reshape(-1)) \
            .reshape(e - s, K, F).float().sum(dim=1)
        out.index_add_(0, row_dst[s:e], partial)
    return out


class EllPoolRated(torch.autograd.Function):
    """Per-rating pooled aggregation over chunked ELL whose backward runs
    over the transpose arrays (the reference's ``custom_vjp``).  It saves
    only those arrays: no gathered rows are kept for the backward."""

    @staticmethod
    def forward(ctx, x_pad, f_idx, f_rat, f_row, b_idx, b_rat, b_row,
                num_dst, num_src, R, chunk):
        ctx.save_for_backward(b_idx, b_rat, b_row)
        ctx.shape = (num_dst, num_src, R, chunk)
        return _pool_rated_impl(x_pad, f_idx, f_rat, f_row, num_dst, R,
                                chunk)

    @staticmethod
    def backward(ctx, g):
        b_idx, b_rat, b_row = ctx.saved_tensors
        num_dst, num_src, R, chunk = ctx.shape
        F = g.shape[-1]
        # d_x[s] = sum over edges e with src(e) = s of g[dst(e), rating(e)]:
        # the chunked pool over the transpose arrays, gathering from the
        # flattened (dst, rating) cotangent table.  Padded slots hold
        # src_idx == num_dst and rating 0, so their combined index lands on
        # the zero sentinel row num_dst * R.
        table = torch.cat([g.reshape(num_dst * R, F),
                           g.new_zeros(1, F)], dim=0)
        flat_idx = b_idx * R + b_rat
        d_main = _pool_flat_impl(table, flat_idx, b_row, num_src, chunk)
        d_x = torch.cat([d_main.to(g.dtype), g.new_zeros(1, F)], dim=0)
        return (d_x,) + (None,) * 10


def ell_pool_rated(x_pad, f_idx, f_rat, f_row, b_idx, b_rat, b_row,
                   num_dst, num_src, R, chunk=None):
    """Differentiable per-rating pooled aggregation over chunked ELL.

    Args:
      x_pad: ``(num_src + 1, F)`` source features with a trailing ZERO row
        (the sentinel target of padded slots).
      f_*: forward-direction arrays (rows = dst nodes).
      b_*: transpose-direction arrays (rows = src nodes), read only by the
        backward.
      chunk: virtual rows per gather (``KERNEL.ELL_CHUNK``); None = all.

    Returns ``(num_dst, R, F)`` in ``x_pad``'s dtype.
    """
    return EllPoolRated.apply(x_pad, f_idx, f_rat, f_row, b_idx, b_rat,
                              b_row, num_dst, num_src, R, chunk)


# ----------------------------- aggregator op -----------------------------


def ell_multi_link_aggregate(x, ell_static, weight, bias,
                             ordinal_sharing: bool, accum: str):
    """Full multi-link aggregation through an ``EllStatic`` operand pack
    (aggregate, then project; linear-equivalent to the reference's
    project-then-pool):

      ``pooled[d, r] = dst_scale[d] * sum_{e -> d, rating r}
                           src_scale[s_e] * [x[s_e], 1]``
      ``out[d, r] = pooled[d, r] @ [W_r; b_r]``

    The appended ones column carries the per-link bias through the
    support-weighted pooling (the bias scaled by the segment's support
    sum).  Only the pool has a custom backward: the gradient reaches ``x``
    through the ``src_scale`` product and the ones column.
    """
    es = ell_static
    num_src = x.shape[0]
    num_dst = es.dst_scale.shape[0]
    R = weight.shape[0]
    # Dtypes promote as the reference's do (a bf16 x meets float32
    # scales in float32).
    x_aug = torch.cat([x, x.new_ones(num_src, 1)], dim=1) \
        * es.src_scale[:, None]
    cdtype = torch.bfloat16 if es.bf16 else x.dtype
    x_pad = torch.cat([x_aug, x_aug.new_zeros(1, x_aug.shape[1])],
                      dim=0).to(cdtype)
    pooled = ell_pool_rated(
        x_pad, es.f_idx, es.f_rat, es.f_row, es.b_idx, es.b_rat, es.b_row,
        num_dst, num_src, R, es.chunk).to(x.dtype)
    if es.rem_src is not None:
        # Rank-B removed-edge correction (REMOVE_RATING): subtract the
        # batch edges' contributions before the dst scaling.
        gathered = x_aug.index_select(0, es.rem_src.long()) \
            * es.rem_weight[:, None]
        seg = es.rem_dst.long() * R + es.rem_rating.long()
        corr = onehot_segment_sum(gathered, seg, num_dst * R).reshape(
            num_dst, R, -1)
        pooled = pooled - corr
    pooled = pooled * es.dst_scale[:, None, None]

    w_aug = torch.cat([weight, bias[:, None, :]], dim=1)
    if ordinal_sharing:
        w_aug = torch.cumsum(w_aug, dim=0)
    out = torch.einsum("drf,rfu->dru", pooled.float(),
                       w_aug.float()).to(x.dtype)
    if accum == "stack":
        return out.reshape(num_dst, -1)
    if accum == "sum":
        return out.sum(dim=1)
    raise ValueError(f"unknown accum: {accum!r}")
