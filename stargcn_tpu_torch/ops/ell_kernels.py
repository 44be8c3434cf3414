"""Neighbor aggregation over a fixed-fanout (ELL) adjacency: the three
hand-written kernels of sampled mode.

The port of ``stargcn_tpu/ops/pallas_kernels.py``.  Adjacency is a dense
``(num_dst, K)`` neighbor-index matrix and a weight matrix of the same
shape, padded with ``weight == 0`` slots (padded slots may hold any
index):

* ``ell_spmm_fwd_only``: ``out[i] = sum_k w[i, k] * values[idx[i, k]]``
  (``ops/csrc/ell_spmm.cu``);
* ``ell_sddmm``: ``out[i, k] = dot(q[i], values[idx[i, k]])``, every slot
  (``ops/csrc/ell_sddmm.cu``);
* ``ell_spmm_transpose``: ``d_values[s] = sum_{(i, k): idx[i, k] == s}
  w[i, k] * g[i]`` (``ops/csrc/ell_spmm_t.cu``, which also orders the slots
  by source row on the card; ``order_slots`` stops after that ordering);
* ``ell_spmm``: the differentiable pooling that wires the three as each
  other's adjoints.

The TPU kernels express gather and scatter as one-hot matrix products; on
a CUDA card they are a row gather, a gathered inner product and a sorted
segment sum.  Everything is float32 in, float32 sums, float32 out, as the
reference computes in interpret mode and as ``ref_ell_spmm`` /
``ref_ell_sddmm`` define.  An index outside ``[0, num_src)`` contributes 0
(in the Pallas kernels it matches no column), in the kernels and in the
plain versions alike.

Each wrapper launches its CUDA kernel on tensors that lie on the card and
takes its plain PyTorch version (``plain_*``) on tensors that lie on the
CPU; mixed devices, other dtypes and non-contiguous inputs raise.
"""

from __future__ import annotations

import torch

# Launches of each kernel wrapper on the card (the plain versions are not
# counted).  A run sets these to 0, drives its path, and reads them.
LAUNCHES = {"ell_spmm_fwd_only": 0, "ell_sddmm": 0, "ell_spmm_transpose": 0}


# ----------------------------- plain versions -----------------------------


def _in_range(nbr_idx, num_src):
    ok = (nbr_idx >= 0) & (nbr_idx < num_src)
    return ok, torch.where(ok, nbr_idx, torch.zeros_like(nbr_idx)).long()


def _gather_slots(values, safe):
    """``values[safe]`` ``(N, K, F)`` by ``index_select``, whose gradient
    is an ``index_add_`` (that of advanced indexing walks runs of equal
    indices serially, and padded slots all name one row)."""
    n, k = safe.shape
    return values.index_select(0, safe.reshape(-1)).reshape(n, k, -1)


def plain_ell_spmm(values, nbr_idx, nbr_weight):
    """Plain PyTorch version of ``ell_spmm_fwd_only`` (differentiable by
    ordinary autograd in ``values`` and ``nbr_weight``)."""
    ok, safe = _in_range(nbr_idx, values.shape[0])
    w = nbr_weight * ok.to(nbr_weight.dtype)
    return torch.einsum("nkf,nk->nf", _gather_slots(values, safe), w)


def plain_ell_sddmm(queries, values, nbr_idx):
    """Plain PyTorch version of ``ell_sddmm``."""
    ok, safe = _in_range(nbr_idx, values.shape[0])
    return torch.einsum("nf,nkf->nk", queries,
                        _gather_slots(values, safe)) * ok.to(queries.dtype)


def plain_ell_spmm_transpose(cotangent, nbr_idx, nbr_weight, num_src):
    """Plain PyTorch version of ``ell_spmm_transpose`` (``index_add_``)."""
    num_dst, k = nbr_idx.shape
    ok, safe = _in_range(nbr_idx, num_src)
    w = nbr_weight * ok.to(nbr_weight.dtype)
    msg = (w[:, :, None] * cotangent[:, None, :]).reshape(num_dst * k, -1)
    out = cotangent.new_zeros((num_src, cotangent.shape[1]))
    return out.index_add_(0, safe.reshape(-1), msg)


# -------------------------------- wrappers --------------------------------


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _check(name, rows, nbr_idx, nbr_weight, fits):
    """Raise unless every tensor lies on one CUDA device and is 2-D and
    contiguous, the feature matrices ``rows`` (label -> tensor) are float32
    and aligned to the kernels' vector load (16, 8 or 4 bytes: the widest of
    4, 2 or 1 floats that divides the feature width), ``nbr_idx`` is int32
    and ``nbr_weight`` (or ``None``) float32, the shapes fit each other
    (``fits``) and every size fits the kernels' int arguments.  Returns the
    device."""
    floats = dict(rows)
    if nbr_weight is not None:
        floats["nbr_weight"] = nbr_weight
    named = {**floats, "nbr_idx": nbr_idx}
    dev = nbr_idx.device
    if not all(t.is_cuda and t.device == dev for t in named.values()):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device "
                         f"(got {[str(t.device) for t in named.values()]})")
    for label, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 {label} (got {t.dtype})")
    if nbr_idx.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 nbr_idx (got {nbr_idx.dtype})")
    for label, t in named.items():
        if t.dim() != 2:
            raise ValueError(f"{name} takes 2-D {label}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous {label}")
    for label, t in rows.items():
        f = t.shape[1]
        align = 16 if f % 4 == 0 else 8 if f % 2 == 0 else 4
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {label} must be {align}-byte aligned")
    if not fits:
        shapes = ", ".join(f"{label} {tuple(t.shape)}"
                           for label, t in named.items())
        raise ValueError(f"{name}: shapes do not fit ({shapes})")
    if max(max(t.shape) for t in named.values()) >= 2**31 \
            or nbr_idx.numel() >= 2**31:
        raise ValueError(f"{name}: dimension exceeds int32")
    return dev


def _launch(lib, name, dev, *args, count=True):
    from stargcn_tpu_torch.ops import _build

    err = _build.call_on(dev, _build.load(lib), *args,
                         _build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    if count:
        LAUNCHES[name] += 1


def ell_spmm_fwd_only(values, nbr_idx, nbr_weight):
    """``out[i] = sum_k nbr_weight[i, k] * values[nbr_idx[i, k]]`` (no
    gradient).

    Args:
      values: ``(num_src, feat)`` float32.
      nbr_idx: ``(num_dst, K)`` int32, padded slots may hold any index.
      nbr_weight: ``(num_dst, K)`` float32, 0 on padded slots.

    Returns ``(num_dst, feat)`` float32.  On the card this launches
    ``ops/csrc/ell_spmm.cu``; on the CPU it is ``plain_ell_spmm``.
    """
    if _on_cpu(values, nbr_idx, nbr_weight):
        return plain_ell_spmm(values, nbr_idx, nbr_weight)
    dev = _check("ell_spmm_fwd_only", {"values": values}, nbr_idx,
                 nbr_weight, nbr_idx.shape == nbr_weight.shape)
    (num_src, f), (num_dst, k) = values.shape, nbr_idx.shape
    if num_dst == 0 or f == 0 or k == 0 or num_src == 0:
        return values.new_zeros((num_dst, f))
    out = torch.empty((num_dst, f), dtype=torch.float32, device=dev)
    _launch("ell_spmm", "ell_spmm_fwd_only", dev, values.data_ptr(),
            nbr_idx.data_ptr(), nbr_weight.data_ptr(), out.data_ptr(),
            num_dst, k, num_src, f)
    return out


def sddmm_plan(f):
    """``(vec, width, gathers)`` of ``ops/csrc/ell_sddmm.cu`` at feature
    width ``f``: floats a lane loads at once (the widest of 4, 2, 1 that
    divides ``f``), lanes that share one slot's columns, and leader rows a
    lane gathers before any sum.

    ``width`` is 32 where a slot's columns fill a warp; at ``f / vec <=
    16`` it is the least power of two of at least ``f / vec`` lanes, 4 at
    the least, so that ``32 / width`` slots share a warp.  ``gathers`` is
    the kernel's own (1 at width 32, where a warp's row gathers are enough
    and fewer registers keep more rows in flight; ``min(width, 8)`` below
    it): the launch passes ``vec`` and ``width``.
    """
    vec = 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1
    lanes = f // vec
    width = 32 if lanes > 16 else max(4, 1 << (lanes - 1).bit_length())
    return vec, width, 1 if width == 32 else min(width, 8)


def ell_sddmm(queries, values, nbr_idx):
    """``out[i, k] = dot(queries[i], values[nbr_idx[i, k]])`` for every
    slot, padded ones too.

    Args:
      queries: ``(num_dst, feat)`` float32.
      values: ``(num_src, feat)`` float32.
      nbr_idx: ``(num_dst, K)`` int32.

    Returns ``(num_dst, K)`` float32.  On the card this launches
    ``ops/csrc/ell_sddmm.cu`` with ``sddmm_plan(feat)``; on the CPU it is
    ``plain_ell_sddmm``.
    """
    if _on_cpu(queries, values, nbr_idx):
        return plain_ell_sddmm(queries, values, nbr_idx)
    dev = _check("ell_sddmm", {"queries": queries, "values": values},
                 nbr_idx, None,
                 queries.shape[0] == nbr_idx.shape[0]
                 and queries.shape[1] == values.shape[1])
    (num_src, f), (num_dst, k) = values.shape, nbr_idx.shape
    if num_dst == 0 or f == 0 or k == 0 or num_src == 0:
        return queries.new_zeros((num_dst, k))
    out = torch.empty((num_dst, k), dtype=torch.float32, device=dev)
    vec, width, _ = sddmm_plan(f)
    _launch("ell_sddmm", "ell_sddmm", dev, queries.data_ptr(),
            values.data_ptr(), nbr_idx.data_ptr(), out.data_ptr(), num_dst,
            k, num_src, f, vec, width)
    return out


def sort_slots(nbr_idx, nbr_weight, num_src):
    """Order the live slots of an ELL block by source index: ``(seg_ptr,
    dst_sorted, w_sorted)``, the plain version of ``order_slots``.

    A slot is live when its weight is not 0 and its index lies in
    ``[0, num_src)``.  The sort is stable, so each source row's run lists
    its slots in ascending ``(i, k)`` order.  ``seg_ptr`` is ``(num_src +
    1,)`` int32, ``dst_sorted`` (int32) and ``w_sorted`` (float32) have one
    entry per slot; entries past ``seg_ptr[-1]`` belong to dead slots.  It
    depends on the block only, not on the cotangent.
    """
    k = nbr_idx.shape[1]
    flat_idx, flat_w = nbr_idx.reshape(-1), nbr_weight.reshape(-1)
    live = (flat_w != 0) & (flat_idx >= 0) & (flat_idx < num_src)
    key = torch.where(live, flat_idx, torch.full_like(flat_idx, num_src))
    key_sorted, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_src + 1, dtype=torch.int32,
                          device=nbr_idx.device)
    seg_ptr = torch.searchsorted(key_sorted, bounds, out_int32=True)
    dst_sorted = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    return seg_ptr, dst_sorted, flat_w[order]


# Runs of at most this many live slots are put in order a thread a slot
# (each counts the run's slot ids below its own); longer runs a block each
# (a bitmap over the slot ids).  ``ops/csrc/ell_spmm_t.cu`` takes it as an
# argument.
SHORT_RUN = 512
# Sorted slots a warp of the sum takes, and counts a block of the scan
# takes: ell_spmm_t.cu's kChunk and kScanTile, which size the scratch.
CHUNK = 32
SCAN_TILE = 1024


def _up64(n):
    return (n + 63) // 64 * 64


def _order_layout(n_slots, num_src, f, short_run):
    """``(elements, dst offset, w offset)`` of the int32 scratch of
    ``ops/csrc/ell_spmm_t.cu``, as its ``make_layout`` lays it out (the C
    entry refuses a smaller scratch).  ``f`` is 0 for the ordering alone;
    ``seg_ptr`` starts at 0."""
    n_chunks = -(-n_slots // CHUNK)
    n_tiles = -(-num_src // SCAN_TILE)
    dst = _up64(num_src + 1)
    w = dst + _up64(n_slots)
    at = _up64(w + _up64(n_slots) + num_src + n_chunks + 2)
    at += _up64(n_slots) + _up64(n_tiles)
    at += _up64(n_slots // (short_run + 1) + 1) + 4 * _up64(n_slots)
    return at + 2 * n_chunks * f, dst, w


def _transpose_call(name, cotangent, nbr_idx, nbr_weight, num_src,
                    short_run, out):
    """Check the operands and launch ``ell_spmm_t.cu``: the ordering, and
    the sum into ``out`` where ``out`` is given.  Returns the scratch and
    the offsets of ``dst_sorted`` and ``w_sorted`` in it."""
    rows = {} if out is None else {"cotangent": cotangent}
    dev = _check(name, rows, nbr_idx, nbr_weight,
                 nbr_idx.shape == nbr_weight.shape
                 and (out is None or cotangent.shape[0] == nbr_idx.shape[0])
                 and 0 <= num_src < 2**31 - 1 and 1 <= short_run <= 2**30)
    f = 0 if out is None else out.shape[1]
    total, dst, w = _order_layout(nbr_idx.numel(), num_src, f, short_run)
    ws = torch.empty(total, dtype=torch.int32, device=dev)
    _launch("ell_spmm_t", name, dev,
            None if out is None else cotangent.data_ptr(),
            nbr_idx.data_ptr(), nbr_weight.data_ptr(),
            None if out is None else out.data_ptr(), ws.data_ptr(), total,
            nbr_idx.shape[0], nbr_idx.shape[1], num_src, f, short_run,
            count=out is not None)
    return ws, dst, w


def order_slots(nbr_idx, nbr_weight, num_src, short_run=SHORT_RUN):
    """``sort_slots`` on the card: the ordering that ``ell_spmm_transpose``
    runs before its sum, and nothing after it.

    Returns ``(seg_ptr, dst_sorted, w_sorted)`` as ``sort_slots`` defines
    them, except that entries past ``seg_ptr[-1]`` are left unset.  On the
    card this launches the ordering kernels of ``ops/csrc/ell_spmm_t.cu``
    (a counting sort; ``short_run`` is where a run's order passes from a
    thread a slot to a block) and counts no launch: it checks the
    ordering and lies on no path.  On the CPU it is ``sort_slots``.
    """
    if _on_cpu(nbr_idx, nbr_weight):
        return sort_slots(nbr_idx, nbr_weight, num_src)
    n = nbr_idx.numel()
    if num_src == 0 or n == 0:
        dev = _check("order_slots", {}, nbr_idx, nbr_weight,
                     nbr_idx.shape == nbr_weight.shape and num_src >= 0)
        return (torch.zeros(num_src + 1, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev))
    ws, dst, w = _transpose_call("order_slots", None, nbr_idx, nbr_weight,
                                 num_src, short_run, None)
    return (ws[:num_src + 1], ws[dst:dst + n],
            ws[w:w + n].view(torch.float32))


def ell_spmm_transpose(cotangent, nbr_idx, nbr_weight, num_src):
    """``d_values[s] = sum_{(i, k): nbr_idx[i, k] == s} nbr_weight[i, k] *
    cotangent[i]``: the scatter adjoint of ``ell_spmm_fwd_only``.

    Args:
      cotangent: ``(num_dst, feat)`` float32.
      nbr_idx, nbr_weight: ``(num_dst, K)`` int32 / float32.
      num_src: rows of the result.

    Returns ``(num_src, feat)`` float32.  On the card one call of
    ``ops/csrc/ell_spmm_t.cu`` orders the slots by source row (what
    ``order_slots`` does) and sums each row's run in that fixed order, so
    two launches give the same bits; on the CPU it is
    ``plain_ell_spmm_transpose``.
    """
    if _on_cpu(cotangent, nbr_idx, nbr_weight):
        return plain_ell_spmm_transpose(cotangent, nbr_idx, nbr_weight,
                                        num_src)
    fits = (nbr_idx.shape == nbr_weight.shape
            and cotangent.shape[0] == nbr_idx.shape[0] and num_src >= 0)
    f = cotangent.shape[1] if cotangent.dim() == 2 else 0
    if num_src == 0 or f == 0 or nbr_idx.numel() == 0:
        _check("ell_spmm_transpose", {"cotangent": cotangent}, nbr_idx,
               nbr_weight, fits)
        return cotangent.new_zeros((num_src, f))
    out = torch.empty((num_src, f), dtype=torch.float32,
                      device=cotangent.device)
    _transpose_call("ell_spmm_transpose", cotangent, nbr_idx, nbr_weight,
                    num_src, SHORT_RUN, out)
    return out


# --------------------------- differentiable op ---------------------------


class _EllSpmm(torch.autograd.Function):
    """Forward ``ell_spmm_fwd_only``; backward ``ell_spmm_transpose`` for
    ``values`` and ``ell_sddmm`` for ``nbr_weight``, each only when its
    gradient is asked for.  ``values`` (the whole projected frontier) is
    kept for the backward only when the weight gradient is wanted."""

    @staticmethod
    def forward(ctx, values, nbr_idx, nbr_weight):
        ctx.num_src = values.shape[0]
        ctx.save_for_backward(
            nbr_idx, nbr_weight,
            values if ctx.needs_input_grad[2] else None)
        return ell_spmm_fwd_only(values, nbr_idx, nbr_weight)

    @staticmethod
    def backward(ctx, cotangent):
        nbr_idx, nbr_weight, values = ctx.saved_tensors
        cotangent = cotangent.contiguous()
        d_values = d_weight = None
        if ctx.needs_input_grad[0]:
            d_values = ell_spmm_transpose(cotangent, nbr_idx, nbr_weight,
                                          ctx.num_src)
        if ctx.needs_input_grad[2]:
            d_weight = ell_sddmm(cotangent, values, nbr_idx)
        return d_values, None, d_weight


def ell_spmm(values, nbr_idx, nbr_weight):
    """Differentiable fixed-fanout weighted neighbor aggregation:
    ``out[i] = sum_k nbr_weight[i, k] * values[nbr_idx[i, k]]`` with
    ``d_values`` the transpose scatter of the weighted cotangent and
    ``d_weight`` the SDDMM of cotangent and values."""
    return _EllSpmm.apply(values, nbr_idx, nbr_weight)
