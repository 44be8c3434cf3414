"""Bit-packed dense multi-link aggregation (the ``bitdense`` backend).

The port of ``stargcn_tpu/ops/bitdense.py``, forward only.  The one-hot
multi-link adjacency ``S[r, d, s] = 1 iff edge (d <- s) has rating level
r`` is packed at one bit per entry:

    ``P[r * D8 + d8, s]`` bit ``b``  =  ``S[r, b * D8 + d8, s]``

with ``D8 = D_pad / 8``.  Expanding bit plane ``b`` of a row block yields
the adjacency rows of destinations ``b*D8 + d8``, so an output laid out
``(R, 8, D8, F)`` is in natural destination order after a reshape.

``bit_expand_matmul`` is the CUDA kernel ``ops/csrc/bit_expand.cu`` on a
tensor that lies on the card, and its plain version ``xla_expand_matmul``
on one that lies on the CPU.  Padding follows the JAX package (``_BM``,
``_BS``: node counts padded to a multiple of 1024) so packs compare byte
for byte.  The backward (``bit_reduce_matmul``) comes with the training
slice; until then the export runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BM = 128
_BS = 1024

# Launches of each kernel wrapper on the card (the plain versions are not
# counted).  A run sets these to 0, drives its path, and reads them.
LAUNCHES = {"bit_expand_matmul": 0}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ------------------------------- packing -------------------------------


def node_pad(n: int, bm: int = _BM, bs: int = _BS) -> int:
    """Padded node count serving both roles of a type: ``8 * (multiple
    of bm)`` as the packed (destination) axis, a multiple of ``bs`` as the
    source axis."""
    m = np.lcm(8 * bm, bs)
    return _round_up(max(n, 1), int(m))


def pad_dims(num_dst: int, num_src: int, bm: int = _BM, bs: int = _BS):
    """(D8, D_pad, S_pad) for a packed layout with dst packed 8-deep."""
    d_pad = node_pad(num_dst, bm, bs)
    return d_pad // 8, d_pad, node_pad(num_src, bm, bs)


def pack_bits(edge_dst, edge_src, edge_rating, num_links, num_dst,
              num_src, mask=None, bm: int = _BM, bs: int = _BS):
    """Bit-pack one direction's multi-link adjacency (NumPy).

    Returns ``(P, D8)`` with ``P`` of shape ``(num_links * D8, S_pad)``
    uint8, bit ``b`` of ``P[r*D8 + d8, s]`` set iff edge
    ``(dst = b*D8 + d8  <-  src = s)`` carries rating level ``r`` (and
    ``mask > 0``).  Duplicate edges collapse (one-hot semantics).
    """
    d8, _, s_pad = pad_dims(num_dst, num_src, bm, bs)
    edge_dst = np.asarray(edge_dst, np.int64)
    edge_src = np.asarray(edge_src, np.int64)
    edge_rating = np.asarray(edge_rating, np.int64)
    if mask is not None:
        keep = np.asarray(mask) > 0
        edge_dst, edge_src, edge_rating = (
            edge_dst[keep], edge_src[keep], edge_rating[keep])
    P = np.zeros((num_links * d8) * s_pad, np.uint8)
    b = edge_dst // d8
    flat = (edge_rating * d8 + edge_dst % d8) * s_pad + edge_src
    # One fancy-indexed OR per bit plane: within a plane all writes carry
    # the same value, so duplicate indices are benign.
    for bit in range(8):
        sel = b == bit
        if sel.any():
            P[flat[sel]] |= np.uint8(1 << bit)
    return P.reshape(num_links * d8, s_pad), d8


def build_bit_pack(edge_user, edge_item, edge_rating, edge_mask,
                   num_users, num_items, num_links, device,
                   bm: int = _BM, bs: int = _BS):
    """Both layouts for one graph variant, as uint8 tensors on ``device``:
    ``{'user': {'pf', 'pb'}, 'item': {'pf', 'pb'}}``, where entry ``t``
    drives aggregation into type ``t`` (``pf`` = that direction's layout,
    ``pb`` = the transpose layout its backward will read)."""
    pa, _ = pack_bits(edge_user, edge_item, edge_rating, num_links,
                      num_users, num_items, mask=edge_mask, bm=bm, bs=bs)
    pb, _ = pack_bits(edge_item, edge_user, edge_rating, num_links,
                      num_items, num_users, mask=edge_mask, bm=bm, bs=bs)
    ta = torch.from_numpy(pa).to(device)
    tb = torch.from_numpy(pb).to(device)
    return {"user": {"pf": ta, "pb": tb}, "item": {"pf": tb, "pb": ta}}


def resolve_impl(impl: str) -> str:
    """Which pooling engine ``bit_pool_rated`` calls, from the config's
    ``KERNEL.BIT_IMPL``: ``'auto'`` and ``'pallas'`` give ``'kernel'``
    (the ``bit_expand_matmul`` wrapper: the CUDA kernel for a tensor on
    the card, its plain version for one on the CPU), ``'xla'`` gives
    ``'plain'`` (``xla_expand_matmul`` on any device)."""
    if impl in ("auto", "pallas"):
        return "kernel"
    if impl == "xla":
        return "plain"
    if impl == "pallas16":
        raise NotImplementedError(
            "bit_impl 'pallas16' (row-interleaved packs) comes as a layout "
            "flag on the bitdense kernels in a later slice")
    raise ValueError(f"unknown bit_impl: {impl!r}")


# ------------------------------ the kernel ------------------------------


def bit_expand_matmul(P: torch.Tensor, x: torch.Tensor, num_links: int,
                      d8: int) -> torch.Tensor:
    """``out[r, b, m, f] = sum_s bit_b(P[r*d8+m, s]) x[s, f]``.

    Args:
      P: ``(num_links * d8, S_pad)`` uint8, contiguous.
      x: ``(S_pad, F)`` float32 or bfloat16, contiguous.

    Returns ``(num_links, 8, d8, F)`` float32.  On the card this launches
    ``ops/csrc/bit_expand.cu``, which rounds x to bf16 and sums in f32, as
    the TPU kernel does.  On the CPU it is ``xla_expand_matmul`` in x's
    own precision, as the JAX package's CPU path is.
    """
    if P.device.type == "cpu" and x.device.type == "cpu":
        return xla_expand_matmul(P, x, num_links, d8)
    if not (P.is_cuda and x.is_cuda and P.device == x.device):
        raise ValueError("bit_expand_matmul: P and x must lie on one CUDA "
                         f"device (got {P.device} and {x.device})")
    if P.dtype != torch.uint8 or x.dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise TypeError("bit_expand_matmul takes uint8 P and float32 or "
                        f"bfloat16 x (got {P.dtype} and {x.dtype})")
    if P.dim() != 2 or x.dim() != 2:
        raise ValueError("bit_expand_matmul takes 2-D P and x")
    m8, s_pad = P.shape
    f = x.shape[1]
    if m8 != num_links * d8 or x.shape[0] != s_pad:
        raise ValueError(
            f"bit_expand_matmul: P {tuple(P.shape)} and x {tuple(x.shape)} "
            f"do not fit num_links={num_links}, d8={d8}")
    if not (P.is_contiguous() and x.is_contiguous()):
        raise ValueError("bit_expand_matmul takes contiguous P and x")
    if s_pad % 16 or P.data_ptr() % 16:
        raise ValueError("bit_expand_matmul: P rows must be 16-byte "
                         "aligned (S_pad % 16 == 0)")
    if max(m8, s_pad, f) >= 2**31:
        raise ValueError("bit_expand_matmul: dimension exceeds int32")
    out = torch.empty((num_links, 8, d8, f), dtype=torch.float32,
                      device=P.device)
    if out.numel() == 0:
        return out
    from stargcn_tpu_torch.ops import _build

    fn = _build.load("bit_expand")
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = fn(P.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
                 out.data_ptr(), m8, s_pad, f, d8, stream)
    if err != 0:
        raise RuntimeError(f"bit_expand_matmul: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["bit_expand_matmul"] += 1
    return out


def xla_expand_matmul(P: torch.Tensor, x: torch.Tensor, num_links: int,
                      d8: int, chunk_bytes: int = 1 << 29) -> torch.Tensor:
    """Plain PyTorch version of ``bit_expand_matmul`` (the counterpart of
    ``stargcn_tpu.ops.bitdense.xla_expand_matmul``): unpack the eight bit
    planes and contract with x, in x's own precision with an f32 sum.

    Works over blocks of packed rows whose f32 planes stay under
    ``chunk_bytes``, so it also runs at the full ML-10M shape, where all
    planes at once would take ~32 GB.  Returns ``(num_links, 8, d8, F)``
    float32 (a permuted view).
    """
    m8, s_pad = P.shape
    f = x.shape[1]
    # bf16 values are exact in f32, so an f32 contraction is the JAX
    # function's bf16 product with f32 accumulation.
    xf = x.float()
    shifts = torch.arange(8, dtype=torch.uint8, device=P.device)
    rows = max(1, chunk_bytes // max(1, 8 * s_pad * 4))
    out = torch.empty((8, m8, f), dtype=torch.float32, device=P.device)
    for lo in range(0, m8, rows):
        blk = P[lo:lo + rows]
        planes = ((blk[None] >> shifts[:, None, None]) & 1).float()
        out[:, lo:lo + rows] = torch.matmul(planes, xf)
    return out.reshape(8, num_links, d8, f).permute(1, 0, 2, 3)


# ------------------------------ aggregation ------------------------------


def bit_pool_rated(x, p_fwd, num_links, d8_dst, impl="kernel"):
    """Per-rating pooled aggregation over packed bits (forward).

    Args:
      x: ``(S_pad, F)`` source features (padded rows are never read: no
        bits are set for them).
      p_fwd: ``(num_links * d8_dst, S_pad)`` uint8 — this direction.
      impl: ``'kernel'`` | ``'plain'`` (see ``resolve_impl``).

    Returns ``(8 * d8_dst, num_links, F)`` f32, indexed by the natural
    destination id.
    """
    if impl == "plain":
        out = xla_expand_matmul(p_fwd, x, num_links, d8_dst)
    else:
        out = bit_expand_matmul(p_fwd, x, num_links, d8_dst)
    # (R, 8, d8, F) -> (8*d8, R, F), natural dst index.
    return out.permute(1, 2, 0, 3).reshape(8 * d8_dst, num_links, -1)


def bit_multi_link_aggregate(x, bit_static, weight, bias,
                             ordinal_sharing: bool, accum: str):
    """Multi-link aggregation through a ``BitStatic`` operand pack:
    aggregate-then-project, with the per-link bias carried by a ones
    column through the pooling and separable degree scales around it
    (``stargcn_tpu.ops.bitdense.bit_multi_link_aggregate``)."""
    bs = bit_static
    num_src = x.shape[0]
    num_dst = bs.dst_scale.shape[0]
    R, _, units = weight.shape
    s_pad = bs.p_fwd.shape[1]
    x_aug = torch.cat([x, x.new_ones(num_src, 1)], dim=1) \
        * bs.src_scale[:, None]
    if s_pad > num_src:
        x_aug = F.pad(x_aug, (0, 0, 0, s_pad - num_src))
    pooled = bit_pool_rated(x_aug.contiguous(), bs.p_fwd, R, bs.d8_dst,
                            bs.impl)[:num_dst].to(x.dtype)
    pooled = pooled * bs.dst_scale[:, None, None]

    w_aug = torch.cat([weight, bias[:, None, :]], dim=1)   # (R, F+1, U)
    if ordinal_sharing:
        w_aug = torch.cumsum(w_aug, dim=0)
    if accum == "sum":
        # sum_r pooled[:, r] @ w_aug[r] as one matmul over (r, f), so the
        # (num_dst, R, U) per-link outputs are never stored.
        return pooled.reshape(num_dst, -1) @ w_aug.reshape(-1, units)
    if accum == "stack":
        out = torch.einsum("drf,rfu->dru", pooled, w_aug)
        return out.reshape(num_dst, R * units)
    raise ValueError(f"unknown accum: {accum!r}")

