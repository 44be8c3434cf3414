"""Bit-packed dense multi-link aggregation (the ``bitdense`` backend).

The port of ``stargcn_tpu/ops/bitdense.py``.  The one-hot
multi-link adjacency ``S[r, d, s] = 1 iff edge (d <- s) has rating level
r`` is packed at one bit per entry:

    ``P[r * D8 + d8, s]`` bit ``b``  =  ``S[r, b * D8 + d8, s]``

with ``D8 = D_pad / 8``.  Expanding bit plane ``b`` of a row block yields
the adjacency rows of destinations ``b*D8 + d8``, so an output laid out
``(R, 8, D8, F)`` is in natural destination order after a reshape.

``bit_expand_matmul`` is the CUDA kernel ``ops/csrc/bit_expand.cu`` on a
tensor that lies on the card, and its plain version ``xla_expand_matmul``
on one that lies on the CPU; ``bit_reduce_matmul``
(``ops/csrc/bit_reduce.cu``, plain version ``xla_reduce_matmul``) is its
adjoint over the transpose pack, and ``bit_pool_rated`` ties the two into
one differentiable function.  ``bit_expand_matmul16`` and
``bit_reduce_matmul16`` (``KERNEL.BIT_IMPL: pallas16``) compute the same on
packs whose rows are interleaved inside blocks of ``_BM``
(``pack_bits(row_interleave=_BM)``); the same two kernels read them
through a row map.  Padding follows the JAX package (``_BM``,
``_BS``: node counts padded to a multiple of 1024) so packs compare byte
for byte.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stargcn_tpu_torch.ops.gather import take_rows
from stargcn_tpu_torch.parallel.collectives import (all_gather_rows,
                                                    all_reduce_)

_BM = 128
_BS = 1024

# Launches of each kernel wrapper on the card (the plain versions are not
# counted).  A run sets these to 0, drives its path, and reads them.
LAUNCHES = {"bit_expand_matmul": 0, "bit_reduce_matmul": 0,
            "bit_expand_matmul16": 0, "bit_reduce_matmul16": 0}


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
              num_src, mask=None, bm: int = _BM, bs: int = _BS,
              interleave: int = 0, row_interleave: int = 0):
    """Bit-pack one direction's multi-link adjacency (NumPy).

    Returns ``(P, D8)`` with ``P`` of shape ``(num_links * D8, S_pad)``
    uint8, bit ``b`` of ``P[r*D8 + d8, s]`` set iff edge
    ``(dst = b*D8 + d8  <-  src = s)`` carries rating level ``r`` (and
    ``mask > 0``).  Duplicate edges collapse (one-hot semantics).

    ``interleave`` > 0 permutes source columns within blocks of that size
    (logical ``L`` -> physical ``2L`` in the first half, ``2(L - half) + 1``
    in the second), a column-pairing layout no kernel reads.

    ``row_interleave`` > 0 (``bm`` of the ``pallas16`` route) permutes the
    packed rows within each block of that many rows of the ``D8`` axis:
    natural position ``w`` goes to physical row ``2*(w % (bm/2)) +
    w // (bm/2)`` (see ``natural_to_physical``).
    """
    d8, _, s_pad = pad_dims(num_dst, num_src, bm, bs)
    edge_dst = np.asarray(edge_dst, np.int64)
    edge_src = np.asarray(edge_src, np.int64)
    edge_rating = np.asarray(edge_rating, np.int64)
    if mask is not None:
        keep = np.asarray(mask) > 0
        edge_dst, edge_src, edge_rating = (
            edge_dst[keep], edge_src[keep], edge_rating[keep])
    if interleave:
        half = interleave // 2
        blk, off = edge_src // interleave, edge_src % interleave
        edge_src = blk * interleave + np.where(
            off < half, 2 * off, 2 * (off - half) + 1)
    P = np.zeros((num_links * d8) * s_pad, np.uint8)
    b = edge_dst // d8
    pos = edge_dst % d8
    if row_interleave:
        pos = natural_to_physical(pos, row_interleave)
    flat = (edge_rating * d8 + pos) * s_pad + edge_src
    # One fancy-indexed OR per bit plane: within a plane all writes carry
    # the same value, so duplicate indices are benign.
    for bit in range(8):
        sel = b == bit
        if sel.any():
            P[flat[sel]] |= np.uint8(1 << bit)
    return P.reshape(num_links * d8, s_pad), d8


def natural_to_physical(pos, ril: int):
    """Physical packed row of natural position ``pos`` along the ``D8``
    axis of a pack built with ``row_interleave=ril`` (numpy or torch
    integers): ``2*(w % (ril/2)) + w // (ril/2)`` inside each block of
    ``ril`` rows.  The CUDA kernels use the same map
    (``ops/csrc/bit_walk.cuh:physical_row``)."""
    half = ril // 2
    blk, w = pos // ril, pos % ril
    return blk * ril + 2 * (w % half) + w // half


def build_bit_pack(edge_user, edge_item, edge_rating, edge_mask,
                   num_users, num_items, num_links, device,
                   bm: int = _BM, bs: int = _BS, row_interleave: int = 0):
    """Both layouts for one graph variant, as uint8 tensors on ``device``:
    ``{'user': {'pf', 'pb'}, 'item': {'pf', 'pb'}, 'row_interleave': n}``,
    where entry ``t`` drives aggregation into type ``t`` (``pf`` = that
    direction's layout, ``pb`` = the transpose layout its backward will
    read) and ``row_interleave`` records the packed-row order of both, so
    that a pooling route that expects the other order refuses the pack."""
    kw = dict(mask=edge_mask, bm=bm, bs=bs, row_interleave=row_interleave)
    pa, _ = pack_bits(edge_user, edge_item, edge_rating, num_links,
                      num_users, num_items, **kw)
    pb, _ = pack_bits(edge_item, edge_user, edge_rating, num_links,
                      num_items, num_users, **kw)
    ta = torch.from_numpy(pa).to(device)
    tb = torch.from_numpy(pb).to(device)
    return {"user": {"pf": ta, "pb": tb}, "item": {"pf": tb, "pb": ta},
            "row_interleave": row_interleave}


def resolve_impl(impl: str) -> str:
    """Which pooling engine ``bit_pool_rated`` calls, from the config's
    ``KERNEL.BIT_IMPL``: ``'auto'`` and ``'pallas'`` give ``'kernel'``
    (the ``bit_expand_matmul`` and ``bit_reduce_matmul`` wrappers: the
    CUDA kernels for tensors on the card, their plain versions for tensors
    on the CPU), ``'pallas16'`` gives ``'kernel16'`` (the same for
    ``bit_expand_matmul16`` and ``bit_reduce_matmul16``, which read packs
    built with ``row_interleave=_BM``), ``'xla'`` gives ``'plain'``
    (``xla_expand_matmul`` and ``xla_reduce_matmul`` on any device)."""
    if impl in ("auto", "pallas"):
        return "kernel"
    if impl == "pallas16":
        return "kernel16"
    if impl == "xla":
        return "plain"
    raise ValueError(f"unknown bit_impl: {impl!r}")


def pack_row_interleave(impl: str) -> int:
    """The ``row_interleave`` of the packs that a resolved ``impl``
    reads: ``_BM`` for ``'kernel16'``, else 0."""
    return _BM if impl == "kernel16" else 0


# ------------------------------ the kernels ------------------------------


def _check_ril(name: str, d8: int, bm: int):
    if bm <= 0 or bm % 2 or d8 % bm:
        raise ValueError(f"{name}: the row block bm={bm} must be even and "
                         f"divide d8={d8}")


# The walk's geometry (ops/csrc/bit_walk.cuh): bytes of a packed row per
# stage, columns per register round, warps per block, and the size up to
# which a reduce's whole bf16 table is taken to stay in the 50 MB L2.
_STAGE = 512
_ROUND = 128
_WARPS = 8
_L2_TABLE = 24 << 20


def walk_plan(s_pad: int, f: int, num_links: int = 1,
              reduce: bool = False, shard: bool = False) -> dict:
    """The launch plan of the bit kernels, from the shape alone (and, for
    the reduce, whether the pack is a row shard, whose units take one
    level each).

    ``fp``: the bf16 table's padded width (a multiple of 8, so its rows are
    16-byte aligned); ``k`` register rounds of 128 columns per column tile
    (at most 256 columns) and ``tiles`` column tiles, each walking the pack
    once; ``stages``: 512-byte stages per packed row; ``levels``: packed
    rows (rating levels) one unit walks: all R on the reduce when its whole
    table fits ``_L2_TABLE``, else 1; ``chain``: the units of one output
    row add into it in rating order; ``np``: warps per unit, 8 (the block)
    for units of 64 stages or more or chained ones, else 1."""
    fp = _round_up(max(f, 1), 8)
    k = 1 if fp <= _ROUND else 2
    stages = -(-s_pad // _STAGE)
    whole = reduce and not shard and num_links * s_pad * fp * 2 <= _L2_TABLE
    levels = num_links if whole else 1
    chain = reduce and levels < num_links
    np_ = _WARPS if chain or levels * stages >= 64 else 1
    return dict(fp=fp, k=k, tiles=-(-fp // (k * _ROUND)), stages=stages,
                levels=levels, chain=chain, np=np_)


def bf16_table(v: torch.Tensor) -> torch.Tensor:
    """Plain version of the table the bit kernels gather from (built on the
    card by ``bit_walk.cuh:table_kernel``): ``v`` (``(..., F)``, any row
    strides) rounded to bf16 (nearest even, as the TPU kernels round) into
    a contiguous table of ``walk_plan``'s ``fp`` columns, zero past F (for
    the reduce's g, level-major: ``(R, S_pad, fp)``)."""
    f = v.shape[-1]
    fp = _round_up(max(f, 1), 8)
    tab = torch.empty(tuple(v.shape[:-1]) + (fp,), dtype=torch.bfloat16,
                      device=v.device)
    tab[..., f:] = 0
    tab[..., :f] = v
    return tab


def _launch(name, lib, P, v, out, num_links, d8, ril, row0):
    """Launch ``ops/csrc/<lib>.cu`` on P's stream with ``walk_plan``'s
    geometry: it rounds ``v`` into a bf16 table (scratch allocated here),
    then walks the pack (P's rows, from ``row0`` of the whole; None: the
    whole pack).  Raise on a launch error, count the launch."""
    from stargcn_tpu_torch.ops import _build

    fn = _build.load(lib)
    reduce = lib == "bit_reduce"
    s_pad, f = P.shape[1], out.shape[-1]
    rows, shard = P.shape[0], row0 is not None
    plan = walk_plan(s_pad, f, num_links, reduce, shard=shard)
    if num_links * s_pad >= 2**32:
        raise ValueError(f"{name}: num_links * S_pad exceeds uint32")
    tab = torch.empty(((num_links if reduce else 1) * s_pad, plan["fp"]),
                      dtype=torch.bfloat16, device=P.device)
    sync = torch.empty(plan["tiles"] * (1 + d8), dtype=torch.int32,
                       device=P.device)
    operand = (v.data_ptr(), int(v.dtype == torch.bfloat16))
    if reduce:
        operand += (v.stride(0), v.stride(1))
    head = (num_links, plan["levels"]) if reduce else (rows,)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = fn(P.data_ptr(), *operand, tab.data_ptr(), out.data_ptr(),
                 sync.data_ptr(), *head, s_pad, f, plan["fp"], plan["k"],
                 plan["np"], plan["tiles"], d8, ril,
                 *((rows, row0 or 0) if reduce else (row0 or 0, int(shard))),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return out


def _check_operands(name, P, v, what, dims):
    """Device, type and layout checks shared by the four wrappers."""
    if not (P.is_cuda and v.is_cuda and P.device == v.device):
        raise ValueError(f"{name}: P and {what} must lie on one CUDA device "
                         f"(got {P.device} and {v.device})")
    if P.dtype != torch.uint8 or v.dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise TypeError(f"{name} takes uint8 P and float32 or bfloat16 "
                        f"{what} (got {P.dtype} and {v.dtype})")
    if P.dim() != 2 or v.dim() != dims:
        raise ValueError(f"{name} takes 2-D P and {dims}-D {what}")
    if not P.is_contiguous():
        raise ValueError(f"{name} takes contiguous P")
    if P.shape[1] % 16 or P.data_ptr() % 16:
        raise ValueError(f"{name}: P rows must be 16-byte aligned "
                         "(S_pad % 16 == 0)")
    if max(*P.shape, v.shape[-1]) >= 2**31:
        raise ValueError(f"{name}: dimension exceeds int32")


def check_rows(name, rows, num_links, d8, row0, ril=0):
    """Check that a pack of ``rows`` packed rows is the whole ``(num_links
    * d8)``-row pack (``row0`` None) or its rows ``[row0, row0 + rows)``,
    in whole blocks of ``ril`` rows (the 16-bit route's interleave, which
    permutes rows inside those blocks only)."""
    total = num_links * d8
    lo = 0 if row0 is None else row0
    if (row0 is None and rows != total) or lo < 0 or rows <= 0 \
            or lo + rows > total:
        raise ValueError(
            f"{name}: packed rows [{lo}, {lo + rows}) are not "
            + ("the" if row0 is None else "within the")
            + f" {total} rows of num_links={num_links}, d8={d8}")
    if row0 is not None and ril and (row0 % ril or rows % ril):
        raise ValueError(f"{name}: a row shard of a row_interleave={ril} "
                         f"pack must hold whole blocks of {ril} rows")


def _expand(name, P, x, num_links, d8, ril, row0):
    """``bit_expand_matmul`` (ril 0) or ``bit_expand_matmul16`` (ril = bm)
    on the card."""
    _check_operands(name, P, x, "x", 2)
    m8, s_pad = P.shape
    f = x.shape[1]
    if x.shape[0] != s_pad:
        raise ValueError(
            f"{name}: P {tuple(P.shape)} and x {tuple(x.shape)} do not fit "
            f"num_links={num_links}, d8={d8}")
    check_rows(name, m8, num_links, d8, row0, ril)
    if not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous x")
    out = torch.empty((num_links, 8, d8, f) if row0 is None else (m8, 8, f),
                      dtype=torch.float32, device=P.device)
    if out.numel() == 0:
        return out
    return _launch(name, "bit_expand", P, x, out, num_links, d8, ril, row0)


def _reduce(name, P, g, num_links, d8, ril, row0):
    """``bit_reduce_matmul`` (ril 0) or ``bit_reduce_matmul16`` (ril = bm)
    on the card."""
    _check_operands(name, P, g, "g", 3)
    m8, s_pad = P.shape
    f = g.shape[2]
    if tuple(g.shape[:2]) != (num_links, s_pad):
        raise ValueError(
            f"{name}: P {tuple(P.shape)} and g {tuple(g.shape)} do not fit "
            f"num_links={num_links}, d8={d8}")
    check_rows(name, m8, num_links, d8, row0, ril)
    if (f > 1 and g.stride(2) != 1) or min(g.stride()[:2]) < 0:
        raise ValueError(f"{name}: the last dimension of g must be "
                         f"contiguous (strides {g.stride()})")
    # A shard leaves the rows m it holds no level of unwritten.
    out = (torch.empty if row0 is None else torch.zeros)(
        (8, d8, f), dtype=torch.float32, device=P.device)
    if out.numel() == 0:
        return out
    return _launch(name, "bit_reduce", P, g, out, num_links, d8, ril, row0)


def bit_expand_matmul(P: torch.Tensor, x: torch.Tensor, num_links: int,
                      d8: int, *, row0=None) -> torch.Tensor:
    """``out[r, b, m, f] = sum_s bit_b(P[r*d8+m, s]) x[s, f]``.

    Args:
      P: ``(num_links * d8, S_pad)`` uint8, contiguous; or with ``row0``
        a row shard of that pack, its packed rows ``[row0, row0 +
        P.shape[0])`` (one rank's rows on a device mesh).
      x: ``(S_pad, F)`` float32 or bfloat16, contiguous.

    Returns ``(num_links, 8, d8, F)`` float32; on a row shard ``(rows, 8,
    F)``, the shard's packed rows ``p`` (``out[p - row0, b] = out_whole[p
    // d8, b, p % d8]``), so the ranks' outputs stacked in row order are
    the whole pack's in packed-row-major order.  On the card
    ``ops/csrc/bit_expand.cu`` rounds x to bf16 once (into the table of
    ``bf16_table``) and sums in f32, as the TPU kernel does.  On the CPU it
    is ``xla_expand_matmul`` in x's own precision, as the JAX package's CPU
    path is.
    """
    if P.device.type == "cpu" and x.device.type == "cpu":
        return xla_expand_matmul(P, x, num_links, d8, row0=row0)
    return _expand("bit_expand_matmul", P, x, num_links, d8, 0, row0)


def bit_expand_matmul16(P: torch.Tensor, x: torch.Tensor, num_links: int,
                        d8: int, *, bm: int = _BM,
                        row0=None) -> torch.Tensor:
    """``bit_expand_matmul`` on a pack built with ``row_interleave=bm``
    (or on a row shard of it in whole blocks of ``bm`` rows): the output
    is ``bit_expand_matmul``'s in natural destination order.  On
    the card this launches ``ops/csrc/bit_expand.cu`` with the row map,
    which gives the bits ``bit_expand_matmul`` gives on the natural pack;
    on the CPU it is ``xla_expand_matmul16``."""
    _check_ril("bit_expand_matmul16", d8, bm)
    if P.device.type == "cpu" and x.device.type == "cpu":
        return xla_expand_matmul16(P, x, num_links, d8, bm=bm, row0=row0)
    return _expand("bit_expand_matmul16", P, x, num_links, d8, bm, row0)


def xla_expand_matmul(P: torch.Tensor, x: torch.Tensor, num_links: int,
                      d8: int, chunk_bytes: int = 1 << 29, *,
                      row0=None) -> torch.Tensor:
    """Plain PyTorch version of ``bit_expand_matmul`` (the counterpart of
    ``stargcn_tpu.ops.bitdense.xla_expand_matmul``): unpack the eight bit
    planes and contract with x, in x's own precision with an f32 sum; on a
    row shard (``row0``) the shard's rows alone, in its layout.

    Works over blocks of packed rows whose f32 planes stay under
    ``chunk_bytes``, so it also runs at the full ML-10M shape, where all
    planes at once would take ~32 GB.  Returns ``(num_links, 8, d8, F)``
    float32 (a permuted view).
    """
    m8, s_pad = P.shape
    f = x.shape[1]
    check_rows("xla_expand_matmul", m8, num_links, d8, row0)
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
    if row0 is not None:
        return out.transpose(0, 1)
    return out.reshape(8, num_links, d8, f).permute(1, 0, 2, 3)


def xla_expand_matmul16(P: torch.Tensor, x: torch.Tensor, num_links: int,
                        d8: int, *, bm: int = _BM,
                        row0=None) -> torch.Tensor:
    """Plain PyTorch version of ``bit_expand_matmul16``: the natural plain
    version on the physical rows, then the inverse of the row map on the
    ``d8`` axis of its output, or on a shard's rows (the pack itself is
    never copied)."""
    check_rows("xla_expand_matmul16", P.shape[0], num_links, d8, row0, bm)
    out = xla_expand_matmul(P, x, num_links, d8, row0=row0)
    if row0 is None:
        phys = natural_to_physical(torch.arange(d8, device=P.device), bm)
        return out.index_select(2, phys)
    # Natural row q of the shard is physical row r * d8 + phys(q % d8);
    # a shard of whole blocks holds both.
    q = torch.arange(row0, row0 + P.shape[0], device=P.device)
    src = q - q % d8 + natural_to_physical(q % d8, bm) - row0
    return out.index_select(0, src)


def bit_reduce_matmul(P: torch.Tensor, g: torch.Tensor, num_links: int,
                      d8: int, *, row0=None) -> torch.Tensor:
    """``out[b, m, f] = sum_{r, s} bit_b(P[r*d8+m, s]) g[r, s, f]``.

    Args:
      P: ``(num_links * d8, S_pad)`` uint8, contiguous; or with ``row0``
        a row shard of that pack, its packed rows ``[row0, row0 +
        P.shape[0])``, when the sum runs over the shard's rows alone (one
        rank's partial sum on a device mesh).
      g: ``(num_links, S_pad, F)`` float32 or bfloat16, rating-major as in
        the JAX package.  Its last dimension must be contiguous; the two
        row strides are free, so a ``permute(1, 0, 2)`` view of an
        ``(S_pad, num_links, F)`` cotangent is taken as it comes.

    Returns ``(8, d8, F)`` float32.  On the card ``ops/csrc/bit_reduce.cu``
    rounds g to bf16 once (into the level-major table of ``bf16_table``)
    and sums in f32, as the TPU kernel does.  On the CPU it
    is ``xla_reduce_matmul`` in g's own precision, as the JAX package's CPU
    path is.
    """
    if P.device.type == "cpu" and g.device.type == "cpu":
        return xla_reduce_matmul(P, g, num_links, d8, row0=row0)
    return _reduce("bit_reduce_matmul", P, g, num_links, d8, 0, row0)


def bit_reduce_matmul16(P: torch.Tensor, g: torch.Tensor, num_links: int,
                        d8: int, *, bm: int = _BM,
                        row0=None) -> torch.Tensor:
    """``bit_reduce_matmul`` on a pack built with ``row_interleave=bm``
    (or on a row shard of it in whole blocks of ``bm`` rows): the output
    is ``(8, d8, F)`` float32 in natural order at every F.  On the card
    this launches ``ops/csrc/bit_reduce.cu`` with the row map; on the CPU
    it is ``xla_reduce_matmul16``."""
    _check_ril("bit_reduce_matmul16", d8, bm)
    if P.device.type == "cpu" and g.device.type == "cpu":
        return xla_reduce_matmul16(P, g, num_links, d8, bm=bm, row0=row0)
    return _reduce("bit_reduce_matmul16", P, g, num_links, d8, bm, row0)


def xla_reduce_matmul(P: torch.Tensor, g: torch.Tensor, num_links: int,
                      d8: int, chunk_bytes: int = 1 << 29, *,
                      row0=None) -> torch.Tensor:
    """Plain PyTorch version of ``bit_reduce_matmul`` (the counterpart of
    ``stargcn_tpu.ops.bitdense.xla_reduce_matmul``, same rating-major
    ``(R, S_pad, F)`` cotangent): unpack the eight bit planes and contract
    with g over (r, s), in g's own precision with an f32 sum; on a row
    shard (``row0``) over the shard's rows alone.

    Works over blocks of packed rows whose f32 planes stay under
    ``chunk_bytes``, like ``xla_expand_matmul``.  Returns ``(8, d8, F)``
    float32.
    """
    m8, s_pad = P.shape
    f = g.shape[2]
    check_rows("xla_reduce_matmul", m8, num_links, d8, row0)
    row0 = row0 or 0
    gf = g.float()
    shifts = torch.arange(8, dtype=torch.uint8, device=P.device)
    rows = max(1, chunk_bytes // max(1, 8 * s_pad * 4))
    out = torch.zeros((8, d8, f), dtype=torch.float32, device=P.device)
    # Every output row adds its levels in the order r = 0, 1, ...
    for lo in range(0, d8, rows):
        hi = min(lo + rows, d8)
        for r in range(num_links):
            a = max(r * d8 + lo, row0)
            b = min(r * d8 + hi, row0 + m8)
            if a >= b:
                continue
            blk = P[a - row0:b - row0]
            planes = ((blk[None] >> shifts[:, None, None]) & 1).float()
            out[:, a - r * d8:b - r * d8] += torch.matmul(planes, gf[r])
    return out


def xla_reduce_matmul16(P: torch.Tensor, g: torch.Tensor, num_links: int,
                        d8: int, *, bm: int = _BM,
                        row0=None) -> torch.Tensor:
    """Plain PyTorch version of ``bit_reduce_matmul16``: the natural plain
    version on the physical rows, then the inverse of the row map on the
    ``d8`` axis of its output."""
    check_rows("xla_reduce_matmul16", P.shape[0], num_links, d8, row0, bm)
    out = xla_reduce_matmul(P, g, num_links, d8, row0=row0)
    phys = natural_to_physical(torch.arange(d8, device=P.device), bm)
    return out.index_select(1, phys)


# ------------------------------ aggregation ------------------------------


def _engine(impl: str):
    """``(expand, reduce)`` of a resolved impl, looked up when called (so
    that a caller may wrap the module's functions)."""
    return {"kernel": (bit_expand_matmul, bit_reduce_matmul),
            "kernel16": (bit_expand_matmul16, bit_reduce_matmul16),
            "plain": (xla_expand_matmul, xla_reduce_matmul)}[impl]


class _BitPoolRated(torch.autograd.Function):
    """Forward = expand over ``p_fwd``, backward = reduce over ``p_bwd``.
    Only ``p_bwd`` is kept for the backward: the function is linear in x,
    and plain autograd through ``xla_expand_matmul`` would keep the
    unpacked planes.

    With a ``fwd_group``, ``p_fwd`` is this rank's row shard (from packed
    row ``fwd_row0``): the forward expands the rank's rows and gathers the
    ranks' rows over the group.  With a ``bwd_group``, ``p_bwd`` is: the
    backward reduces over the rank's transpose rows and adds the ranks'
    partial sums over the group.  ``x`` and the output are replicated over
    both groups, so no other collective pairs with these, and each pack is
    split or whole on its own."""

    @staticmethod
    def forward(ctx, x, p_fwd, p_bwd, num_links, d8_dst, d8_src, impl,
                fwd_group, bwd_group, fwd_row0, bwd_row0):
        expand = _engine(impl)[0]
        ctx.save_for_backward(p_bwd)
        ctx.static = (num_links, d8_src, impl, x.dtype, bwd_group, bwd_row0)
        if fwd_group is None:
            out = expand(p_fwd, x, num_links, d8_dst)
            # (R, 8, d8, F) -> (8*d8, R, F), natural dst index.
            return out.permute(1, 2, 0, 3).reshape(8 * d8_dst, num_links, -1)
        # The ranks' rows, (R*d8, 8, F) packed-row-major, -> (8*d8, R, F).
        out = all_gather_rows(expand(p_fwd, x, num_links, d8_dst,
                                     row0=fwd_row0), fwd_group)
        return out.reshape(num_links, d8_dst, 8, -1).permute(2, 1, 0, 3) \
            .reshape(8 * d8_dst, num_links, -1)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 11
        (p_bwd,) = ctx.saved_tensors
        num_links, d8_src, impl, x_dtype, group, row0 = ctx.static
        if g.stride(2) != 1:
            g = g.contiguous()
        # g: (D_pad, R, F); the reduce reads it rating-major, as a view.
        g_rm = g.permute(1, 0, 2)
        reduce = _engine(impl)[1]
        if group is None:
            d_x = reduce(p_bwd, g_rm, num_links, d8_src)
        else:
            d_x = all_reduce_(reduce(p_bwd, g_rm, num_links, d8_src,
                                     row0=row0), group)
        return (d_x.reshape(8 * d8_src, -1).to(x_dtype),) + (None,) * 10


def bit_pool_rated(x, p_fwd, p_bwd, num_links, d8_dst, d8_src,
                   impl="kernel", fwd_group=None, bwd_group=None,
                   fwd_row0=0, bwd_row0=0):
    """Differentiable per-rating pooled aggregation over packed bits.

    Args:
      x: ``(S_pad, F)`` source features (padded rows are never read: no
        bits are set for them).
      p_fwd: ``(num_links * d8_dst, S_pad)`` uint8 — this direction.
      p_bwd: ``(num_links * d8_src, D_pad)`` uint8 — the transpose layout,
        read only by the backward.
      impl: ``'kernel'`` | ``'kernel16'`` | ``'plain'`` (see
        ``resolve_impl``); ``'kernel16'`` reads packs built with
        ``row_interleave=_BM``, the others natural packs.
      fwd_group / bwd_group: on a device mesh, the 'model' process group
        over which ``p_fwd`` / ``p_bwd`` is split by rows (None: that pack
        is whole); the pack is then this rank's rows, from packed row
        ``fwd_row0`` / ``bwd_row0`` of the whole.

    Returns ``(8 * d8_dst, num_links, F)`` f32, indexed by the natural
    destination id.
    """
    return _BitPoolRated.apply(x, p_fwd, p_bwd, num_links, d8_dst, d8_src,
                               impl, fwd_group, bwd_group, fwd_row0,
                               bwd_row0)


def bit_multi_link_aggregate(x, bit_static, weight, bias,
                             ordinal_sharing: bool, accum: str):
    """Multi-link aggregation through a ``BitStatic`` operand pack:
    aggregate-then-project, with the per-link bias carried by a ones
    column through the pooling, separable degree scales around it and the
    removed batch edges taken out again as a batch-sized correction
    (``stargcn_tpu.ops.bitdense.bit_multi_link_aggregate``).

    ``x``, ``weight`` and ``bias`` share one dtype, float32 or a compute
    dtype such as bf16; with the JAX package's type promotion: ``x_aug``
    (x times the float32 scales) reaches the kernel in float32, the pooled
    table is rounded to ``x``'s dtype, the correction, scaling and the
    projection run in float32, and the output is in ``x``'s dtype."""
    bs = bit_static
    num_src = x.shape[0]
    num_dst = bs.dst_scale.shape[0]
    R, _, units = weight.shape
    s_pad = bs.p_fwd.shape[1]
    x_aug = torch.cat([x, x.new_ones(num_src, 1)], dim=1) \
        * bs.src_scale[:, None]
    if s_pad > num_src:
        x_aug = F.pad(x_aug, (0, 0, 0, s_pad - num_src))
    pooled = bit_pool_rated(x_aug.contiguous(), bs.p_fwd, bs.p_bwd, R,
                            bs.d8_dst, bs.d8_src, bs.impl, bs.fwd_group,
                            bs.bwd_group, bs.fwd_row0,
                            bs.bwd_row0)[:num_dst].to(x.dtype)
    if bs.rem_src is not None:
        # One row per batch pair, subtracted from its (dst, rating) slot
        # of the pooled table: no (B, num_dst * R) one-hot is formed.
        gathered = take_rows(x_aug, bs.rem_src) * bs.rem_weight[:, None]
        seg = bs.rem_dst * R + bs.rem_rating
        pooled = pooled.to(gathered.dtype).reshape(num_dst * R, -1) \
            .index_add(0, seg, gathered, alpha=-1).reshape(num_dst, R, -1)
    pooled = pooled * bs.dst_scale[:, None, None]

    w_aug = torch.cat([weight, bias[:, None, :]], dim=1)   # (R, F+1, U)
    if ordinal_sharing:
        w_aug = torch.cumsum(w_aug, dim=0)
    w_aug = w_aug.to(pooled.dtype)
    if accum == "sum":
        # sum_r pooled[:, r] @ w_aug[r] as one matmul over (r, f), so the
        # (num_dst, R, U) per-link outputs are never stored (in a compute
        # dtype the sum is rounded once, not per link).
        return (pooled.reshape(num_dst, -1)
                @ w_aug.reshape(-1, units)).to(x.dtype)
    if accum == "stack":
        out = torch.einsum("drf,rfu->dru", pooled, w_aug)
        return out.reshape(num_dst, R * units).to(x.dtype)
    raise ValueError(f"unknown accum: {accum!r}")

