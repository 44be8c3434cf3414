"""The yardstick's arithmetic: the card's peaks, the useful operations of a
STAR-GCN step, and the least time of the kernels the per-layer rooflines
read.  Frozen here so that a change to the program cannot move it.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its 700 W limit
(dense rates, no sparsity).
"""

from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,       # float32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}


def step_flops(model_cfg, e_active: int, rating_batch: int) -> dict:
    """Useful FLOPs of one full-graph STAR-GCN forward and training step of
    a ``STARGCNConfig`` (a copy of the program's
    ``utils/flops.py:stargcn_step_flops``): one multiply-add is 2 FLOPs; a
    step is 3 forwards; gathers count 0.

    * aggregation: every edge message multiply-adds one raw
      ``embed_units`` row, ``2 * msgs * embed``;
    * per-level projection of every node, per aggregation layer;
    * the output layer (``agg`` wide, or ``levels * agg`` for 'stack');
    * the rating head on both ends of each pair, and the inner product;
    * with the DAE, the reconstruction decoder.

    ``e_active``: edges aggregated; ``rating_batch``: pairs scored."""
    c = model_cfg
    layers = len(c.agg_units)
    n = c.num_users + c.num_items
    embed, agg, out = c.embed_units, c.agg_units[-1], c.out_units[-1]
    mid = c.gen_rating_mid_map
    msgs = c.nblocks * layers * 2 * e_active
    f_agg = 2 * msgs * embed
    f_proj = c.nblocks * c.num_links * layers * 2 * n * embed * agg
    agg_eff = agg * (c.num_links if c.agg_accum == "stack" else 1)
    f_out = c.nblocks * 2 * n * agg_eff * out
    f_dec = c.nblocks * (2 * rating_batch * 2 * out * mid
                         + 2 * rating_batch * mid)
    f_rec = c.nblocks * 2 * n * out * embed if c.use_dae else 0
    fwd = f_agg + f_proj + f_out + f_dec + f_rec
    return {"fwd": fwd, "step": 3 * fwd}


def bit_walk_least_s(num_links, num_dst, num_src, f, set_bits) -> float:
    """Least time of one bit walk into ``num_dst`` rows from ``num_src``
    (a ``bit_expand`` into the dst type, or the ``bit_reduce`` that gives
    the src type's gradient of the other direction): the 1-bit adjacency
    of every level read once, the ``(num_src, f)`` float32 operand read
    once and the ``(levels, num_dst, f)`` float32 result written once, at
    the HBM rate; or one float32 add per set bit per column.  The
    arithmetic of ``chip_smoke.py``'s kernel bounds, on the problem's own
    sizes (no padding)."""
    nbytes = (num_links * num_dst * num_src / 8 + num_src * f * 4
              + num_links * num_dst * f * 4)
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               set_bits * f / PEAKS["fp32_flops"])


def bmm_least_s(b, m, k, n, in_bytes=2, out_bytes=4,
                peak="bf16_flops") -> float:
    """Least time of a batched product ``(b, m, k) @ (b, k, n)``: each
    operand read once and the result written once at the HBM rate, or its
    multiply-adds at the tensor cores' peak for the operands' type."""
    nbytes = b * (m * k + k * n) * in_bytes + b * m * n * out_bytes
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               2 * b * m * k * n / PEAKS[peak])
