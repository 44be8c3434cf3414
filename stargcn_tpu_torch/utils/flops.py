"""Algorithmic (useful) FLOP accounting for MFU reporting.

Useful FLOPs over a measured step time, divided by the card's peak, give
the model FLOPs utilisation (MFU).  The count is the work the ALGORITHM
requires, the same whichever backend runs it (the ``dense`` and ``bitdense``
backends spend many more operations on padding and zero bits), so an
edge-message rate is never mistaken for hardware efficiency.

Conventions: 1 multiply-add = 2 FLOPs; forward counted explicitly; a
full training step (forward + backward + optimizer) is taken as 3x
forward (backward re-does each matmul twice: data-grad + weight-grad;
optimizer FLOPs are negligible).  Gathers/scatters/reshapes count 0.

Useful forward work of one STAR-GCN step (``models/stargcn.py``):

- aggregation: every edge message multiply-adds one raw ``embed_units``
  row (the linear-equivalent raw-aggregate-then-project formulation;
  projecting first costs more, so this is the algorithmic minimum):
  ``2 * msgs * embed_units``
- per-level projection: each destination row is projected once per
  rating level per aggregation layer: ``nblocks * levels * layers *
  2 * (Nu+Ni) * embed * agg``
- out layer: ``nblocks * 2 * (Nu+Ni) * agg_eff * out`` where
  ``agg_eff = agg`` (sum accum) or ``levels*agg`` (stack)
- gen_rating decoder: both endpoints of each batch pair through
  ``out -> mid`` plus the inner product
- reconstruction decoders (USE_DAE): ``out -> embed`` per node type
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB at its 700 W limit: dense bf16 tensor-core peak,
# 989 TFLOP/s (NVIDIA H100 Tensor Core GPU data sheet; its 1,979 TFLOP/s
# figure assumes 2:4 sparsity).  The MFU denominator.
H100_SXM_BF16_PEAK_FLOPS = 989e12


def stargcn_step_flops(model_cfg, e_active: int,
                       rating_batch: int) -> dict:
    """Useful FLOPs for one full-graph training step.

    ``e_active`` = edges actually aggregated (after per-batch removal);
    ``rating_batch`` = rating pairs scored by the decoder.
    """
    nb = model_cfg.nblocks
    levels = model_cfg.num_links
    layers = len(model_cfg.agg_units)
    n = model_cfg.num_users + model_cfg.num_items
    embed = model_cfg.embed_units
    agg = model_cfg.agg_units[-1]
    out = model_cfg.out_units[-1]
    mid = model_cfg.gen_rating_mid_map

    msgs = nb * layers * 2 * e_active
    f_agg = 2 * msgs * embed
    f_proj = nb * levels * layers * 2 * n * embed * agg
    agg_eff = agg * (levels if model_cfg.agg_accum == "stack" else 1)
    f_out = nb * 2 * n * agg_eff * out
    f_dec = nb * (2 * rating_batch * 2 * out * mid + 2 * rating_batch * mid)
    f_rec = (nb * 2 * n * out * embed) if model_cfg.use_dae else 0
    fwd = f_agg + f_proj + f_out + f_dec + f_rec
    return {"fwd": fwd, "step": 3 * fwd, "edge_msgs": msgs}


def mfu(flops_per_step: float, step_seconds: float,
        peak: float = H100_SXM_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilisation against the card's peak."""
    if not step_seconds:
        return 0.0
    return flops_per_step / step_seconds / peak
