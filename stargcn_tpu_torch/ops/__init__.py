"""Operators: the seg-op family (``ops/segment.py``) and its kernel-backed
variants on pre-packed segments (``ops/ell.py``), the multi-link
aggregations (``ops/agg.py``), and the bitdense and ELL kernels with the
build of their CUDA sources."""

from stargcn_tpu_torch.ops.ell import (
    EllSegments,
    ell_from_csr,
    seg_take_k_corr_pallas,
    seg_weighted_pool_pallas,
)
from stargcn_tpu_torch.ops.segment import (
    indptr_to_segment_ids,
    seg_broadcast_add,
    seg_broadcast_mul,
    seg_broadcast_to,
    seg_max,
    seg_min,
    seg_pool,
    seg_softmax,
    seg_sum,
    seg_take_k_corr,
    seg_weighted_pool,
)

__all__ = [
    "EllSegments", "ell_from_csr", "seg_take_k_corr_pallas",
    "seg_weighted_pool_pallas", "indptr_to_segment_ids",
    "seg_broadcast_add", "seg_broadcast_mul", "seg_broadcast_to",
    "seg_max", "seg_min", "seg_pool", "seg_softmax", "seg_sum",
    "seg_take_k_corr", "seg_weighted_pool",
]
