"""Multi-link (per-rating) projection.

The port of ``multi_link_project`` from ``stargcn_tpu/ops/agg.py``, the one
function of that module that sampled mode reads; the flat-edge and dense
aggregations of the full-graph backends come with the slice that ports
them.
"""

from __future__ import annotations

import torch


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

    Returns ``(num_links, num_src, units)``.
    """
    if ordinal_sharing:
        weight = torch.cumsum(weight, dim=0)
        bias = torch.cumsum(bias, dim=0)
    # One batched product over all rating levels.
    return torch.baddbmm(bias[:, None, :], x.expand(weight.shape[0], -1, -1),
                         weight)
