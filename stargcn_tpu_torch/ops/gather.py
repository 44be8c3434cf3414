"""Row gathers and segment sums by index.

The port of ``stargcn_tpu/ops/gather.py``, by name and by what the
functions compute.  The JAX package writes both as one-hot matrix products
because a scatter is serialised on its TPU runtime; on a CUDA card plain
indexing and ``index_add_`` are the natural form (their scatters use
atomics there, so sums over repeated indices may differ in the last bits
from run to run).
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for ``x`` ``(N, F)`` and integer ``idx`` ``(B,)``; the
    gradient is a scatter-add over ``x``'s rows."""
    return x.index_select(0, idx)


def onehot_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``out[n] = sum_{b: seg[b] == n} x[b]`` over ``num_segments`` rows.

    Args:
      x: ``(B, F)`` values (``(B,)`` is treated as ``(B, 1)``).
      seg: ``(B,)`` integer segment ids; rows with an id outside
        ``[0, num_segments)`` drop.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    ok = (seg >= 0) & (seg < num_segments)
    out = x.new_zeros((num_segments, x.shape[1]))
    out.index_add_(0, seg.clamp(0, max(num_segments - 1, 0)),
                   x * ok[:, None].to(x.dtype))
    return out[:, 0] if squeeze else out
