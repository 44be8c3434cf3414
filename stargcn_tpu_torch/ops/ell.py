"""CSR-segment -> ELL conversion and the kernel-backed seg-op variants.

The port of ``stargcn_tpu/ops/ell.py``: ragged CSR segments are packed on
the host, once per graph, into fixed-width ``(num_seg, K)`` slot matrices,
after which ``seg_weighted_pool`` / ``seg_take_k_corr`` run through the ELL
kernels of ``ops/ell_kernels.py`` (``ell_spmm`` and ``ell_sddmm``).  The
function names keep the JAX package's ``_pallas`` suffix so that a reader
finds the counterparts; on a CUDA card they launch the CUDA kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stargcn_tpu_torch.ops import ell_kernels


@dataclasses.dataclass(frozen=True)
class EllSegments:
    """Packed segments: ``slot_edge[i, k]`` is the position (into the
    original nnz axis) of segment i's k-th element; ``slot_mask`` is 0 on
    padding.  ``K`` = max segment length."""

    slot_edge: np.ndarray   # (num_seg, K) int32
    slot_mask: np.ndarray   # (num_seg, K) float32
    num_seg: int
    nnz: int


def ell_from_csr(indptr, nnz=None) -> EllSegments:
    """Pack CSR segments into fixed-width slots (host, once per graph)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    num_seg = indptr.size - 1
    nnz = int(indptr[-1]) if nnz is None else int(nnz)
    deg = indptr[1:] - indptr[:-1]
    K = int(deg.max(initial=1))
    slot_edge = np.zeros((num_seg, K), np.int32)
    slot_mask = np.zeros((num_seg, K), np.float32)
    rows = np.repeat(np.arange(num_seg), deg)
    cols = np.arange(nnz) - np.repeat(indptr[:-1], deg)
    slot_edge[rows, cols] = np.arange(nnz, dtype=np.int32)
    slot_mask[rows, cols] = 1.0
    return EllSegments(slot_edge=slot_edge, slot_mask=slot_mask,
                       num_seg=num_seg, nnz=nnz)


def _slots(ell, indices, device):
    """``(slot_edge int64, slot_mask, nbr int32)`` on ``device``: the slot
    map and the node index each slot reads."""
    slot_edge = torch.from_numpy(ell.slot_edge).to(device).long()
    slot_mask = torch.from_numpy(ell.slot_mask).to(device)
    indices = torch.as_tensor(indices, device=device)
    return slot_edge, slot_mask, indices[slot_edge].to(torch.int32)


def seg_weighted_pool_pallas(data, weights, indices, ell: EllSegments):
    """Kernel-backed ``seg_weighted_pool`` with the indptr pre-packed:
    ``out[b, s] = sum_{j in segment s} weights[b, j] * data[b,
    indices[j]]``, differentiable in ``data`` and ``weights``.

    Args:
      data: ``(batch, num_neighbor_nodes, feat)`` float32.
      weights: ``(batch, nnz)`` float32.
      indices: ``(nnz,)`` indices into data's node axis.
      ell: packed segments from ``ell_from_csr``.
    """
    slot_edge, slot_mask, nbr = _slots(ell, indices, data.device)
    # One launch per batch entry (the JAX function maps over the axis).
    return torch.stack([
        ell_kernels.ell_spmm(data_b.contiguous(), nbr,
                             w_b[slot_edge] * slot_mask)
        for data_b, w_b in zip(data, weights)])


def seg_take_k_corr_pallas(embed1, embed2, neighbor_ids, ell: EllSegments):
    """Kernel-backed ``seg_take_k_corr``: ``out[b, j] = dot(embed1[b,
    seg(j)], embed2[b, neighbor_ids[j]])``, the per-edge scores in the
    original nnz order (unpacked through the slot map).  Forward only."""
    slot_edge, slot_mask, nbr = _slots(ell, neighbor_ids, embed1.device)
    out = []
    for e1_b, e2_b in zip(embed1, embed2):
        scores = ell_kernels.ell_sddmm(e1_b.contiguous(), e2_b.contiguous(),
                                       nbr)                       # (S, K)
        flat = scores.new_zeros(ell.nnz)
        out.append(flat.index_add_(0, slot_edge.reshape(-1),
                                   (scores * slot_mask).reshape(-1)))
    return torch.stack(out)
