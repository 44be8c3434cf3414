"""Host graph kernels (NumPy).

The port's copy of the NumPy half of ``stargcn_tpu/graph/kernels.py``, cut
to what the serving, training and sampled-planning paths read.  The JAX
package's optional C++ extension is not built here; where the reference
leans on it for speed (the fused block planner), the port has a vectorised
NumPy route instead (``random_sample_fix_neighbor_vectorised``).
"""

from __future__ import annotations

import numpy as np

# The sampling stream: ADVANCES across calls and is recreated only by
# ``set_seed``, so successive plans draw different neighborhoods.
_fallback_rng = np.random.RandomState(0)


def set_seed(seed: int) -> None:
    """Restart the sampling stream from ``seed``."""
    global _fallback_rng
    _fallback_rng = np.random.RandomState(int(seed) & 0xFFFFFFFF)


def _rng(seed=None):
    """The persistent advancing stream, or a one-shot deterministic stream
    when an explicit ``seed`` is given."""
    if seed is None:
        return _fallback_rng
    return np.random.RandomState(int(seed) & 0xFFFFFFFF)


def unique_inverse(arr: np.ndarray):
    """Order-of-first-occurrence unique + inverse indices.  ``np.unique``
    sorts; first-occurrence order is part of the contract that the
    frontier merging relies on."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    uniq_sorted, first_idx, inv_sorted = np.unique(
        arr, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    uniq = uniq_sorted[order]
    remap = np.empty_like(order)
    remap[order] = np.arange(order.size)
    return uniq.astype(np.int32), remap[inv_sorted].astype(np.int32).ravel()


def row_indices_from_indptr(ind_ptr: np.ndarray, nnz: int) -> np.ndarray:
    """CSR -> COO row expansion."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    assert int(ind_ptr[-1]) == int(nnz)
    return np.repeat(
        np.arange(ind_ptr.size - 1, dtype=np.int32),
        np.diff(ind_ptr)).astype(np.int32)


def get_support(row_degrees, col_degrees, ind_ptr, end_points, symm=True):
    """Per-edge GCN support: ``1/sqrt(d_row * d_col)`` (``symm``) or
    ``1/d_row``, zero at zero-degree endpoints."""
    row_degrees = np.ascontiguousarray(row_degrees, dtype=np.int32)
    col_degrees = np.ascontiguousarray(col_degrees, dtype=np.int32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    nnz = end_points.size
    row_per_edge = np.repeat(np.arange(ind_ptr.size - 1), np.diff(ind_ptr))
    r_deg = row_degrees[row_per_edge].astype(np.float64)
    out = np.zeros(nnz, dtype=np.float32)
    if symm:
        c_deg = col_degrees[end_points].astype(np.float64)
        ok = (r_deg != 0) & (c_deg != 0)
        out[ok] = np.sqrt(1.0 / r_deg[ok] / c_deg[ok]).astype(np.float32)
    else:
        ok = r_deg != 0
        out[ok] = (1.0 / r_deg[ok]).astype(np.float32)
    return out


def csr_submat(ind_ptr, end_points, row_indices, col_indices, num_cols):
    """Row/column submatrix: the rows ``row_indices`` (in that order), each
    keeping, in CSR order, the edges whose column is in ``col_indices``.

    Columns are renumbered by their position in ``col_indices`` (not
    sorted).  Returns ``(new_ind_ptr, new_end_points, edge_idx)``, where
    ``edge_idx`` (int64) indexes the original edge arrays.  The JAX
    package's NumPy path walks the rows in a Python loop; this is the same
    result for all rows at once."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    row_indices = np.ascontiguousarray(row_indices, dtype=np.int32)
    col_indices = np.ascontiguousarray(col_indices, dtype=np.int32)
    col_map = np.full(num_cols, -1, dtype=np.int32)
    col_map[col_indices] = np.arange(col_indices.size, dtype=np.int32)
    starts = ind_ptr[row_indices].astype(np.int64)
    degs = (ind_ptr[row_indices + 1] - ind_ptr[row_indices]).astype(np.int64)
    total = int(degs.sum())
    # Every candidate edge position, row by row in the given order.
    first = np.cumsum(degs) - degs
    pos = (np.arange(total, dtype=np.int64)
           + np.repeat(starts - first, degs))
    cols = col_map[end_points[pos]]
    keep = cols >= 0
    counts = np.bincount(np.repeat(np.arange(row_indices.size), degs)[keep],
                         minlength=row_indices.size)
    new_ind_ptr = np.zeros(row_indices.size + 1, dtype=np.int32)
    np.cumsum(counts, out=new_ind_ptr[1:])
    return (new_ind_ptr, cols[keep].astype(np.int32),
            pos[keep].astype(np.int64))


def _take_counts(ind_ptr, sel_indices, num_neighbors):
    degs = ind_ptr[sel_indices + 1] - ind_ptr[sel_indices]
    take = degs if num_neighbors < 0 else np.minimum(degs, num_neighbors)
    new_ind_ptr = np.concatenate([[0], np.cumsum(take)]).astype(np.int32)
    return degs, take, new_ind_ptr


def random_sample_fix_neighbor(ind_ptr, sel_indices, num_neighbors,
                               seed=None):
    """Fixed-fanout sampling without replacement per selected row, one
    ``rng.choice`` per row that has more than ``num_neighbors`` edges: the
    same draws from the same seed as the JAX package's NumPy path.
    ``num_neighbors < 0`` keeps all neighbors (in order).  Returns
    ``(sampled_edge_indices, new_ind_ptr)``."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    sel_indices = np.ascontiguousarray(sel_indices, dtype=np.int32)
    rng = _rng(seed)
    _, take, new_ind_ptr = _take_counts(ind_ptr, sel_indices, num_neighbors)
    out = np.empty(int(new_ind_ptr[-1]), dtype=np.int64)
    for i, r in enumerate(sel_indices):
        beg, end = ind_ptr[r], ind_ptr[r + 1]
        n = take[i]
        if n == end - beg:
            out[new_ind_ptr[i]:new_ind_ptr[i + 1]] = np.arange(beg, end)
        else:
            out[new_ind_ptr[i]:new_ind_ptr[i + 1]] = rng.choice(
                np.arange(beg, end), size=n, replace=False)
    return out, new_ind_ptr


def random_sample_fix_neighbor_vectorised(ind_ptr, sel_indices,
                                          num_neighbors, seed=None):
    """``random_sample_fix_neighbor`` without the per-row Python loop.

    Same contract (uniform, without replacement, at most ``num_neighbors``
    per row; rows with no more edges than that keep all of them, in
    order), other draws: rows with more edges take a uniform
    ``num_neighbors``-subset by Floyd's algorithm, run over all such rows
    at once (``num_neighbors`` vectorised steps, each one random integer
    per row).  It stands where the JAX package has its fused native
    planner: the loop calls ``rng.choice`` once per frontier row, which
    materialises each row's full edge range."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    sel_indices = np.ascontiguousarray(sel_indices, dtype=np.int32)
    rng = _rng(seed)
    degs, take, new_ind_ptr = _take_counts(ind_ptr, sel_indices,
                                           num_neighbors)
    beg = ind_ptr[sel_indices].astype(np.int64)
    # Within-row offsets of every output slot; right for the rows that
    # keep all their edges, overwritten below for the sampled rows.
    offs = (np.arange(int(new_ind_ptr[-1]), dtype=np.int64)
            - np.repeat(new_ind_ptr[:-1].astype(np.int64), take))
    big = np.flatnonzero(degs > take)
    if big.size:
        k = int(num_neighbors)
        deg_big = degs[big].astype(np.int64)
        chosen = np.empty((big.size, k), np.int64)
        for i in range(k):
            j = deg_big - k + i
            t = (rng.random_sample(big.size) * (j + 1)).astype(np.int64)
            t = np.minimum(t, j)
            dup = (chosen[:, :i] == t[:, None]).any(axis=1)
            chosen[:, i] = np.where(dup, j, t)
        slots = (new_ind_ptr[big].astype(np.int64)[:, None]
                 + np.arange(k, dtype=np.int64)[None, :])
        offs[slots.ravel()] = chosen.ravel()
    return np.repeat(beg, take) + offs, new_ind_ptr
