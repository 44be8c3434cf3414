"""Host graph kernels: the port's C++ extension and the NumPy versions.

The port of ``stargcn_tpu/graph/kernels.py``: the same functions, signatures
and return dtypes.  The C++/OpenMP extension (``csrc/graph_kernels.cpp``,
the port's copy of the JAX package's ``native/graph_kernels.cpp``) is built
at first use by ``graph/native.py``; ``native_module()`` loads it, and a
failed build raises: nothing falls back to numpy.

Routes, and why:

* native by default, each returning its NumPy version's answer bit for bit
  (held so in ``tests/test_torch_native.py``): ``unique_inverse``,
  ``unique_cnt``, ``take_1d`` (int32 and float32 data),
  ``row_indices_from_indptr``, ``seg_sum``, ``seg_add``, ``seg_mul``,
  ``csr_submat``, ``multi_link_split``, ``remove_edges_by_indices``.
  Indices outside the arrays and values that do not fit their segments,
  which the C++ does not check, take the NumPy version, which raises or
  wraps as numpy does;
* NumPy by default: ``get_support`` (the C++ rounds ``1/sqrt(d_r d_c)`` in
  float32, numpy in float64: the two differ in the last bit), and the
  random ones, ``random_sample_fix_neighbor``, ``random_walk``,
  ``get_random_walk_nodes``, ``uniform_neg_sampling`` and
  ``random_sel_neighbor_and_merge`` (draws from the NumPy stream, the JAX
  package's NumPy draws from the same seed).  Their native versions are
  ``native_module().<name>``, with the JAX package's extension's arguments
  (int32 arrays);
* native only: ``sample_block_ell``, the fused block planner of
  ``BlockSampler(planner="native")``, and ``set_omp_threads``;
* NumPy only: ``random_sample_fix_neighbor_vectorised`` (the
  ``'vectorised'`` planner).

Every NumPy version that a native route replaces is kept as
``plain_<name>``.  ``set_seed`` restarts both streams: the NumPy one, and the
extension's counter-based draws, which are a function of the seed and of how
many random calls were made since (``csrc/graph_kernels.cpp``).
"""

from __future__ import annotations

import threading

import numpy as np

from stargcn_tpu_torch.graph import native

# The sampling stream: ADVANCES across calls and is recreated only by
# ``set_seed``, so successive plans draw different neighborhoods.
_fallback_rng = np.random.RandomState(0)
_seed = 0
_native = None
_native_lock = threading.Lock()


def native_module():
    """The C++ extension, built and loaded at first use (then cached), with
    the draws seeded from the last ``set_seed``.  Raises ``RuntimeError``
    when it cannot be built or loaded."""
    global _native
    if _native is None:
        with _native_lock:
            if _native is None:
                module = native.load()
                module.set_seed(_seed & 0xFFFFFFFFFFFFFFFF)
                _native = module
    return _native


def has_native() -> bool:
    """Whether this process has loaded the extension."""
    return _native is not None


def set_seed(seed: int) -> None:
    """Restart the sampling streams from ``seed``: the NumPy stream, and the
    extension's draws (their random calls counted from 0 again)."""
    global _fallback_rng, _seed
    with _native_lock:
        _seed = int(seed)
        _fallback_rng = np.random.RandomState(_seed & 0xFFFFFFFF)
        if _native is not None:
            _native.set_seed(_seed & 0xFFFFFFFFFFFFFFFF)


def set_omp_threads(n: int) -> int:
    """Cap the OpenMP team size of the extension's kernels called from the
    CALLING thread (a per-thread setting); ``n <= 0`` leaves it.  Returns the
    resulting largest team size."""
    return int(native_module().set_omp_threads(int(n)))


def _rng(seed=None):
    """The persistent advancing stream, or a one-shot deterministic stream
    when an explicit ``seed`` is given."""
    if seed is None:
        return _fallback_rng
    return np.random.RandomState(int(seed) & 0xFFFFFFFF)


def _in_range(idx, n) -> bool:
    """Whether every index of ``idx`` lies in ``[0, n)``."""
    return idx.size == 0 or (int(idx.min()) >= 0 and int(idx.max()) < n)


def _segments_fit(indptr, values, per_segment=None) -> bool:
    """Whether ``values`` has one entry per edge of the segments
    ``indptr`` (and ``per_segment`` one per segment)."""
    return (indptr.size >= 1 and values.size == int(indptr[-1])
            and (per_segment is None
                 or per_segment.size == indptr.size - 1))


def unique_inverse(arr: np.ndarray):
    """Order-of-first-occurrence unique + inverse indices (int32)."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    return native_module().unique_inverse(arr)


def plain_unique_inverse(arr: np.ndarray):
    """``unique_inverse`` in numpy.  ``np.unique`` sorts; first-occurrence
    order is part of the contract that the frontier merging relies on."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    uniq_sorted, first_idx, inv_sorted = np.unique(
        arr, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    uniq = uniq_sorted[order]
    remap = np.empty_like(order)
    remap[order] = np.arange(order.size)
    return uniq.astype(np.int32), remap[inv_sorted].astype(np.int32).ravel()


def unique_cnt(arr: np.ndarray):
    """Unique values (first-occurrence order) and their counts."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    return native_module().unique_cnt(arr)


def plain_unique_cnt(arr: np.ndarray):
    """``unique_cnt`` in numpy."""
    uniq, inv = plain_unique_inverse(arr)
    cnt = np.zeros(uniq.size, dtype=np.int32)
    np.add.at(cnt, inv, 1)
    return uniq, cnt


def take_1d(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """1-D gather ``data[indices]``: native (in parallel) for int32 and
    float32 data."""
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.asarray(data)
    if data.dtype in (np.int32, np.float32) and _in_range(indices,
                                                          data.size):
        return native_module().take_1d(np.ascontiguousarray(data).ravel(),
                                       indices)
    return plain_take_1d(data, indices)


def plain_take_1d(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``take_1d`` in numpy."""
    return np.take(data, np.ascontiguousarray(indices, dtype=np.int32))


def row_indices_from_indptr(ind_ptr: np.ndarray, nnz: int) -> np.ndarray:
    """CSR -> COO row expansion."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    if int(ind_ptr[-1]) != int(nnz):
        raise ValueError(f"ind_ptr ends at {int(ind_ptr[-1])}, not at nnz "
                         f"{int(nnz)}")
    return native_module().gen_row_indices_by_indptr(ind_ptr, int(nnz))


def plain_row_indices_from_indptr(ind_ptr: np.ndarray,
                                  nnz: int) -> np.ndarray:
    """``row_indices_from_indptr`` in numpy."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    assert int(ind_ptr[-1]) == int(nnz)
    return np.repeat(
        np.arange(ind_ptr.size - 1, dtype=np.int32),
        np.diff(ind_ptr)).astype(np.int32)


def seg_sum(data: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Sum of each CSR segment of ``data`` (float32, in segment order)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    if not _segments_fit(indptr, data):
        return plain_seg_sum(data, indptr)
    return native_module().seg_sum(data, indptr)


def plain_seg_sum(data: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """``seg_sum`` in numpy."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    seg_ids = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    out = np.zeros(indptr.size - 1, dtype=np.float32)
    np.add.at(out, seg_ids, data)
    return out


def seg_add(lhs: np.ndarray, rhs: np.ndarray, indptr: np.ndarray):
    """``out[j] = lhs[j] + rhs[seg(j)]`` (float32)."""
    lhs = np.ascontiguousarray(lhs, dtype=np.float32)
    rhs = np.ascontiguousarray(rhs, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    if not _segments_fit(indptr, lhs, rhs):
        return plain_seg_add(lhs, rhs, indptr)
    return native_module().seg_add(lhs, rhs, indptr)


def plain_seg_add(lhs: np.ndarray, rhs: np.ndarray, indptr: np.ndarray):
    """``seg_add`` in numpy."""
    lhs = np.ascontiguousarray(lhs, dtype=np.float32)
    rhs = np.ascontiguousarray(rhs, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    return lhs + np.repeat(rhs, np.diff(indptr))


def seg_mul(lhs: np.ndarray, rhs: np.ndarray, indptr: np.ndarray):
    """``out[j] = lhs[j] * rhs[seg(j)]`` (float32)."""
    lhs = np.ascontiguousarray(lhs, dtype=np.float32)
    rhs = np.ascontiguousarray(rhs, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    if not _segments_fit(indptr, lhs, rhs):
        return plain_seg_mul(lhs, rhs, indptr)
    return native_module().seg_mul(lhs, rhs, indptr)


def plain_seg_mul(lhs: np.ndarray, rhs: np.ndarray, indptr: np.ndarray):
    """``seg_mul`` in numpy."""
    lhs = np.ascontiguousarray(lhs, dtype=np.float32)
    rhs = np.ascontiguousarray(rhs, dtype=np.float32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    return lhs * np.repeat(rhs, np.diff(indptr))


def get_support(row_degrees, col_degrees, ind_ptr, end_points, symm=True):
    """Per-edge GCN support: ``1/sqrt(d_row * d_col)`` (``symm``) or
    ``1/d_row``, zero at zero-degree endpoints, rounded from float64.  (The
    extension's ``get_support`` rounds in float32.)"""
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
    ``edge_idx`` (int64) indexes the original edge arrays."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    row_indices = np.ascontiguousarray(row_indices, dtype=np.int32)
    col_indices = np.ascontiguousarray(col_indices, dtype=np.int32)
    if not (_in_range(row_indices, ind_ptr.size - 1)
            and _in_range(col_indices, num_cols)):
        return plain_csr_submat(ind_ptr, end_points, row_indices,
                                col_indices, num_cols)
    return native_module().csr_submat(ind_ptr, end_points, row_indices,
                                      col_indices, int(num_cols))


def plain_csr_submat(ind_ptr, end_points, row_indices, col_indices,
                     num_cols):
    """``csr_submat`` in numpy, for all rows at once (the JAX package's
    NumPy path walks the rows in a Python loop; the result is the same)."""
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


def multi_link_split(edge_values, ind_ptr, multi_link):
    """Partition edges into per-rating-value index lists + per-value indptr.

    Returns ``(split_indices, ind_ptr_l)``: for each rating value ``v`` in
    ``multi_link``, the edge positions with that value (int32, in CSR
    order) and the per-row indptr (int32) of the resulting sub-CSR.
    """
    edge_values = np.ascontiguousarray(edge_values, dtype=np.float32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    multi_link = np.ascontiguousarray(multi_link, dtype=np.float32)
    if not _segments_fit(ind_ptr, edge_values):
        return plain_multi_link_split(edge_values, ind_ptr, multi_link)
    return native_module().multi_link_split(edge_values, ind_ptr, multi_link)


def plain_multi_link_split(edge_values, ind_ptr, multi_link):
    """``multi_link_split`` in numpy."""
    edge_values = np.ascontiguousarray(edge_values, dtype=np.float32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    multi_link = np.ascontiguousarray(multi_link, dtype=np.float32)
    num_rows = ind_ptr.size - 1
    row_per_edge = np.repeat(np.arange(num_rows), np.diff(ind_ptr))
    split_indices, ind_ptr_l = [], []
    for v in multi_link:
        sel = np.nonzero(edge_values == v)[0].astype(np.int32)
        split_indices.append(sel)
        counts = np.bincount(row_per_edge[sel], minlength=num_rows)
        ind_ptr_l.append(np.concatenate([[0], np.cumsum(counts)])
                         .astype(np.int32))
    return split_indices, ind_ptr_l


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


def random_walk(end_points, ind_ptr, initial_node=-1, walk_length=100,
                return_prob=0.15, max_node_num=10**9, max_edge_num=10**12):
    """Random-walk-with-restart subgraph sampling from ``initial_node`` (a
    random node when negative): each step returns to the start with
    ``return_prob``, else moves to a uniform neighbor.  Returns the
    ``(src, dst)`` arrays (int32) of the distinct edges walked, in order."""
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    rng = _rng()
    node_num = ind_ptr.size - 1
    if initial_node < 0:
        initial_node = rng.randint(node_num)
    cur, edges, nodes = initial_node, set(), {initial_node}
    src, dst = [], []
    for _ in range(walk_length):
        if rng.rand() < return_prob:
            cur = initial_node
            continue
        beg, end = ind_ptr[cur], ind_ptr[cur + 1]
        if end <= beg:
            break
        nxt = int(end_points[rng.randint(beg, end)])
        if (cur, nxt) not in edges:
            if len(edges) >= max_edge_num:
                break
            nodes.add(nxt)
            if len(nodes) > max_node_num:
                break
            edges.add((cur, nxt))
            src.append(cur)
            dst.append(nxt)
        cur = nxt
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32))


def get_random_walk_nodes(end_points, ind_ptr, initial_node,
                          max_node_num, walk_length):
    """The distinct nodes (int32, in visiting order) of a plain random walk
    from ``initial_node``, stopping at ``max_node_num`` of them."""
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    rng = _rng()
    seen = [int(initial_node)]
    seen_set = {int(initial_node)}
    cur = int(initial_node)
    for _ in range(walk_length):
        beg, end = ind_ptr[cur], ind_ptr[cur + 1]
        if end <= beg:
            break
        cur = int(end_points[rng.randint(beg, end)])
        if cur not in seen_set:
            seen_set.add(cur)
            seen.append(cur)
        if len(seen_set) >= max_node_num:
            break
    return np.asarray(seen, np.int32)


def uniform_neg_sampling(end_points, ind_ptr, target_indices, node_num,
                         neg_sample_scale=1.0, replace=False):
    """Each target row's positive edges, then uniform negatives among the
    columns it has no edge to (``ceil(pos * neg_sample_scale)`` of them, as
    many as exist without ``replace``).  Returns ``(end_points, ind_ptr,
    edge_label (+1/-1), edge_count)``, all int32; with ``replace`` a
    negative drawn twice is one entry of count 2."""
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    target_indices = np.ascontiguousarray(target_indices, dtype=np.int32)
    rng = _rng()
    out_ep, out_label, out_cnt = [], [], []
    out_ptr = [0]
    for ind in target_indices:
        beg, end = ind_ptr[ind], ind_ptr[ind + 1]
        pos = end - beg
        if pos > 0:
            pos_set = set(end_points[beg:end].tolist())
            want = min(int(np.ceil(pos * neg_sample_scale)), int(node_num))
            out_ep.extend(end_points[beg:end].tolist())
            out_label.extend([1] * pos)
            out_cnt.extend([1] * pos)
            candidates = np.setdiff1d(np.arange(node_num),
                                      np.asarray(sorted(pos_set)))
            if candidates.size:
                k = min(want, candidates.size) if not replace else want
                negs = rng.choice(candidates, size=k, replace=replace)
                if replace:
                    vals, cnts = np.unique(negs, return_counts=True)
                    out_ep.extend(vals.tolist())
                    out_cnt.extend(cnts.tolist())
                    out_label.extend([-1] * vals.size)
                else:
                    out_ep.extend(negs.tolist())
                    out_cnt.extend([1] * k)
                    out_label.extend([-1] * k)
        out_ptr.append(len(out_ep))
    return (np.asarray(out_ep, np.int32), np.asarray(out_ptr, np.int32),
            np.asarray(out_label, np.int32), np.asarray(out_cnt, np.int32))


def random_sel_neighbor_and_merge(end_points, ind_ptr, node_ids,
                                  sel_indices, num_neighbors):
    """Fanout-sample the neighbors of the selected rows and merge (selected
    + neighbors) into a first-occurrence-unique frontier.

    Returns ``(dst_end_points [positions in merged], dst_ind_ptr,
    merged_node_ids, indices_in_merged)``, all int32.
    """
    end_points = np.ascontiguousarray(end_points, dtype=np.int32)
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    node_ids = np.ascontiguousarray(node_ids, dtype=np.int32)
    sel_indices = np.ascontiguousarray(sel_indices, dtype=np.int32)
    rng = _rng()
    merged, merged_map = [], {}

    def intern(nid):
        nid = int(nid)
        if nid not in merged_map:
            merged_map[nid] = len(merged)
            merged.append(nid)
        return merged_map[nid]

    dst_ep, dst_ptr, sel_in_merged = [], [0], []
    for ind in sel_indices:
        sel_in_merged.append(intern(node_ids[ind]))
        beg, end = ind_ptr[ind], ind_ptr[ind + 1]
        deg = end - beg
        take = deg if num_neighbors < 0 else min(deg, num_neighbors)
        picks = (np.arange(beg, end) if take == deg else
                 rng.choice(np.arange(beg, end), take, replace=False))
        for j in picks:
            dst_ep.append(intern(node_ids[end_points[j]]))
        dst_ptr.append(len(dst_ep))
    return (np.asarray(dst_ep, np.int32), np.asarray(dst_ptr, np.int32),
            np.asarray(merged, np.int32),
            np.asarray(sel_in_merged, np.int32))


def remove_edges_by_indices(ind_ptr, end_points, remove_edge_idx):
    """A CSR without the edges at the given positions: returns
    ``(new_ind_ptr (int32), keep_mask)``."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    remove_edge_idx = np.ascontiguousarray(remove_edge_idx, dtype=np.int64)
    if not _in_range(remove_edge_idx, int(ind_ptr[-1])):
        return plain_remove_edges_by_indices(ind_ptr, end_points,
                                             remove_edge_idx)
    return native_module().remove_edges_by_indices(ind_ptr, remove_edge_idx)


def plain_remove_edges_by_indices(ind_ptr, end_points, remove_edge_idx):
    """``remove_edges_by_indices`` in numpy."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    nnz = int(ind_ptr[-1])
    keep = np.ones(nnz, dtype=bool)
    keep[np.asarray(remove_edge_idx, dtype=np.int64)] = False
    row_per_edge = np.repeat(np.arange(ind_ptr.size - 1), np.diff(ind_ptr))
    new_ptr = np.zeros(ind_ptr.size, dtype=np.int32)
    np.add.at(new_ptr[1:], row_per_edge[keep], 1)
    return np.cumsum(new_ptr).astype(np.int32), keep


def sample_block_ell(ind_ptr, end_points, col_ids, rating_idx,
                     inv_row, inv_col, sel_rows, frontier_other,
                     exclude_keys, id_cap, fanout, n_dst, row_is_user,
                     key_mult):
    """The fused planner of one (level, node type): for each row of
    ``sel_rows``, at most ``fanout`` of its edges drawn without replacement
    (Floyd's algorithm, from the row's own stream), each slot's support
    ``inv_row[row] * inv_col[col]`` (removal-adjusted degrees fold into
    the two vectors), zero on the batch edges of the sorted
    ``exclude_keys`` (``row * key_mult + col`` keys of users' rows), and
    the neighbor ids interned in first-occurrence order into the next
    frontier, which starts as ``frontier_other``.

    Returns ``(nbr_pos, weight, rating, merged_ids)``: the first three
    ``(n_dst, fanout)``, padded rows and slots zero."""
    nbr_pos, weight, rating, merged = native_module().sample_block_ell(
        np.ascontiguousarray(ind_ptr, np.int32),
        np.ascontiguousarray(end_points, np.int32),
        np.ascontiguousarray(col_ids, np.int32),
        np.ascontiguousarray(rating_idx, np.int32),
        np.ascontiguousarray(inv_row, np.float32),
        np.ascontiguousarray(inv_col, np.float32),
        np.ascontiguousarray(sel_rows, np.int32),
        np.ascontiguousarray(frontier_other, np.int32),
        np.ascontiguousarray(exclude_keys, np.int64),
        int(id_cap), int(fanout), int(n_dst), int(row_is_user),
        int(key_mult))
    fan = int(fanout)
    return (nbr_pos.reshape(-1, fan), weight.reshape(-1, fan),
            rating.reshape(-1, fan), merged)
