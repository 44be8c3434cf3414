"""Host-side CSR matrix with global node ids and multi-link (rating) values.

The port's copy of ``stargcn_tpu/graph/csr.py``, cut to what building a
graph, splitting it into train/valid/test variants (transductive, or by
node subsets for inductive splits), exporting it for serving, planning
sampled neighborhoods and saving it need.  Every array it returns is
identical to the JAX package's for the same input.
"""

from __future__ import annotations

import numpy as np

from stargcn_tpu_torch.graph import kernels as K


class NodeIDRMap:
    """Dense id -> index reverse map over ``[ids.min(), ids.max()]``."""

    def __init__(self, node_ids: np.ndarray):
        node_ids = np.asarray(node_ids, dtype=np.int32)
        if node_ids.size == 0:
            self._base = 0
            self._rmap = np.full((1,), -1, dtype=np.int32)
            return
        self._base = int(node_ids.min())
        size = int(node_ids.max()) - self._base + 1
        self._rmap = np.full((size,), -1, dtype=np.int32)
        self._rmap[node_ids - self._base] = np.arange(
            node_ids.size, dtype=np.int32)

    def __getitem__(self, node_ids):
        return self._rmap[np.asarray(node_ids, dtype=np.int32) - self._base]

    def strict(self, node_ids):
        """Indices of ``node_ids``; raises ``ValueError`` if one is not in
        the map (``[]`` gives -1 inside the id range, and wraps or raises
        ``IndexError`` outside it)."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        off = node_ids.astype(np.int64) - self._base
        inside = (off >= 0) & (off < self._rmap.size)
        inds = np.where(inside, self._rmap[np.where(inside, off, 0)], -1)
        if (inds < 0).any():
            bad = node_ids[inds < 0]
            raise ValueError(f"{bad.size} node id(s) not in this graph, "
                             f"e.g. {int(bad[0])}")
        return inds.astype(np.int32)


class CSRMat:
    """CSR matrix keyed by global row/col node ids with float edge values.

    ``multi_link`` is the sorted array of possible edge (rating) values.
    Edge removal returns a new ``CSRMat`` in the same global id space.
    """

    def __init__(self, ind_ptr, end_points, values, row_ids, col_ids,
                 multi_link=None):
        self.ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
        self.end_points = np.ascontiguousarray(end_points, dtype=np.int32)
        self.values = np.ascontiguousarray(values, dtype=np.float32)
        self.row_ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        self.col_ids = np.ascontiguousarray(col_ids, dtype=np.int32)
        self.multi_link = (
            None if multi_link is None
            else np.sort(np.asarray(multi_link).astype(np.float32)))
        assert self.ind_ptr.shape[0] == self.row_ids.shape[0] + 1
        assert self.ind_ptr[0] == 0 and self.ind_ptr[-1] == self.nnz
        self._row_id_rmap = NodeIDRMap(self.row_ids)
        self._col_id_rmap = NodeIDRMap(self.col_ids)
        self._cached_node_pair_ids = None
        self._cached_col_degrees = None
        self._cached_support = {}

    @staticmethod
    def from_coo(rows, cols, values, num_rows, num_cols, multi_link=None):
        """Build from COO triples in index space (identity ids): columns
        sorted within each row, duplicate pairs summed (as
        ``scipy.sparse.coo_matrix(...).tocsr()`` does)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.float32)
        keys = rows * num_cols + cols
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        first = np.ones(keys.size, dtype=bool)
        first[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(first)
        vals = (np.add.reduceat(values[order], starts) if keys.size
                else values)
        keys = keys[starts]
        counts = np.bincount(keys // num_cols, minlength=num_rows)
        return CSRMat(
            ind_ptr=np.concatenate([[0], np.cumsum(counts)]),
            end_points=keys % num_cols, values=vals,
            row_ids=np.arange(num_rows, dtype=np.int32),
            col_ids=np.arange(num_cols, dtype=np.int32),
            multi_link=multi_link)

    @property
    def shape(self):
        return (self.row_ids.shape[0], self.col_ids.shape[0])

    @property
    def nnz(self):
        return self.end_points.shape[0]

    @property
    def size(self):
        """Edge count (alias of ``nnz``)."""
        return self.end_points.size

    @property
    def row_indices(self):
        """COO row index per edge."""
        return K.row_indices_from_indptr(self.ind_ptr, self.nnz)

    @property
    def node_pair_ids(self):
        """(2, nnz) [row_id; col_id] per edge."""
        if self._cached_node_pair_ids is None:
            self._cached_node_pair_ids = np.stack(
                [self.row_ids[self.row_indices],
                 self.col_ids[self.end_points]], axis=0)
        return self._cached_node_pair_ids

    @property
    def row_degrees(self):
        return np.ascontiguousarray(self.ind_ptr[1:] - self.ind_ptr[:-1])

    @property
    def col_degrees(self):
        if self._cached_col_degrees is None:
            self._cached_col_degrees = np.bincount(
                self.end_points, minlength=self.shape[1]).astype(np.int32)
        return self._cached_col_degrees

    def get_support(self, symm=True):
        """Per-edge GCN normalisation, cached per ``symm`` flag:
        ``1/sqrt(d_row*d_col)`` (symm) or ``1/d_row``, zeros at zero-degree
        endpoints.  Degrees are totals across rating levels."""
        if symm not in self._cached_support:
            self._cached_support[symm] = K.get_support(
                self.row_degrees.astype(np.int32),
                self.col_degrees.astype(np.int32),
                self.ind_ptr, self.end_points, bool(symm))
        return self._cached_support[symm]

    def row_id_to_ind(self, node_ids):
        return self._row_id_rmap[node_ids]

    def col_id_to_ind(self, node_ids):
        return self._col_id_rmap[node_ids]

    def rows_of(self, node_ids):
        """Row indices of ``node_ids``; raises ``ValueError`` for an id
        that is not a row of this matrix (``row_id_to_ind`` gives -1
        there, or another row's index outside the id range)."""
        return self._row_id_rmap.strict(node_ids)

    def _ids_to_inds(self, node_pair_ids):
        node_pair_ids = np.asarray(node_pair_ids)
        return np.stack([self.row_id_to_ind(node_pair_ids[0]),
                         self.col_id_to_ind(node_pair_ids[1])])

    # ----------------------------- submatrix -------------------------------

    def submat(self, row_indices=None, col_indices=None):
        """Submatrix by row/col indices: rows in the order given, columns
        renumbered by their position in ``col_indices``, edges in CSR
        order, in the same global id space."""
        if row_indices is None:
            row_indices = np.arange(self.shape[0], dtype=np.int32)
        if col_indices is None:
            col_indices = np.arange(self.shape[1], dtype=np.int32)
        row_indices = np.atleast_1d(np.asarray(row_indices, dtype=np.int32))
        col_indices = np.atleast_1d(np.asarray(col_indices, dtype=np.int32))
        ind_ptr, end_points, edge_idx = K.csr_submat(
            self.ind_ptr, self.end_points, row_indices, col_indices,
            self.shape[1])
        return CSRMat(
            ind_ptr=ind_ptr, end_points=end_points,
            values=self.values[edge_idx],
            row_ids=self.row_ids[row_indices],
            col_ids=self.col_ids[col_indices],
            multi_link=self.multi_link)

    def submat_by_id(self, row_ids=None, col_ids=None):
        """Submatrix by global ids (``submat`` of their indices)."""
        row_indices = None if row_ids is None else self.row_id_to_ind(row_ids)
        col_indices = None if col_ids is None else self.col_id_to_ind(col_ids)
        return self.submat(row_indices, col_indices)

    # --------------------------- edge lookups -------------------------------

    def edge_indices_by_pair_indices(self, node_pair_indices):
        """Positions (into the edge arrays) of (2, N) [row_index;
        col_index] pairs; -1 when the pair is not an edge."""
        node_pair_indices = np.asarray(node_pair_indices, dtype=np.int64)
        key_edges = (self.row_indices.astype(np.int64) * self.shape[1]
                     + self.end_points)
        order = np.argsort(key_edges, kind="stable")
        sorted_keys = key_edges[order]
        q = node_pair_indices[0] * self.shape[1] + node_pair_indices[1]
        pos = np.searchsorted(sorted_keys, q)
        pos = np.clip(pos, 0, max(sorted_keys.size - 1, 0))
        out = np.full(q.shape, -1, dtype=np.int64)
        if sorted_keys.size:
            found = sorted_keys[pos] == q
            out[found] = order[pos[found]]
        return out

    def edge_indices_by_id(self, node_pair_ids):
        """Positions of the given [row_id; col_id] pairs; -1 when
        absent."""
        return self.edge_indices_by_pair_indices(
            self._ids_to_inds(node_pair_ids))

    def fetch_edges_by_ind(self, node_pair_indices):
        """Edge values for (2, N) [row_index; col_index] pairs; 0 when the
        pair is not an edge."""
        idx = self.edge_indices_by_pair_indices(node_pair_indices)
        out = np.zeros(idx.shape, dtype=np.float32)
        out[idx >= 0] = self.values[idx[idx >= 0]]
        return out

    def fetch_edges_by_id(self, node_pair_ids):
        """Edge values for (2, N) [row_id; col_id] pairs; 0 when the pair
        is not an edge."""
        return self.fetch_edges_by_ind(self._ids_to_inds(node_pair_ids))

    # --------------------------- edge removal -------------------------------

    def remove_edges_by_ind(self, node_pair_indices):
        """New CSRMat without the given [row_index; col_index] edges."""
        edge_idx = self.edge_indices_by_pair_indices(node_pair_indices)
        keep = np.ones(self.nnz, dtype=bool)
        keep[edge_idx[edge_idx >= 0]] = False
        row_idx = self.row_indices[keep]
        new_ind_ptr = np.zeros(self.shape[0] + 1, dtype=np.int32)
        np.add.at(new_ind_ptr[1:], row_idx, 1)
        new_ind_ptr = np.cumsum(new_ind_ptr).astype(np.int32)
        return CSRMat(
            ind_ptr=new_ind_ptr, end_points=self.end_points[keep],
            values=self.values[keep], row_ids=self.row_ids,
            col_ids=self.col_ids, multi_link=self.multi_link)

    def remove_edges_by_id(self, node_pair_ids):
        """New CSRMat without the given [row_id; col_id] edges."""
        return self.remove_edges_by_ind(self._ids_to_inds(node_pair_ids))

    @property
    def T(self):
        """Transposed CSRMat.  A stable sort of the edges by column keeps
        each new row's entries in ascending original-row order."""
        perm = np.argsort(self.end_points, kind="stable")
        counts = np.bincount(self.end_points, minlength=self.shape[1])
        return CSRMat(
            ind_ptr=np.concatenate([[0], np.cumsum(counts)]),
            end_points=self.row_indices[perm],
            values=self.values[perm],
            row_ids=self.col_ids, col_ids=self.row_ids,
            multi_link=self.multi_link)

    # -------------------------- persistence / checks ------------------------

    def save(self, fname):
        """One compressed ``.npz`` in the JAX package's layout, so either
        package loads what the other saved."""
        np.savez_compressed(
            fname, row_ids=self.row_ids, col_ids=self.col_ids,
            values=self.values, ind_ptr=self.ind_ptr,
            end_points=self.end_points,
            multi_link=(np.array([]) if self.multi_link is None
                        else self.multi_link))

    @staticmethod
    def load(fname):
        d = np.load(fname)
        ml = d["multi_link"]
        return CSRMat(
            ind_ptr=d["ind_ptr"], end_points=d["end_points"],
            values=d["values"], row_ids=d["row_ids"], col_ids=d["col_ids"],
            multi_link=None if ml.size == 0 else ml)

    def issubmat(self, other) -> bool:
        """True if every edge of ``self`` exists in ``other`` with the
        same value (and every row and column id of ``self`` is one of
        ``other``'s)."""
        if not (set(self.row_ids.tolist()) <= set(other.row_ids.tolist())
                and set(self.col_ids.tolist())
                <= set(other.col_ids.tolist())):
            return False
        vals = other.fetch_edges_by_id(self.node_pair_ids)
        return bool(np.allclose(vals, self.values))

    def check_consistency(self):
        """Invariants: indptr monotone, column indices in range, no
        column twice within a row (raises ``AssertionError``)."""
        assert np.all(np.diff(self.ind_ptr) >= 0)
        assert self.nnz == 0 or self.end_points.max() < self.shape[1]
        keys = np.sort(self.row_indices.astype(np.int64) * self.shape[1]
                       + self.end_points)
        dup = np.flatnonzero(keys[1:] == keys[:-1])
        assert dup.size == 0, \
            f"dup endpoints row {int(keys[dup[0]] // self.shape[1])}"

    def __repr__(self):
        ml = None if self.multi_link is None else list(self.multi_link)
        return f"CSRMat(shape={self.shape}, nnz={self.nnz}, multi_link={ml})"
