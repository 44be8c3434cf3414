"""Training/evaluation samplers and graph-variant bookkeeping.

The port's copy of ``stargcn_tpu/data/iterators.py``: ``DataIterator``,
``NegEdgeGenerator`` and its ``_RankSpaceSampler``.

* graph hierarchy: ``test_graph = all - test edges``; transductively
  ``val_graph = train_graph = test_graph - valid edges``; inductively
  ``val_graph = subgraph(train + valid nodes) - valid edges`` and
  ``train_graph = subgraph(train nodes)``, the held-out type's node set
  shrinking in both;
* ``rating_sampler``: infinite epoch-shuffled batches for training,
  sequential batches for evaluation;
* ``recon_nodes_sampler``: per epoch a ``P_mask`` fraction of each node
  type becomes reconstruction targets, each masked to zero (-1) or kept
  (its own id) by ``(p_zero, p_self)``, in a full-size ``embed_noise``
  array;
* ``evaluate_embed_noise_dict``: at evaluation, nodes unseen in the train
  graph are masked to zero (-1), every other node keeps its own id: the
  inductive cold-start mechanism.

One ``np.random.RandomState(seed)`` is consumed in the JAX class's order,
so the same seed gives the same batches, noise arrays and recon ids in both
packages; ``NegEdgeGenerator`` likewise draws what the JAX class draws from
the same generator.
"""

from __future__ import annotations

import numpy as np


class _RankSpaceSampler:
    """Uniform draws from the complement of a sparse row set by rank-space
    inversion.

    For one row with sorted positive columns ``P`` over ``[0, ncols)``,
    the k-th (0-based) NON-neighbor is ``k + i*`` where ``i* =
    searchsorted(P - arange(|P|), k, 'right')``: ``P[i] - i`` counts the
    non-neighbors below ``P[i]``, so one binary search inverts the rank.
    Exact (rejection-free), O(log deg) per draw, no per-edge state.
    """

    def __init__(self, indptr, indices, width):
        self.indptr = np.asarray(indptr, np.int64)
        self.width = int(width)
        deg = np.diff(self.indptr)
        # Each row's columns sorted (CSRMat does not guarantee the order).
        cols = np.asarray(indices, np.int64)
        rows = np.repeat(np.arange(deg.size), deg)
        self.sorted_cols = cols[np.lexsort((cols, rows))]
        self.free = (self.width - deg).astype(np.int64)  # non-neighbors/row

    def draw(self, rows, rng):
        """One uniform non-neighbor per row (rows must have free > 0).

        The rank ``k`` of each draw takes one uniform, in request order;
        then all draws are inverted together by one batched binary search
        over each row's CSR window (``i = #{j : p[j] - j <= k}`` on the
        non-decreasing rank-deficit sequence): ``log2(max_deg)`` numpy
        passes for the whole batch, no Python loop over rows."""
        rows = np.asarray(rows, np.int64)
        k = (rng.random_sample(rows.size) * self.free[rows]).astype(np.int64)
        s = self.indptr[rows]
        deg = self.indptr[rows + 1] - s
        lo = np.zeros(rows.size, np.int64)
        hi = deg.copy()
        active = lo < hi
        while active.any():
            mid = (lo + hi) >> 1
            # p[mid] - mid <= k: the answer lies above mid.  The index
            # clamp only fires on inactive lanes (rows of degree 0).
            idx = np.minimum(s + mid, self.sorted_cols.size - 1)
            v = self.sorted_cols[idx]
            up = active & (v - mid <= k)
            lo = np.where(up, mid + 1, lo)
            hi = np.where(active & ~up, mid, hi)
            active = lo < hi
        return k + lo


class NegEdgeGenerator:
    """Uniform negative (non-edge) sampling over a bipartite rating graph,
    by rank-space inversion per endpoint (``_RankSpaceSampler``): exact
    uniformity, O(log deg) per draw, no per-edge tables.  The ranking
    evaluation draws its negatives from it."""

    def __init__(self, rng, csr_mat):
        self._rng = rng
        self._csr = csr_mat
        nrows, ncols = csr_mat.shape
        rows_of = np.repeat(np.arange(nrows, dtype=np.int64),
                            np.diff(csr_mat.ind_ptr))
        self._by_row = _RankSpaceSampler(csr_mat.ind_ptr,
                                         csr_mat.end_points, ncols)
        # column-major view for sampling rows given a column
        order = np.argsort(csr_mat.end_points, kind="stable")
        col_indptr = np.zeros(ncols + 1, np.int64)
        np.cumsum(np.bincount(csr_mat.end_points, minlength=ncols),
                  out=col_indptr[1:])
        self._by_col = _RankSpaceSampler(col_indptr, rows_of[order], nrows)
        w = self._by_row.free.astype(np.float64)
        self._row_weights = w / w.sum()

    def sample_pairs(self, n):
        """n uniform non-edges: rows weighted by their non-edge count
        (= uniform over the global non-edge set), then one uniform
        non-neighbor column each."""
        rows = self._rng.choice(self._by_row.free.size, n, replace=True,
                                p=self._row_weights).astype(np.int64)
        return rows, self._by_row.draw(rows, self._rng)

    def sample_cols_for_rows(self, rows, rng=None):
        """One uniform non-neighbor column per row.  ``rng`` overrides
        the construction-time generator, so a caller can pin the draws
        independently of how far the shared generator has advanced."""
        return self._by_row.draw(rows, rng if rng is not None else self._rng)

    def sample_rows_for_cols(self, cols):
        return self._by_col.draw(cols, self._rng)

    def gen(self, pos_edges, neg_sample_type="all", neg_ratio=1.0):
        """Negative edges for the given positives.  ``'same_node'`` keeps
        one endpoint of each positive (coin flip, falling back to the
        other side or a fresh pair when an endpoint is saturated);
        ``'all'`` draws ``neg_ratio * npos`` fresh non-edges."""
        csr = self._csr
        pos_r = np.asarray(csr.row_id_to_ind(pos_edges[0]), np.int64)
        pos_c = np.asarray(csr.col_id_to_ind(pos_edges[1]), np.int64)
        if neg_sample_type == "all":
            rows, cols = self.sample_pairs(
                int(np.round(neg_ratio * pos_r.size)))
        elif neg_sample_type == "same_node":
            keep_row = self._rng.randint(2, size=pos_r.size).astype(bool)
            # a saturated endpoint (no non-neighbors) flips to the other
            # side; both saturated -> fresh pair
            keep_row &= self._by_row.free[pos_r] > 0
            use_col = ~keep_row & (self._by_col.free[pos_c] > 0)
            fresh = ~keep_row & ~use_col
            rows = pos_r.copy()
            cols = pos_c.copy()
            cols[keep_row] = self._by_row.draw(pos_r[keep_row], self._rng)
            rows[use_col] = self._by_col.draw(pos_c[use_col], self._rng)
            if fresh.any():
                rows[fresh], cols[fresh] = self.sample_pairs(
                    int(fresh.sum()))
        else:
            raise NotImplementedError(neg_sample_type)
        return np.stack([csr.row_ids[rows], csr.col_ids[cols]])


class DataIterator:
    """Graph hierarchy over one user-item rating graph, transductive or
    inductive, with the rating and reconstruction samplers.

    Inductive (``is_inductive``): ``inductive_key`` names the held-out node
    type; ``inductive_train_ids`` / ``inductive_valid_ids`` are its train
    and valid nodes (the rest are test nodes).  ``embed_p_zero`` /
    ``embed_p_self`` may then be ``{node_type: p}`` dicts.
    """

    def __init__(self, all_graph, name_user, name_item, is_inductive=False,
                 test_node_pairs=None, valid_node_pairs=None,
                 inductive_key=None, inductive_valid_ids=None,
                 inductive_train_ids=None, embed_P_mask=0.1,
                 embed_p_zero=1.0, embed_p_self=0.0, seed=100):
        self._rng = np.random.RandomState(seed=seed)
        self._all_graph = all_graph
        self._name_user = name_user
        self._name_item = name_item
        self._is_inductive = bool(is_inductive)

        self._test_graph = all_graph.remove_edges_by_id(
            name_user, name_item, test_node_pairs)
        if not is_inductive:
            self._val_graph = self._test_graph.remove_edges_by_id(
                name_user, name_item, valid_node_pairs)
            self._train_graph = self._val_graph
        else:
            if inductive_key is None:
                raise ValueError("an inductive split needs inductive_key")
            train_val = np.concatenate(
                [inductive_train_ids, inductive_valid_ids]).astype(np.int32)
            self._val_graph = all_graph.sel_subgraph_by_id(
                inductive_key, train_val).remove_edges_by_id(
                    name_user, name_item, valid_node_pairs)
            self._train_graph = all_graph.sel_subgraph_by_id(
                inductive_key, inductive_train_ids)

        self._test_node_pairs = np.asarray(test_node_pairs, np.int32)
        self._valid_node_pairs = np.asarray(valid_node_pairs, np.int32)
        train_csr = self._train_graph[name_user, name_item]
        self._train_node_pairs = train_csr.node_pair_ids
        self._train_ratings = train_csr.values
        self._valid_ratings = all_graph.fetch_edges_by_id(
            name_user, name_item, self._valid_node_pairs)
        self._test_ratings = all_graph.fetch_edges_by_id(
            name_user, name_item, self._test_node_pairs)

        def as_dict(v):
            return (dict(v) if isinstance(v, dict)
                    else {k: v for k in all_graph.meta_graph})

        self._embed_P_mask = as_dict(embed_P_mask)
        self._embed_p_zero = as_dict(embed_p_zero)
        self._embed_p_self = as_dict(embed_p_self)
        for key in self._embed_P_mask:
            if abs(self._embed_p_zero[key] + self._embed_p_self[key]
                   - 1.0) >= 1e-9:
                raise ValueError(
                    f"embed_p_zero + embed_p_self must be 1 for {key!r}")

        self._recon_train_candidates = {}
        self._evaluate_embed_noise_dict = {}
        for key in self._train_graph.meta_graph:
            train_ids = self._train_graph.node_ids[key]
            self._recon_train_candidates[key] = train_ids
            noise = -np.ones(self._all_graph.node_ids[key].shape, np.int32)
            noise[train_ids] = train_ids
            self._evaluate_embed_noise_dict[key] = noise

    @property
    def possible_rating_values(self):
        return self._all_graph[self._name_user, self._name_item].multi_link

    @property
    def name_user(self):
        return self._name_user

    @property
    def name_item(self):
        return self._name_item

    @property
    def evaluate_embed_noise_dict(self):
        return self._evaluate_embed_noise_dict

    @property
    def is_inductive(self):
        return self._is_inductive

    @property
    def all_graph(self):
        return self._all_graph

    @property
    def test_graph(self):
        return self._test_graph

    @property
    def val_graph(self):
        return self._val_graph

    @property
    def train_graph(self):
        return self._train_graph

    @property
    def train_node_pairs(self):
        return self._train_node_pairs

    @property
    def train_ratings(self):
        return self._train_ratings

    @property
    def embed_P_mask(self):
        return self._embed_P_mask

    @property
    def recon_train_candidates(self):
        return self._recon_train_candidates

    @property
    def valid_node_pairs(self):
        return self._valid_node_pairs

    @property
    def valid_ratings(self):
        return self._valid_ratings

    @property
    def test_node_pairs(self):
        return self._test_node_pairs

    @property
    def test_ratings(self):
        return self._test_ratings

    # ------------------------------ samplers --------------------------------

    def rating_sampler(self, batch_size, segment="train", sequential=None):
        """Yield ``(node_pairs (2, B), ratings (B,))`` batches: sequential
        slices for ``'valid'`` and ``'test'``, and for ``'train'`` an
        endless stream of slices of one permutation per epoch (no pair
        twice within a batch)."""
        if segment == "train":
            sequential = False if sequential is None else sequential
            pairs, ratings = self._train_node_pairs, self._train_ratings
        elif segment == "valid":
            sequential = True if sequential is None else sequential
            pairs, ratings = self._valid_node_pairs, self._valid_ratings
        elif segment == "test":
            sequential = True if sequential is None else sequential
            pairs, ratings = self._test_node_pairs, self._test_ratings
        else:
            raise NotImplementedError(segment)
        n = pairs.shape[1]
        batch_size = n if batch_size < 0 else min(batch_size, n)
        if sequential:
            for start in range(0, n, batch_size):
                end = min(start + batch_size, n)
                yield pairs[:, start:end], ratings[start:end]
        else:
            while True:
                if batch_size == n:
                    yield pairs, ratings
                    continue
                order = self._rng.permutation(n)
                for start in range(0, n - batch_size + 1, batch_size):
                    sel = order[start:start + batch_size]
                    yield pairs[:, sel], ratings[sel]

    def recon_nodes_sampler(self, batch_size, segment="train",
                            sequential=False):
        """Yield ``(embed_noise_dict, batch_recon_ids_dict, all_recon_ids)``.

        Per epoch, ``P_mask`` of each type's train nodes become
        reconstruction targets, each target's mask type is drawn from
        ``(p_zero, p_self)``, and the full-size noise arrays are rebuilt;
        nodes absent from the train graph are always -1.
        """
        if segment != "train" or sequential:
            raise NotImplementedError(
                "recon_nodes_sampler draws random train batches only")
        while True:
            embed_noise_dict, recon_ids_dict = {}, {}
            for key, node_ids in self._recon_train_candidates.items():
                n_recon = int(np.ceil(self._embed_P_mask[key]
                                      * node_ids.size))
                perm = self._rng.permutation(node_ids)
                recon_ids, remain_ids = perm[:n_recon], perm[n_recon:]
                noise = -np.ones(self._all_graph.node_ids[key].shape,
                                 np.int32)
                noise[remain_ids] = remain_ids
                if recon_ids.size > 0:
                    recon_ids_dict[key] = recon_ids
                    mask_type = self._rng.multinomial(
                        1, [self._embed_p_zero[key],
                            self._embed_p_self[key]],
                        size=recon_ids.size)
                    noise[recon_ids] = (
                        mask_type * np.stack(
                            [-np.ones(recon_ids.shape), recon_ids], axis=1)
                    ).sum(axis=1).astype(np.int32)
                embed_noise_dict[key] = noise

            curr = {key: 0 for key in recon_ids_dict}
            while True:
                batch_ids = {}
                for key, ids in recon_ids_dict.items():
                    if curr[key] >= ids.size:
                        # exhausted: slicing past the end would yield a
                        # spurious empty batch
                        continue
                    batch_ids[key] = ids[curr[key]:curr[key] + batch_size]
                    curr[key] += batch_size
                if not batch_ids:
                    break
                if len(batch_ids) != len(recon_ids_dict):
                    break
                yield embed_noise_dict, batch_ids, recon_ids_dict

    def __repr__(self):
        return ("DataIterator(\nAll=" + repr(self._all_graph)
                + "\nTrain=" + repr(self._train_graph) + "\n)")
