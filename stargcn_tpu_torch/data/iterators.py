"""Training/evaluation samplers and graph-variant bookkeeping.

The port's copy of ``DataIterator`` from ``stargcn_tpu/data/iterators.py``,
on the transductive graph hierarchy:

* ``test_graph = all - test edges``; ``val_graph = train_graph =
  test_graph - valid edges``;
* ``rating_sampler``: infinite epoch-shuffled batches for training,
  sequential batches for evaluation;
* ``recon_nodes_sampler``: per epoch a ``P_mask`` fraction of each node
  type becomes reconstruction targets, each masked to zero (-1) or kept
  (its own id) by ``(p_zero, p_self)``, in a full-size ``embed_noise``
  array;
* ``evaluate_embed_noise_dict``: at evaluation, nodes unseen in the train
  graph are masked to zero (-1), every other node keeps its own id.

One ``np.random.RandomState(seed)`` is consumed in the JAX class's order,
so the same seed gives the same batches, noise arrays and recon ids in both
packages.  The inductive split comes with the slice that ports
``data/movielens.py``.
"""

from __future__ import annotations

import numpy as np


class DataIterator:
    """Transductive graph hierarchy over one user-item rating graph, with
    the rating and reconstruction samplers."""

    def __init__(self, all_graph, name_user, name_item, is_inductive=False,
                 test_node_pairs=None, valid_node_pairs=None,
                 embed_P_mask=0.1, embed_p_zero=1.0, embed_p_self=0.0,
                 seed=100):
        if is_inductive:
            raise NotImplementedError(
                "the inductive split comes with the port of "
                "data/movielens.py; the port runs transductive graphs")
        self._rng = np.random.RandomState(seed=seed)
        self._all_graph = all_graph
        self._name_user = name_user
        self._name_item = name_item

        self._test_graph = all_graph.remove_edges_by_id(
            name_user, name_item, test_node_pairs)
        self._val_graph = self._test_graph.remove_edges_by_id(
            name_user, name_item, valid_node_pairs)
        self._train_graph = self._val_graph

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
        return False

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
