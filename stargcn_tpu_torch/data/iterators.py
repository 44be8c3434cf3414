"""Graph-variant bookkeeping for evaluation and serving.

The port's copy of ``DataIterator`` from ``stargcn_tpu/data/iterators.py``,
cut to the transductive graph hierarchy and the properties the serving
export reads:

* ``test_graph = all - test edges``; ``val_graph = train_graph =
  test_graph - valid edges``;
* ``evaluate_embed_noise_dict``: at evaluation, nodes unseen in the train
  graph are masked to zero (-1), every other node keeps its own id.

The rating and reconstruction samplers come with the training slice; the
inductive split with the slice that ports ``data/movielens.py``.
"""

from __future__ import annotations

import numpy as np


class DataIterator:
    """Transductive graph hierarchy over one user-item rating graph.

    ``embed_P_mask``, ``embed_p_zero``, ``embed_p_self`` and ``seed``
    configure the training samplers; they are checked and kept so that a
    caller written for the JAX package constructs this class unchanged.
    """

    def __init__(self, all_graph, name_user, name_item, is_inductive=False,
                 test_node_pairs=None, valid_node_pairs=None,
                 embed_P_mask=0.1, embed_p_zero=1.0, embed_p_self=0.0,
                 seed=100):
        if is_inductive:
            raise NotImplementedError(
                "the inductive split comes with the port of "
                "data/movielens.py; this slice serves transductive graphs")
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

        self.seed = seed
        self.embed_P_mask = as_dict(embed_P_mask)
        p_zero, p_self = as_dict(embed_p_zero), as_dict(embed_p_self)
        for key in self.embed_P_mask:
            if abs(p_zero[key] + p_self[key] - 1.0) >= 1e-9:
                raise ValueError(
                    f"embed_p_zero + embed_p_self must be 1 for {key!r}")

        self._evaluate_embed_noise_dict = {}
        for key in self._train_graph.meta_graph:
            train_ids = self._train_graph.node_ids[key]
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
