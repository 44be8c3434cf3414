"""Heterogeneous graph: CSRMat blocks keyed by node-type pairs.

The port's copy of ``stargcn_tpu/graph/hetero.py``, cut to what the
transductive split and the serving export read.  The reverse direction of
every block is materialised as its transpose.
"""

from __future__ import annotations

import numpy as np


class HeterGraph:
    """A typed multigraph over ``CSRMat`` blocks.

    Args:
      features: ``{node_type: (num_nodes, feat_dim) float array}``.
      csr_mat_dict: ``{(src_type, dst_type): CSRMat}`` — one direction per
        pair; the reverse direction is the transpose.
      node_ids: optional ``{node_type: ids}``; defaults to
        ``arange(num_nodes)`` per type.
    """

    def __init__(self, features, csr_mat_dict, node_ids=None):
        self.features = dict(features)
        self._csr_matrices = {}
        self.meta_graph = {key: [] for key in self.features}
        for (src, dst), mat in csr_mat_dict.items():
            assert src in self.features and dst in self.features, (src, dst)
            self._csr_matrices[(src, dst)] = mat
            self._csr_matrices[(dst, src)] = mat.T
            if dst not in self.meta_graph[src]:
                self.meta_graph[src].append(dst)
            if src not in self.meta_graph[dst]:
                self.meta_graph[dst].append(src)
        if node_ids is None:
            node_ids = {
                key: np.arange(np.asarray(fea).shape[0], dtype=np.int32)
                for key, fea in self.features.items()}
        self.node_ids = {k: np.asarray(v, dtype=np.int32)
                         for k, v in node_ids.items()}

    def __getitem__(self, key):
        src, dst = key
        return self._csr_matrices[(src, dst)]

    @property
    def edge_pairs(self):
        """Canonical (src, dst) pairs (one direction per matrix)."""
        seen, out = set(), []
        for (src, dst) in self._csr_matrices:
            if (dst, src) not in seen:
                seen.add((src, dst))
                out.append((src, dst))
        return out

    def fetch_edges_by_id(self, src_key, dst_key, node_pair_ids):
        return self[src_key, dst_key].fetch_edges_by_id(node_pair_ids)

    def remove_edges_by_id(self, src_key, dst_key, node_pair_ids):
        """New graph without the given edges, sharing features."""
        new_mat = self[src_key, dst_key].remove_edges_by_id(node_pair_ids)
        csr_dict = {}
        for (s, d) in self.edge_pairs:
            csr_dict[(s, d)] = new_mat if (s, d) == (src_key, dst_key) \
                else self._csr_matrices[(s, d)]
        return HeterGraph(self.features, csr_dict, node_ids=self.node_ids)
