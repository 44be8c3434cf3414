"""Heterogeneous graph: CSRMat blocks keyed by node-type pairs.

The port's copy of ``stargcn_tpu/graph/hetero.py``: the transductive and
inductive splits (edge removal, node subgraphs), the serving export, and
saving and loading in the JAX package's directory layout.  The reverse
direction of every block is materialised as its transpose.
"""

from __future__ import annotations

import json
import os

import numpy as np

from stargcn_tpu_torch.graph.csr import CSRMat, NodeIDRMap


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
        self._node_id_rmaps = None

    def __getitem__(self, key):
        src, dst = key
        return self._csr_matrices[(src, dst)]

    def __contains__(self, key):
        return tuple(key) in self._csr_matrices

    @property
    def node_names(self):
        """Node-type names."""
        return self.features.keys()

    @property
    def node_id_rmaps(self):
        """Per-type global-id -> index maps, built on first use."""
        if self._node_id_rmaps is None:
            self._node_id_rmaps = {k: NodeIDRMap(v)
                                   for k, v in self.node_ids.items()}
        return self._node_id_rmaps

    def node_id_to_ind(self, key, node_ids):
        """Map a type's global ids to row indices."""
        return self.node_id_rmaps[key][np.asarray(node_ids, np.int32)]

    def features_by_id(self, key, node_ids):
        """Feature rows of ``key`` selected by global id."""
        return np.asarray(self.features[key])[self.node_id_to_ind(key,
                                                                  node_ids)]

    def device_features(self, device):
        """Per-type features as float32 tensors on ``device``: one copy
        per type, reused across steps."""
        import torch

        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                .to(device) for k, v in self.features.items()}

    @property
    def edge_pairs(self):
        """Canonical (src, dst) pairs (one direction per matrix)."""
        seen, out = set(), []
        for (src, dst) in self._csr_matrices:
            if (dst, src) not in seen:
                seen.add((src, dst))
                out.append((src, dst))
        return out

    def get_multi_link_structure(self):
        """{(src, dst): number of rating levels, or None} per direction."""
        return {(src, dst): (None if mat.multi_link is None
                             else len(mat.multi_link))
                for (src, dst), mat in self._csr_matrices.items()}

    def check_continous_node_ids(self):
        """Node ids must be 0..N-1 per type: the model uses them directly
        as embedding rows.  Raises ``ValueError`` otherwise."""
        for key, ids in self.node_ids.items():
            expected = np.arange(np.asarray(self.features[key]).shape[0],
                                 dtype=np.int32)
            if ids.size != expected.size or not np.array_equal(
                    np.sort(ids), expected):
                raise ValueError(f"node ids for {key!r} are not contiguous")

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

    def sel_subgraph_by_id(self, key, node_ids):
        """Subgraph keeping only the given nodes of type ``key``, in the
        order given (inductive splits).  Other types keep all their nodes;
        features are shared."""
        node_ids = np.asarray(node_ids, dtype=np.int32)
        csr_dict = {}
        for (s, d) in self.edge_pairs:
            mat = self._csr_matrices[(s, d)]
            if s == key:
                csr_dict[(s, d)] = mat.submat_by_id(row_ids=node_ids)
            elif d == key:
                csr_dict[(s, d)] = mat.submat_by_id(col_ids=node_ids)
            else:
                csr_dict[(s, d)] = mat
        new_node_ids = dict(self.node_ids)
        new_node_ids[key] = node_ids
        return HeterGraph(self.features, csr_dict, node_ids=new_node_ids)

    # ------------------------------ persistence ------------------------------

    def save(self, dirname):
        """A directory of ``.npz`` files and ``meta_graph.json``, in the
        JAX package's layout."""
        os.makedirs(dirname, exist_ok=True)
        meta = {"node_types": list(self.features.keys()),
                "edges": [list(p) for p in self.edge_pairs]}
        with open(os.path.join(dirname, "meta_graph.json"), "w") as f:
            json.dump(meta, f)
        for key, fea in self.features.items():
            np.savez_compressed(os.path.join(dirname, f"fea_{key}.npz"),
                                features=np.asarray(fea),
                                node_ids=self.node_ids[key])
        for (s, d) in self.edge_pairs:
            self._csr_matrices[(s, d)].save(
                os.path.join(dirname, f"csr_{s}__{d}.npz"))

    @staticmethod
    def load(dirname):
        with open(os.path.join(dirname, "meta_graph.json")) as f:
            meta = json.load(f)
        features, node_ids = {}, {}
        for key in meta["node_types"]:
            d = np.load(os.path.join(dirname, f"fea_{key}.npz"))
            features[key] = d["features"]
            node_ids[key] = d["node_ids"]
        csr_dict = {}
        for s, d in meta["edges"]:
            csr_dict[(s, d)] = CSRMat.load(
                os.path.join(dirname, f"csr_{s}__{d}.npz"))
        return HeterGraph(features, csr_dict, node_ids=node_ids)

    def check_consistency(self):
        """Each direction holds the same edges and values as its
        transpose (raises ``AssertionError``)."""
        for (s, d) in self.edge_pairs:
            fwd, bwd = self._csr_matrices[(s, d)], self._csr_matrices[(d, s)]
            assert fwd.nnz == bwd.nnz
            a = fwd.node_pair_ids
            b = bwd.node_pair_ids[::-1]
            ka = np.lexsort(a)
            kb = np.lexsort(b)
            assert np.array_equal(a[:, ka], b[:, kb])
            assert np.allclose(fwd.values[ka], bwd.values[kb])

    def __repr__(self):
        lines = ["HeterGraph("]
        for key, fea in self.features.items():
            lines.append(
                f"  {key}: {self.node_ids[key].size} nodes, "
                f"feat {np.asarray(fea).shape}")
        for (s, d) in self.edge_pairs:
            lines.append(f"  ({s} -> {d}): {self._csr_matrices[(s, d)]}")
        return "\n".join(lines) + "\n)"
