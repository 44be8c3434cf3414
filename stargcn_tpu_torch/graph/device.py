"""Device-side graph representation: flat, static-shape edge arrays.

The port's copy of ``stargcn_tpu/graph/device.py``.  The whole bipartite
rating graph lives on the device as padded flat edge arrays; every graph
variant (train/valid/test) is a float mask over them.  The pair-lookup
fields that per-batch edge removal reads come with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class BipartiteGraphData:
    """Edge arrays of a user-item multi-relational graph on one device.

    Padded slots have ``edge_pad_mask == 0`` and point at node 0 /
    rating 0.

    Fields:
      edge_user / edge_item: ``(E_pad,)`` int32 endpoint indices.
      edge_rating: ``(E_pad,)`` int32 rating-level index in
        ``[0, num_links)``.
      edge_pad_mask: ``(E_pad,)`` float32, 1 for real edges.
    """

    edge_user: torch.Tensor
    edge_item: torch.Tensor
    edge_rating: torch.Tensor
    edge_pad_mask: torch.Tensor
    num_users: int
    num_items: int
    num_links: int

    @property
    def num_edges_padded(self) -> int:
        return self.edge_user.shape[0]

    @staticmethod
    def from_arrays(users, items, ratings_idx, num_users, num_items,
                    num_links, device, pad_multiple: int = 256):
        """Build from COO arrays (index space, rating already
        level-indexed)."""
        users = np.asarray(users, dtype=np.int32)
        E = users.size
        E_pad = max(_pad_to(E, pad_multiple), pad_multiple)

        def padded(a, dtype, fill=0):
            out = np.full(E_pad, fill, dtype)
            out[:E] = a
            return torch.from_numpy(out).to(device)

        return BipartiteGraphData(
            edge_user=padded(users, np.int32),
            edge_item=padded(items, np.int32),
            edge_rating=padded(ratings_idx, np.int32),
            edge_pad_mask=padded(np.ones(E, np.float32), np.float32),
            num_users=int(num_users), num_items=int(num_items),
            num_links=int(num_links))

    @staticmethod
    def from_csr(csr, device, pad_multiple: int = 256):
        """Build from a host ``CSRMat`` (rows = users, cols = items);
        rating levels index ``csr.multi_link``."""
        assert csr.multi_link is not None
        rating_idx = np.searchsorted(csr.multi_link, csr.values).astype(
            np.int32)
        return BipartiteGraphData.from_arrays(
            csr.row_indices, csr.end_points, rating_idx,
            num_users=csr.shape[0], num_items=csr.shape[1],
            num_links=len(csr.multi_link), device=device,
            pad_multiple=pad_multiple)
