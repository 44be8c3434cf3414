"""Device-side graph representation: flat, static-shape edge arrays.

The port's copy of ``stargcn_tpu/graph/device.py``.  The whole bipartite
rating graph lives on the device as padded flat edge arrays; every graph
variant (train/valid/test) is a float mask over them.  Per-batch edge
removal either looks its pairs up on the host (``train.loop.Trainer``, for
the ``bitdense`` and ``dense`` backends) or on the device through the
sorted pair keys (``edge_mask_from_pairs``, for ``xla``).
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
      lookup_keys / lookup_perm: ``(E_pad,)`` int32 sorted
        ``user * num_items + item`` keys of the real edges (padded slots
        hold a sentinel above every key) and the permutation back to edge
        positions: the pair -> edge lookup of per-batch edge removal.
      has_pair_lookup: False where the key space exceeds int32, as in the
        JAX package; the lookup arrays are then one dummy entry.
    """

    edge_user: torch.Tensor
    edge_item: torch.Tensor
    edge_rating: torch.Tensor
    edge_pad_mask: torch.Tensor
    lookup_keys: torch.Tensor
    lookup_perm: torch.Tensor
    num_users: int
    num_items: int
    num_links: int
    has_pair_lookup: bool = True

    @property
    def num_edges_padded(self) -> int:
        return self.edge_user.shape[0]

    @staticmethod
    def from_arrays(users, items, ratings_idx, num_users, num_items,
                    num_links, device, pad_multiple: int = 256):
        """Build from COO arrays (index space, rating already
        level-indexed)."""
        users = np.asarray(users, dtype=np.int32)
        items = np.asarray(items, dtype=np.int32)
        E = users.size
        E_pad = max(_pad_to(E, pad_multiple), pad_multiple)

        def padded(a, dtype, fill=0):
            out = np.full(E_pad, fill, dtype)
            out[:E] = a
            return torch.from_numpy(out).to(device)

        # Pair keys in int32, as the JAX package keeps them; beyond that
        # key space the device lookup is off (host lookups use int64).
        has_lookup = (num_users + 1) * num_items + 1 < 2**31
        if has_lookup:
            keys = users * np.int32(num_items) + items
            order = np.argsort(keys, kind="stable")
            sentinel = num_users * num_items + 1
            lookup_keys = padded(keys[order], np.int32, sentinel)
            lookup_perm = padded(order.astype(np.int32), np.int32)
        else:
            lookup_keys = torch.zeros(1, dtype=torch.int32, device=device)
            lookup_perm = torch.zeros(1, dtype=torch.int32, device=device)

        return BipartiteGraphData(
            edge_user=padded(users, np.int32),
            edge_item=padded(items, np.int32),
            edge_rating=padded(ratings_idx, np.int32),
            edge_pad_mask=padded(np.ones(E, np.float32), np.float32),
            lookup_keys=lookup_keys, lookup_perm=lookup_perm,
            num_users=int(num_users), num_items=int(num_items),
            num_links=int(num_links), has_pair_lookup=bool(has_lookup))

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

    def lookup_pairs(self, pairs_user, pairs_item):
        """``(pos, found)`` of (user, item) pairs in the sorted pair keys:
        the key position of each pair and whether that key is the pair's
        (so ``lookup_perm[pos]`` is its edge where ``found``)."""
        if not self.has_pair_lookup:
            raise ValueError(
                "pair-key space exceeds int32: the device pair lookup is "
                "unavailable at this scale; pass the host-computed (pu, "
                "pi, hit, rating) removal instead")
        q = (pairs_user.long() * self.num_items
             + pairs_item.long()).to(torch.int32)
        pos = torch.searchsorted(self.lookup_keys, q).clamp_(
            0, self.lookup_keys.shape[0] - 1)
        return pos, self.lookup_keys[pos] == q

    def edge_mask_from_pairs(self, pairs_user, pairs_item, pairs_valid,
                             base_mask, offset: int = 0):
        """``base_mask`` with the edges named by the valid (user, item)
        pairs set to 0: a binary search over the sorted pair keys and one
        ``amin`` scatter.  A miss writes the current value of whatever
        edge its search lands on, so misses, and pairs that repeat, leave
        every other edge as it was.

        ``base_mask`` may be one slice of the padded edges, those from
        ``offset`` on (a rank's edge shard on a device mesh, the lookup
        arrays whole): pairs whose edges lie outside it change nothing."""
        pos, found = self.lookup_pairs(pairs_user, pairs_item)
        hit = found & (pairs_valid > 0)
        edge_idx = self.lookup_perm[pos].long() - offset
        inside = (edge_idx >= 0) & (edge_idx < base_mask.shape[0])
        hit = hit & inside
        edge_idx = torch.where(inside, edge_idx, torch.zeros_like(edge_idx))
        current = base_mask.index_select(0, edge_idx)
        return base_mask.scatter_reduce(
            0, edge_idx, torch.where(hit, torch.zeros_like(current),
                                     current), reduce="amin")

    def mask_from_edge_indices(self, edge_indices_np):
        """Float mask on the graph's device selecting only the given edge
        positions."""
        mask = np.zeros(self.num_edges_padded, np.float32)
        mask[np.asarray(edge_indices_np, dtype=np.int64)] = 1.0
        return torch.from_numpy(mask).to(self.edge_user.device)


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """One step's graph as edge arrays and a mask: the operands of the
    ``xla`` backend, and of ``dense`` when no adjacency was built.
    ``mask`` is ``(E_pad,)`` float, 1 for the edges of the step's graph
    (the variant's mask, with any per-batch removal already applied); the
    forward multiplies in the pad mask itself.

    On a device mesh ``graph`` holds one rank's slice of the edges and
    ``mask`` its slice of the mask, and ``shard`` is the
    ``parallel.shardings.ShardedGraph`` that places them (the 'model'
    group, the slice's offset, the padded edge count): the forward sums
    the rank's edges and adds the ranks' sums over the group."""

    graph: BipartiteGraphData
    mask: torch.Tensor
    shard: object = None
