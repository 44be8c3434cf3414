"""Fixed-fanout block sampling for mini-batch training/inference.

The port of ``stargcn_tpu/graph/sampling.py``: the host planning phase of
sampled mode.  The sampler emits STATIC-shape padded ELL blocks (node
counts padded to a fixed multiple or to fixed caps, fanout capped at K), so
every batch gives the device step tensors of the same shapes.

Two planner routes share one pipeline and differ only in how neighbors are
drawn (``planner=``):

* ``'loop'``: ``kernels.random_sample_fix_neighbor``, one ``rng.choice``
  per frontier row, the same draws from the same seed as the JAX package's
  NumPy path;
* ``'vectorised'`` (the default): the same contract (uniform, without
  replacement, at most K per row) drawn for all rows at once.  It stands
  where the JAX package has its fused native planner (``_sample_native``);
  the port builds no host extension.  Its draws differ from the loop's; the
  two agree exactly when the fanout is at least the largest degree.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from stargcn_tpu_torch.graph import kernels as K

_PLANNERS = {"loop": K.random_sample_fix_neighbor,
             "vectorised": K.random_sample_fix_neighbor_vectorised}


def _pad_to(n, multiple):
    return max(multiple, -(-n // multiple) * multiple)


class FrontierCapError(ValueError):
    """A sampled frontier exceeded its fixed cap.

    Carries ``needed`` = {node_type: observed frontier size} so a
    training loop can grow the caps and continue (``SampledTrainer``
    does exactly that) instead of dying mid-run.
    """

    def __init__(self, node_type: str, needed: int, cap: int):
        super().__init__(
            f"frontier for {node_type!r} has {needed} nodes, cap is "
            f"{cap}; raise frontier_caps or lower the fanout/batch")
        self.needed = {node_type: needed}


@dataclasses.dataclass
class EllBlock:
    """One aggregation step: dst frontier <- src frontier.

    ``nbr_pos[i, k]`` indexes the SRC frontier array; ``weight`` carries
    support x validity (0 on padded slots); ``rating`` the per-slot
    rating-level index.
    """

    nbr_pos: np.ndarray      # (num_dst_pad, K) int32
    weight: np.ndarray       # (num_dst_pad, K) f32
    rating: np.ndarray       # (num_dst_pad, K) int32
    num_dst_real: int


@dataclasses.dataclass
class SampledBlocks:
    """L-layer bipartite computation plan with fixed shapes.

    ``frontiers[l]`` = {'user': ids, 'item': ids} (padded with -1) for
    level l; level 0 is the input level.  ``blocks[l][t]`` aggregates
    INTO type t's level-(l+1) frontier FROM the other type's level-l
    frontier.
    """

    frontiers: List[dict]
    blocks: List[dict]
    target_pos: dict         # positions of the original targets in the
                             # top frontier


class BlockSampler:
    """Samples fixed-shape L-layer blocks from a ``HeterGraph``.

    The graph's row and column id sets may be subsets of the node ids (an
    inductive train or valid graph): neighborhoods are planned in its own
    index space and named by global id, and a target that is not a node of
    the graph raises ``ValueError``.  ``frontier_caps`` (optional ``{'user': n, 'item': n}``) pads EVERY
    frontier to exactly those sizes, so repeated sampling produces
    identical shapes (raises ``FrontierCapError`` if a frontier exceeds
    its cap).
    """

    def __init__(self, graph, num_layers: int, fanout: int = -1,
                 symm: bool = True, node_pad: int = 128,
                 name_user: str = "user", name_item: str = "movie",
                 frontier_caps: dict | None = None,
                 planner: str = "vectorised"):
        if planner not in _PLANNERS:
            raise ValueError(f"unknown planner: {planner!r}")
        self.planner = planner
        self.frontier_caps = frontier_caps
        self.graph = graph
        self.num_layers = num_layers
        self.fanout = fanout
        self.symm = symm
        self.node_pad = node_pad
        self.nu, self.ni = name_user, name_item
        self._csr = {
            "user": graph[name_user, name_item],   # rows = users
            "item": graph[name_item, name_user],   # rows = items
        }
        self._support = {
            t: self._csr[t].get_support(symm) for t in ("user", "item")}
        self._rating_idx = {
            t: np.searchsorted(self._csr[t].multi_link,
                               self._csr[t].values).astype(np.int32)
            for t in ("user", "item")}
        self._row_deg = {t: np.asarray(self._csr[t].row_degrees, np.int64)
                         for t in ("user", "item")}
        self._col_deg = {t: np.asarray(self._csr[t].col_degrees, np.int64)
                         for t in ("user", "item")}
        self._num_items_global = self._csr["user"].shape[1]

    def removal_args(self, batch_user_ids, batch_item_ids):
        """Precompute ``(exclude_keys, removal_counts)`` for
        REMOVE_RATING semantics: the batch pairs' edges are dropped from
        every sampled neighborhood AND the degree normalisation is
        recomputed as if those edges were removed, as
        ``remove_edges_by_id`` + ``get_support`` on the reduced graph
        would give it.  Every batch id must be a node of the graph."""
        bu = self._csr["user"].rows_of(batch_user_ids)
        bi = self._csr["item"].rows_of(batch_item_ids)
        keys = np.sort(bu.astype(np.int64) * self._num_items_global + bi)
        rem = {"user": np.bincount(bu, minlength=self._row_deg["user"].size)
               .astype(np.int64),
               "item": np.bincount(bi, minlength=self._row_deg["item"].size)
               .astype(np.int64)}
        return keys, rem

    def sample(self, target_user_ids, target_item_ids,
               exclude_keys=None, removal_counts=None) -> SampledBlocks:
        """Top-down frontier construction, bottom-up ELL blocks.

        ``exclude_keys``/``removal_counts`` (from ``removal_args``)
        implement per-batch edge removal: excluded edges get zero
        support, and supports are recomputed from the removal-adjusted
        degrees."""
        frontier = {"user": np.asarray(target_user_ids, np.int32),
                    "item": np.asarray(target_item_ids, np.int32)}
        draw = _PLANNERS[self.planner]
        levels = [frontier]
        raw_blocks = []
        for _ in range(self.num_layers):
            prev = {}
            blocks = {}
            for t, other in (("user", "item"), ("item", "user")):
                csr = self._csr[t]
                # Every frontier id must be a node of this graph: on an
                # inductive train graph, a held-out node has no row.
                sel = csr.rows_of(levels[-1][t])
                # sample K neighbors per frontier node; the merged array
                # is the other type's next frontier contribution
                sampled_idx, ptr = draw(
                    csr.ind_ptr, sel.astype(np.int32), self.fanout)
                nbr_inds = csr.end_points[sampled_idx]
                nbr_ids = csr.col_ids[nbr_inds]
                if removal_counts is None:
                    sup = self._support[t][sampled_idx]
                else:
                    # support from the removal-adjusted degrees, as
                    # ``get_support`` on the edge-removed graph gives it
                    rows = np.repeat(sel, np.diff(ptr))
                    dr = (self._row_deg[t][rows]
                          - removal_counts[t][rows]).astype(np.float64)
                    if self.symm:
                        dc = (self._col_deg[t][nbr_inds]
                              - removal_counts[other][nbr_inds]
                              ).astype(np.float64)
                        denom = dr * dc
                        sup = np.where(denom > 0,
                                       1.0 / np.sqrt(np.maximum(denom, 1)),
                                       0.0).astype(np.float32)
                    else:
                        sup = np.where(dr > 0,
                                       1.0 / np.maximum(dr, 1),
                                       0.0).astype(np.float32)
                if exclude_keys is not None and exclude_keys.size:
                    rows = np.repeat(sel, np.diff(ptr))
                    ni_g = self._num_items_global
                    if t == "user":
                        keys = rows.astype(np.int64) * ni_g + nbr_inds
                    else:
                        keys = nbr_inds.astype(np.int64) * ni_g + rows
                    pos = np.searchsorted(exclude_keys, keys)
                    pos = np.clip(pos, 0, exclude_keys.size - 1)
                    sup = np.where(exclude_keys[pos] == keys, 0.0, sup)
                rat = self._rating_idx[t][sampled_idx]
                blocks[t] = (nbr_ids, ptr, sup, rat)
                prev[other] = nbr_ids
            # prev-level frontier per type = its own frontier (self rows
            # feed the NEXT layer's aggregation of the other type) plus
            # sampled neighbor ids
            new_frontier = {}
            for t in ("user", "item"):
                uniq, _ = K.unique_inverse(np.concatenate(
                    [levels[-1][t], prev.get(t, np.zeros(0, np.int32))]))
                new_frontier[t] = uniq
            levels.append(new_frontier)
            raw_blocks.append(blocks)

        # Bottom-up: levels reversed so level 0 = deepest frontier.
        levels = levels[::-1]
        raw_blocks = raw_blocks[::-1]
        frontiers_padded = self._pad_frontiers(levels)

        blocks_out = []
        for li, blocks in enumerate(raw_blocks):
            lvl_blocks = {}
            for t, other in (("user", "item"), ("item", "user")):
                nbr_ids, ptr, sup, rat = blocks[t]
                dst_ids = levels[li + 1][t]
                if self.frontier_caps is not None:
                    if self.fanout <= 0:
                        raise ValueError(
                            "fixed-shape mode needs a positive fanout")
                    n_dst = self.frontier_caps[t]
                else:
                    n_dst = _pad_to(dst_ids.size, self.node_pad)
                fan = (self.fanout if self.fanout > 0
                       else int(max(np.diff(ptr), default=1)))
                nbr_pos = np.zeros((n_dst, fan), np.int32)
                weight = np.zeros((n_dst, fan), np.float32)
                rating = np.zeros((n_dst, fan), np.int32)
                src_ids = levels[li][other]
                if nbr_ids.size:
                    # vectorised scatter into the ELL slots
                    map_arr = np.full(int(max(src_ids.max(initial=0),
                                              nbr_ids.max())) + 1, -1,
                                      np.int32)
                    map_arr[src_ids] = np.arange(src_ids.size,
                                                 dtype=np.int32)
                    deg = (ptr[1:] - ptr[:-1]).astype(np.int64)
                    rows = np.repeat(np.arange(dst_ids.size), deg)
                    cols = (np.arange(nbr_ids.size)
                            - np.repeat(ptr[:-1], deg))
                    nbr_pos[rows, cols] = map_arr[nbr_ids]
                    weight[rows, cols] = sup
                    rating[rows, cols] = rat
                lvl_blocks[t] = EllBlock(nbr_pos, weight, rating,
                                         num_dst_real=dst_ids.size)
            blocks_out.append(lvl_blocks)

        tpos = self._target_positions(levels[-1], target_user_ids,
                                      target_item_ids)
        return SampledBlocks(frontiers=frontiers_padded, blocks=blocks_out,
                             target_pos=tpos)

    # ------------------- shared finalisation helpers -------------------

    def _pad_frontiers(self, levels):
        """Pad each level's id arrays with -1 to the frontier caps (or
        the next ``node_pad`` multiple); raises when a cap is exceeded."""
        frontiers_padded = []
        for lvl in levels:
            padded = {}
            for t in ("user", "item"):
                ids = lvl[t]
                if self.frontier_caps is not None:
                    pad = self.frontier_caps[t]
                    if ids.size > pad:
                        raise FrontierCapError(t, ids.size, pad)
                else:
                    pad = _pad_to(ids.size, self.node_pad)
                arr = np.full(pad, -1, np.int32)
                arr[:ids.size] = ids
                padded[t] = arr
            frontiers_padded.append(padded)
        return frontiers_padded

    def _target_positions(self, top, target_user_ids, target_item_ids):
        """Positions of the targets in the TOP frontier — vectorised
        (the targets ARE the top frontier's leading ids by
        construction)."""
        def _positions(ids_arr, query):
            size = int(max(ids_arr.max(initial=0),
                           query.max(initial=0))) + 1
            pos = np.full(size, -1, np.int32)
            pos[ids_arr] = np.arange(ids_arr.size, dtype=np.int32)
            return pos[query]

        return {
            "user": _positions(top["user"],
                               np.asarray(target_user_ids, np.int32)),
            "item": _positions(top["item"],
                               np.asarray(target_item_ids, np.int32)),
        }
