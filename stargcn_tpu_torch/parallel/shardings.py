"""Sharding layouts of the full-graph STAR-GCN step on a device mesh.

The port of ``stargcn_tpu/parallel/shardings.py``, with its layout:

* edge arrays and edge masks: split over 'model' in contiguous slices of
  the padded arrays; a rank sums its own edges into partial per-node
  segment sums, which are added over 'model' (``collectives.leave``);
  degrees come from the whole masks;
* bit packs (``KERNEL.BACKEND: bitdense``): packed rows split over
  'model'; a rank launches ``bit_expand_matmul`` on its rows of the
  forward pack, whose outputs are gathered over 'model', and
  ``bit_reduce_matmul`` on its rows of the transpose pack, whose partial
  sums are added over 'model' (``ops.bitdense.bit_pool_rated``).  Each
  layout is placed on its own: one whose rows do not split into equal
  slices (of whole 128-row blocks for the 16-bit route's row-interleaved
  packs) stays replicated, as in the JAX package, while the other layout
  of its direction may be split;
* embedding tables: rows split over 'model' where they divide, gathered
  whole for the forward (``collectives.gather_rows``);
* rating batches: split over 'data'; gradients are summed over 'data';
* everything else: replicated.

Where GSPMD left a choice to XLA, the port makes it here: the ``dense``
backend's 0/1 adjacency (at most 150M entries, 0.3 GB in bf16) and the
``ell`` backend's packs (not sharded in the JAX package either) stay
replicated over 'model', so on those backends the mesh is data-parallel
with row-sharded embeddings.

A placement is this rank's slice plus what puts the whole back together
(``Shard``): the axis, its process group, the global shape and the
offset of the slice.  Every rank computes the same whole arrays (the same
seeds) and keeps its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from stargcn_tpu_torch.parallel.collectives import all_gather_rows
from stargcn_tpu_torch.parallel.mesh import Mesh

# The 16-bit route's packs permute rows inside blocks of this many
# (ops/bitdense.py:_BM); a shard of them holds whole blocks.
_ROW_BLOCK = 128


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """This rank's rows of an array split along dim 0 over a mesh axis
    (``axis`` None: replicated, ``local`` is the whole)."""

    local: torch.Tensor
    axis: Optional[str]
    group: object
    global_shape: tuple
    offset: int

    @property
    def sharded(self) -> bool:
        return self.axis is not None

    def whole(self, t=None) -> torch.Tensor:
        """The whole array (a collective over the axis where sharded); with
        ``t``, the whole of a tensor split as this one is (a gradient or a
        moment of a row-split parameter)."""
        t = self.local if t is None else t
        if not self.sharded:
            return t
        return all_gather_rows(t, self.group)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGraph:
    """A ``BipartiteGraphData`` with its edge arrays cut to this rank's
    slice ``[offset, offset + graph.num_edges_padded)`` of the
    ``num_edges`` padded edges, and its pair-lookup arrays whole."""

    graph: object
    group: object
    offset: int
    num_edges: int


def split_range(n: int, parts: int, index: int):
    """``(lo, hi)``: slice ``index`` of ``n`` rows cut in ``parts`` equal
    slices."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal slices")
    step = n // parts
    return index * step, (index + 1) * step


def padded_split(n: int, parts: int, index: int):
    """``(lo, hi, rows)``: slice ``index`` of ``n`` rows cut in ``parts``
    slices of ``rows = ceil(n / parts)`` each, the last ones short (or
    empty) where ``parts`` does not divide ``n``; a caller pads its slice
    to ``rows`` so that every rank holds the same count (an all-gather
    needs equal shapes) and drops the padding after the gather."""
    rows = -(-n // parts)
    lo = min(index * rows, n)
    return lo, min(lo + rows, n), rows


@dataclasses.dataclass
class GraphShardings:
    """Placements over a ('data', 'model') ``Mesh``: the axis each layout
    splits dim 0 over (``edges``, ``batch``, ``replicated``,
    ``embed_rows``, ``bit_rows``) and the ``place_*`` functions."""

    mesh: Mesh

    @property
    def edges(self):
        return "model"

    @property
    def batch(self):
        return "data"

    @property
    def replicated(self):
        return None

    @property
    def embed_rows(self):
        return "model"

    @property
    def bit_rows(self):
        """Bit-packed adjacency rows over 'model': the forward's packed
        rows are independent (each rank produces its destination rows) and
        the backward's partial sums over its rows are added over 'model'
        (the dense instance of the edge-set sharding)."""
        return "model"

    def place(self, x: torch.Tensor, axis: Optional[str],
              device=None) -> Shard:
        """``x``'s slice along dim 0 for this rank over ``axis`` (None:
        the whole), on ``device`` (default: where it is)."""
        x = torch.as_tensor(x)
        device = x.device if device is None else device
        if axis is None:
            return Shard(x.to(device), None, None, tuple(x.shape), 0)
        lo, hi = split_range(x.shape[0], self.mesh.size(axis),
                             self.mesh.index(axis))
        return Shard(x[lo:hi].contiguous().to(device), axis,
                     self.mesh.group(axis), tuple(x.shape), lo)

    def place_bit_pack(self, pack, device=None):
        """Shard every layout of a ``build_bit_pack`` dict by packed rows
        over 'model' (``Shard`` values); a layout whose rows do not split
        into equal slices, of whole 128-row blocks on a row-interleaved
        pack, stays replicated.  A tensor that two entries share is placed
        once."""
        model = self.mesh.size("model")
        ril = pack.get("row_interleave", 0)
        placed = {}

        def one(a):
            if id(a) not in placed:
                rows = a.shape[0]
                ok = rows % model == 0 and (
                    not ril or (rows // model) % _ROW_BLOCK == 0)
                placed[id(a)] = self.place(
                    a, self.bit_rows if ok else self.replicated, device)
            return placed[id(a)]

        return {**{t: {k: one(v) for k, v in d.items()}
                   for t, d in pack.items() if isinstance(d, dict)},
                "row_interleave": ril}

    def place_graph(self, graph, device=None) -> ShardedGraph:
        """Split a ``BipartiteGraphData``'s edge arrays over 'model' (the
        pair-lookup arrays stay whole: the lookup stays local)."""
        parts = {k: self.place(getattr(graph, k), self.edges, device)
                 for k in ("edge_user", "edge_item", "edge_rating",
                           "edge_pad_mask")}
        local = dataclasses.replace(
            graph, **{k: s.local for k, s in parts.items()},
            lookup_keys=graph.lookup_keys.to(device or graph.lookup_keys
                                             .device),
            lookup_perm=graph.lookup_perm.to(device or graph.lookup_perm
                                             .device))
        first = parts["edge_user"]
        return ShardedGraph(local, first.group, first.offset,
                            graph.num_edges_padded)

    def place_params(self, model):
        """Row-split the model's embedding tables over 'model' where their
        rows divide, in place: each keeps this rank's rows as its
        parameter, and ``model.row_shards`` maps the parameter's name to
        its ``Shard`` (whose ``local`` is the parameter), so the forward
        gathers the whole table.  Everything else stays replicated.
        Returns ``model.row_shards``."""
        shards = {}
        for name in ("embed_user", "embed_item"):
            mod = getattr(model, name, None)
            if mod is None:
                continue
            w = mod.weight
            if w.shape[0] % self.mesh.size(self.embed_rows):
                continue
            s = self.place(w.detach(), self.embed_rows)
            mod.weight = torch.nn.Parameter(s.local)
            shards[f"{name}.weight"] = dataclasses.replace(s,
                                                           local=mod.weight)
        model.row_shards = shards
        return shards

    def place_batch(self, *arrays, device=None):
        """This rank's slice over 'data' of each array of a batch (whose
        length is a multiple of the axis)."""
        return tuple(self.place(a, self.batch, device) for a in arrays)

    def place_replicated(self, *arrays, device=None):
        return tuple(self.place(a, self.replicated, device) for a in arrays)
