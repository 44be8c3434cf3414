"""Sampled-plan construction on the device: no per-step host planning.

The port of ``stargcn_tpu/graph/device_sampling.py``.  The host sampled
mode (``graph/sampling.py`` + ``models/sampled.py``) builds a plan on the
CPU every step and copies it to the card; here the graph lives on the
device once (the CSR arrays of both directions) and each step hands the
planner only the batch (pair indices, validity, recon ids).  Frontier
construction, fanout sampling, deduplication, supports, REMOVE_RATING
exclusion and every position map are tensor ops under fixed caps:

* capped unique = two sorts (``_capped_unique``), padded with the node
  count as sentinel and truncated at the frontier cap;
* fanout sampling draws ``K`` neighbours WITH replacement where ``deg >
  K`` (one uniform per slot) and takes every neighbour where ``deg <= K``,
  so at ``fanout >= max degree`` the plan equals the host planner's;
* positions = a binary search in the sorted capped frontier
  (``_positions``);
* dense frontiers: where a cap reaches the node count the frontier IS the
  node set in index order, so dedup and position maps vanish (levels are
  stored as ``None``).

Nothing in the build waits for the host: the number of distinct nodes a
level needed comes back as a device scalar with an ``overflow`` flag, and
the trainer rejects an overflowed step on the device and grows its caps
when it next reads its statistics.

The draws are arguments: ``DevicePlanner.build`` calls ``uniform(shape)``
once per level and node type (user, then item), so a test can feed the
JAX package's own uniforms and ask for the same plan, array for array.

REMOVE_RATING: the JAX package picks one of three scatter-free
formulations per type (a node-space one-hot product, a slot-space one-hot
product, rank tables with a bounded candidate list), because a scatter is
serialised on its TPU runtime and its memory is small.  The port keeps one
exact formulation with the same keep-mask: the batch pairs as sorted int64
``row * n_other + partner`` keys and one binary search per sampled slot.
It needs no bound on a node's batch edges (``needed_exclude`` is always
0), no one-hot (4096 x 69,878 bf16 is 572 MB at ML-10M), and int64 keys
have no id-product limit.  The per-node batch-edge counts are an
``index_add_``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

_TYPES = ("user", "item")
_KEY_SENTINEL = torch.iinfo(torch.int64).max


@dataclasses.dataclass
class DeviceGraphTables:
    """Device-resident CSR tables for both bipartite directions.

    Per direction ``t`` in ("user", "item") (rows are type ``t``): the
    row pointers, column indices, rating-level indices, row and column
    degrees, the row index -> global id map and its inverse, all int32.
    ``ids_iota[i]`` holds where type i's row ids ARE ``0..n-1`` (every
    graph whose node ids were never remapped): the sampled forward may
    then read its tables without a gather on dense frontiers.
    """

    ind_ptr: Dict[str, torch.Tensor]
    end_points: Dict[str, torch.Tensor]
    rating_idx: Dict[str, torch.Tensor]
    row_deg: Dict[str, torch.Tensor]
    col_deg: Dict[str, torch.Tensor]
    row_ids: Dict[str, torch.Tensor]
    id2ind: Dict[str, torch.Tensor]
    ids_iota: tuple = (False, False)

    @property
    def n(self):
        return {t: int(self.row_ids[t].shape[0]) for t in _TYPES}

    @staticmethod
    def build(graph, name_user="user", name_item="movie", device="cuda"):
        """Both directions of a host ``HeterGraph`` on ``device``."""
        csr = {"user": graph[name_user, name_item],
               "item": graph[name_item, name_user]}
        out = dict(ind_ptr={}, end_points={}, rating_idx={}, row_deg={},
                   col_deg={}, row_ids={}, id2ind={})

        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(device)

        for t in _TYPES:
            c = csr[t]
            out["ind_ptr"][t] = put(c.ind_ptr)
            out["end_points"][t] = put(c.end_points)
            out["rating_idx"][t] = put(np.searchsorted(c.multi_link,
                                                       c.values))
            out["row_deg"][t] = put(c.row_degrees)
            out["col_deg"][t] = put(c.col_degrees)
            ids = np.asarray(c.row_ids, np.int64)
            out["row_ids"][t] = put(ids)
            inv = np.zeros(int(ids.max(initial=0)) + 1, np.int32)
            inv[ids] = np.arange(ids.size, dtype=np.int32)
            out["id2ind"][t] = put(inv)
        iota = tuple(bool((np.asarray(csr[t].row_ids)
                           == np.arange(csr[t].shape[0])).all())
                     for t in _TYPES)
        return DeviceGraphTables(**out, ids_iota=iota)


def _take(table, idx):
    """``table[idx]`` for an index tensor of any shape (a flat
    ``index_select``)."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _capped_unique(x, cap, n):
    """Sorted unique of ``x`` (values in ``[0, n]``; ``n`` is the invalid
    sentinel), padded with ``n`` and cut to at most ``cap`` slots.  Returns
    ``(uniq, needed)``: ``needed`` counts the real distinct values, and
    ``needed > cap`` means the tail was cut (the plan is invalid and the
    caps must grow).  Two sorts: flag the first of each run, then sort the
    flagged values to the front (everything else maps to the sentinel)."""
    s = torch.sort(x).values
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                      s[1:] != s[:-1]]) & (s < n)
    needed = keep.sum().to(torch.int32)
    uniq = torch.sort(torch.where(keep, s, n)).values[:cap]
    return uniq.to(torch.int32), needed


def _positions(frontier, n, query, query_valid=None):
    """``(pos, ok)`` of ``query`` in a SORTED capped frontier over index
    space ``[0, n)``: a binary search (the host planners' intern maps).
    Missing or invalid queries give ``pos = 0, ok = 0``."""
    cap = frontier.shape[0]
    ss = torch.searchsorted(frontier, query, out_int32=True).clamp_max(
        cap - 1)
    ok = (_take(frontier, ss) == query) & (query < n)
    if query_valid is not None:
        ok = ok & query_valid
    return torch.where(ok, ss, 0), ok.to(torch.float32)


def batch_edge_keys(rows_b, cols_b, ok_b, n_other):
    """The batch pairs of one direction as sorted int64 keys ``row *
    n_other + partner``; invalid slots (``ok_b`` false) sort last as a
    sentinel no query matches."""
    k = rows_b.long() * n_other + cols_b.long()
    return torch.sort(torch.where(ok_b, k, _KEY_SENTINEL)).values


def keep_mask(keys, rows, nbr, n_other):
    """False on the sampled slots ``(rows[i], nbr[i, k])`` that are batch
    edges (``keys`` from ``batch_edge_keys``): one binary search per slot.
    ``rows`` may hold the sentinel ``n_t`` on invalid rows: its keys pass
    every real one and match none."""
    q = rows.long()[:, None] * n_other + nbr.long()
    pos = torch.searchsorted(keys, q).clamp_max(keys.shape[0] - 1)
    return _take(keys, pos) != q


def uniform_from(generator):
    """``uniform(shape)`` drawing from ``generator`` on its device."""
    return lambda shape: torch.rand(shape, generator=generator,
                                    device=generator.device)


class DevicePlanner:
    """Builds the sampled-plan tree on the device.

    ``caps`` = ``{"user": int, "item": int}`` frontier caps (every level
    holds at most that many nodes; a cap at or above the node count gives
    the dense path).  ``symm`` selects ``1/sqrt(d_r * d_c)`` against
    ``1/d_r`` supports, the host sampler's arithmetic.
    """

    def __init__(self, model_cfg, caps, fanout, *, symm=True):
        self.nblocks = int(model_cfg.nblocks)
        self.num_layers = len(model_cfg.agg_units)
        self.caps = {t: int(caps[t]) for t in _TYPES}
        self.fanout = int(fanout)
        self.symm = bool(symm)
        assert self.fanout > 0

    def _sample_level(self, tab, t, other, frontier_t, u, rem,
                      ident=False):
        """Fanout-sample type-``other`` neighbours of every valid row of
        ``frontier_t`` with the uniforms ``u`` ``(len(frontier_t), K)``;
        returns (neighbour index, rating level, weight, slot validity),
        each ``(len(frontier_t), K)``.  ``ident`` says ``frontier_t ==
        arange(n_t)`` (the dense path): the per-row reads are the tables
        themselves."""
        K = self.fanout
        n_t = tab.n[t]
        j = torch.arange(K, dtype=torch.int32, device=u.device)[None, :]
        if ident:
            assert frontier_t.shape[0] == n_t
            safe = frontier_t
            start = tab.ind_ptr[t][:-1]
            deg = tab.row_deg[t]
            ok_row = None
        else:
            ok_row = frontier_t < n_t
            safe = torch.where(ok_row, frontier_t, 0)
            start = _take(tab.ind_ptr[t], safe)
            deg = _take(tab.ind_ptr[t], safe + 1) - start
        d = deg[:, None]
        last = (d - 1).clamp_min(0)
        r = torch.minimum((u * d).to(torch.int32), last)
        r = torch.where(d <= K, j, r)
        slot_ok = (d > K) | (j < d)
        e = start[:, None] + torch.minimum(r, last)
        if ok_row is not None:
            slot_ok = ok_row[:, None] & slot_ok
            e = torch.where(ok_row[:, None], e, 0)
        # A row of degree 0 at the end of the table points one past the
        # last edge; its slots are invalid, and the clamp keeps the gather
        # in range (on the card an out-of-range index ends the process).
        e = e.clamp_max(tab.end_points[t].shape[0] - 1)
        nbr = _take(tab.end_points[t], e)
        rating = _take(tab.rating_idx[t], e)
        # support from the (removal-adjusted) degrees: BlockSampler's
        # arithmetic; ``rem`` holds the per-node batch-edge counts
        dr = d.to(torch.float32)
        dc = _take(tab.col_deg[t], nbr).to(torch.float32)
        if rem is not None:
            rem_rows = rem[t] if ident else _take(rem[t], safe)
            dr = dr - rem_rows[:, None]
            dc = dc - _take(rem[other], nbr)
        if self.symm:
            denom = dr * dc
            sup = torch.where(denom > 0,
                              torch.rsqrt(denom.clamp_min(1.0)), 0.0)
        else:
            sup = torch.where(dr > 0, 1.0 / dr.clamp_min(1.0), 0.0)
        weight = sup * slot_ok.to(torch.float32)
        return nbr, rating, weight, slot_ok

    def build(self, tab: DeviceGraphTables, uniform, bu_ind, bi_ind,
              pairs_valid, recon_u_ids, recon_i_ids, *,
              exclude: bool = False):
        """The stacked plan of one batch.

        ``bu_ind`` / ``bi_ind`` are the padded batch pair INDICES (row
        spaces of the two directions), ``pairs_valid`` their float
        validity, ``recon_*_ids`` the -1-padded global recon ids (they
        pass through to the tree's ``recon_ids``).  ``uniform(shape)``
        gives the fanout draws.  Returns ``(plan, pairs_pos, aux)``:
        ``plan`` is the tree ``sampled_forward`` reads (with ``pairs_pos``
        None), ``aux`` the per-type distinct-node counts the plan needed,
        ``needed_exclude`` (0), ``overflow`` (device scalars) and the
        static ``identity`` flags for ``sampled_forward``'s
        ``identity_frontiers``.
        """
        dev = bu_ind.device
        big = tab.n
        # a frontier never exceeds the node count, so caps clamp to it,
        # which also makes overflow impossible at cap == n
        cap = {t: min(self.caps[t], big[t]) for t in _TYPES}
        K = self.fanout
        dense = {t: cap[t] >= big[t] for t in _TYPES}
        other_of = {"user": "item", "item": "user"}

        rem = keys = None
        if exclude:
            # REMOVE_RATING: per-node batch-edge counts, and the batch
            # pairs of each direction as sorted (row, partner) keys;
            # invalid batch slots count nothing and sort last.
            ok_b = pairs_valid > 0
            rem, keys = {}, {}
            for t, rows_b, cols_b in (("user", bu_ind, bi_ind),
                                      ("item", bi_ind, bu_ind)):
                rows = torch.where(ok_b, rows_b, 0).long()
                rem[t] = torch.zeros(big[t], dtype=torch.float32,
                                     device=dev).index_add_(
                    0, rows, ok_b.to(torch.float32))
                keys[t] = batch_edge_keys(rows_b, cols_b, ok_b,
                                          big[other_of[t]])

        # recon indices (id -> index; -1 stays invalid)
        rec_ind = {}
        for t, ids in (("user", recon_u_ids), ("item", recon_i_ids)):
            inv = tab.id2ind[t]
            ii = _take(inv, ids.clamp(0, inv.shape[0] - 1))
            rec_ind[t] = torch.where(ids >= 0, ii, big[t])

        base = {
            "user": torch.cat([torch.where(pairs_valid > 0, bu_ind,
                                           big["user"]), rec_ind["user"]]),
            "item": torch.cat([torch.where(pairs_valid > 0, bi_ind,
                                           big["item"]), rec_ind["item"]]),
        }
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        needed = {t: zero for t in _TYPES}

        def uniq(t, arr):
            if dense[t]:
                return None  # the identity frontier
            u, n = _capped_unique(arr, cap[t], big[t])
            needed[t] = torch.maximum(needed[t], n)
            return u

        def lvl_arr(t, lvl):
            """A level as an index array."""
            if lvl is None:
                return torch.arange(cap[t], dtype=torch.int32, device=dev)
            return lvl

        def lvl_len(t, lvl):
            return cap[t] if lvl is None else lvl.shape[0]

        def pos_of(t, frontier_t, query, query_valid=None):
            """(pos, ok) of index-space queries in a level of type t."""
            if dense[t]:
                ok = (query >= 0) & (query < big[t])
                if query_valid is not None:
                    ok = ok & query_valid
                return torch.where(ok, query, 0), ok.to(torch.float32)
            return _positions(frontier_t, big[t], query, query_valid)

        chains = []       # per chain: (levels, blocks bottom-up)
        tgt = dict(base)
        for _ in range(self.nblocks):
            levels = [{t: uniq(t, tgt[t]) for t in _TYPES}]
            blocks_td = []
            for _ in range(self.num_layers):
                cur = levels[-1]
                samp = {}
                for t in _TYPES:
                    fr_t = lvl_arr(t, cur[t])
                    u = uniform((fr_t.shape[0], K))
                    nbr, rating, weight, slot_ok = self._sample_level(
                        tab, t, other_of[t], fr_t, u, rem, ident=dense[t])
                    if keys is not None:
                        weight = weight * keep_mask(
                            keys[t], fr_t, nbr, big[other_of[t]])
                    samp[t] = (nbr, rating, weight, slot_ok)
                nxt = {}
                for t in _TYPES:
                    if dense[t]:
                        nxt[t] = None
                        continue
                    nbr, _, _, slot_ok = samp[other_of[t]]
                    nxt[t] = uniq(t, torch.cat(
                        [lvl_arr(t, cur[t]),
                         torch.where(slot_ok, nbr, big[t]).reshape(-1)]))
                lvl_blocks = {}
                for t in _TYPES:
                    other = other_of[t]
                    nbr, rating, weight, slot_ok = samp[t]
                    npos, nok = pos_of(other, nxt[other], nbr,
                                       query_valid=slot_ok)
                    # combined idx = rating * n_src + pos, n_src the
                    # source level's length (models/sampled.py _blk_host)
                    idx = (torch.where(slot_ok, rating, 0)
                           * lvl_len(other, nxt[other]) + npos)
                    lvl_blocks[t] = {"idx": idx.to(torch.int32),
                                     "weight": weight * nok}
                blocks_td.append(lvl_blocks)
                levels.append(nxt)
            chains.append((levels, blocks_td[::-1]))
            f0 = levels[-1]
            tgt = {t: (base[t] if dense[t] else torch.cat([base[t], f0[t]]))
                   for t in _TYPES}
        chains = chains[::-1]  # block 0 = deepest chain

        def to_ids(t, lvl):
            if lvl is None:
                return tab.row_ids[t]
            ok = lvl < big[t]
            return torch.where(
                ok, _take(tab.row_ids[t], torch.where(ok, lvl, 0)), -1)

        plan = {
            "frontiers": [{t: to_ids(t, levels[-1][t]) for t in _TYPES}
                          for levels, _ in chains],
            "blocks": [blocks for _, blocks in chains],
            "pairs_pos": None,
            "cross_gather": [None] + [
                {t: pos_of(t, chains[b - 1][0][0][t],
                           lvl_arr(t, chains[b][0][-1][t]))
                 for t in _TYPES}
                for b in range(1, self.nblocks)],
            "recon_pos": [{t: pos_of(t, levels[0][t], rec_ind[t])
                           for t in _TYPES}
                          for levels, _ in chains],
            "recon_ids": {"user": recon_u_ids, "item": recon_i_ids},
        }
        pairs_pos = [
            {"user": pos_of("user", levels[0]["user"], bu_ind)[0],
             "item": pos_of("item", levels[0]["item"], bi_ind)[0]}
            for levels, _ in chains]
        overflow = ((needed["user"] > cap["user"])
                    | (needed["item"] > cap["item"]))
        aux = {"needed_user": needed["user"],
               "needed_item": needed["item"],
               "needed_exclude": zero,
               "overflow": overflow,
               # static: every frontier of this type is the whole node set
               # in natural order AND node ids are 0..n-1
               "identity": {t: bool(dense[t]) and bool(tab.ids_iota[i])
                            for i, t in enumerate(_TYPES)}}
        return plan, pairs_pos, aux
