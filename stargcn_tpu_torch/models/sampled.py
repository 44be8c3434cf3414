"""Sampled mini-batch forward/training: the two-phase plan/execute path.

The port of ``stargcn_tpu/models/sampled.py``, for graphs too large for
full-graph propagation.  The host phase (``StackedPlan.build``) samples
fixed-shape ELL frontier chains per block and precomputes every cross-level
index array, so the device phase (``sampled_forward``) is pure tensor code
over shapes that (with ``frontier_caps``) do not change from batch to
batch.  It runs over the SAME parameters as the full-graph ``STARGCN``
module (its ``named_parameters``), so checkpoints are interchangeable.

With ``fanout = -1`` (all neighbors) the sampled forward equals the
full-graph forward on the target nodes (``tests/test_torch_sampled.py``).
Plans built on the device (``graph/device_sampling.py``) have the same
tree, and may mark whole-node-set frontiers with ``identity_frontiers``.

Backends of the device phase: ``'xla'`` pools raw source rows per rating
level and then projects (plain indexing and matrix products, the JAX
package's default formulation); ``'pallas'`` projects first and pools the
projected rows through ``ops.ell_kernels.ell_spmm``, the hand-written
CUDA kernels on a card.  The names are the JAX package's.

On a device mesh (``row_sharding``, a ``parallel.Mesh``) the forward
splits its work as the JAX package's ``_constrain(x, P('data', None))``
does, with the collectives written out (``parallel/collectives.py``):

* at each level, rank k of the 'data' axis pools and projects its slice
  of the destination rows (``shardings.padded_split``: equal slices, the
  last ones padded with empty rows) and ``gather_rows`` makes the level's
  output whole for the next level (the padded rows are dropped, so their
  cotangent is zero);
* the whole source rows enter the split work through ``enter``, so their
  cotangent is summed over 'data' once, in float32 on the ``pallas``
  route (after its ``.float()``), in the compute dtype on ``xla``; the
  parameters used there (each direction's aggregator and out-FC) enter it
  too: a bias through ``enter``, a weight through ``matmul_f32``'s
  ``b_group`` (its float32 cotangent summed before it is rounded to the
  compute dtype) or, on the float32 ``pallas`` projection, ``enter``;
* the embedding tables are split by rows over 'model' (where their rows
  divide; ``GraphShardings.place_params``): each 'model' rank looks up the
  frontier ids that fall in its own rows, the other slots read zero, and
  ``leave`` adds the ranks' rows; the backward scatters the whole
  cotangent into the rank's own rows.  No table is gathered whole.  The
  identity frontiers of ``plan_device`` read their ids the same way on a
  split table (the frontier is then every row);
* dropout draws each mask at the whole shape one process draws and keeps
  the rank's rows, so every rank's masks are one process's;
* everything else (the rating heads, the DAE decoders, the feature MLPs,
  the losses) is replicated: each rank computes it on the whole rows.

GSPMD left the placement of the 'data' sums and of the split parameters'
cotangents to XLA; the port fixes them as above.

Every differentiable row gather goes through ``ops.gather.take_rows``
(``index_select``): its gradient is an ``index_add_``.  Advanced indexing
(``x[idx]``) has a gradient that walks runs of equal indices serially, and
under fixed caps every padded slot names row 0: tens of thousands of equal
indices per gather, and most of a training step's time on a card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from stargcn_tpu_torch.graph import kernels as K
from stargcn_tpu_torch.graph.sampling import BlockSampler, SampledBlocks
from stargcn_tpu_torch.models.common import compute_dtype
from stargcn_tpu_torch.models.common import dropout as _dropout
from stargcn_tpu_torch.models.common import get_activation
from stargcn_tpu_torch.ops import ell_kernels
from stargcn_tpu_torch.ops.agg import matmul_f32, multi_link_project
from stargcn_tpu_torch.ops.gather import take_rows
from stargcn_tpu_torch.parallel.collectives import enter, gather_rows, leave
from stargcn_tpu_torch.parallel.mesh import Mesh
from stargcn_tpu_torch.parallel.shardings import padded_split


@dataclasses.dataclass
class StackedPlan:
    """Per-block frontier chains (block 0 = deepest) + index arrays.

    All members are numpy; ``as_host_tree()`` gives the tree the device
    step reads.  ``cross_gather[b]`` maps block b's level-0 frontier into
    block b-1's top frontier (positions + validity).  ``recon_pos`` locates
    the reconstruction target ids in each block's top frontier.
    """

    chains: List[SampledBlocks]
    pairs_pos: List[dict]
    cross_gather: List[Optional[dict]]
    recon_ids: dict
    recon_pos: List[dict]

    @staticmethod
    def build(graph, cfg, pairs_user, pairs_item, fanout=-1,
              node_pad=128, name_user="user", name_item="movie",
              recon_user_ids=None, recon_item_ids=None, seed=None,
              frontier_caps=None, sampler=None, exclude_pairs=None):
        """Top-down planning across blocks: block b's targets =
        rating-pair nodes (+ recon nodes) + the bottom frontier required
        by block b+1.

        Pass a prebuilt ``BlockSampler`` when planning repeatedly: its
        constructor precomputes support/rating arrays over ALL edges
        (seconds on a 10M-edge graph), which per-batch sampling reuses.

        ``exclude_pairs=(batch_user_ids, batch_item_ids)`` implements
        REMOVE_RATING: those edges are dropped from every sampled
        neighborhood and supports are recomputed from the
        removal-adjusted degrees — without them, each target pair's own
        rating leaks into the features predicting it.
        """
        if seed is not None:
            K.set_seed(seed)
        L = len(cfg.agg_units)
        if sampler is None:
            sampler = BlockSampler(
                graph, num_layers=L, fanout=fanout,
                symm=cfg.agg_norm_symm, node_pad=node_pad,
                name_user=name_user, name_item=name_item,
                frontier_caps=frontier_caps)
        exclude_keys = removal = None
        if exclude_pairs is not None:
            exclude_keys, removal = sampler.removal_args(*exclude_pairs)
        base_u = np.unique(np.asarray(pairs_user, np.int32))
        base_i = np.unique(np.asarray(pairs_item, np.int32))
        recon_ids = {
            "user": (np.asarray(recon_user_ids, np.int32)
                     if recon_user_ids is not None
                     else np.zeros(0, np.int32)),
            "item": (np.asarray(recon_item_ids, np.int32)
                     if recon_item_ids is not None
                     else np.zeros(0, np.int32)),
        }
        # -1 recon slots are padding (fixed-shape recon batches)
        base_u = np.union1d(base_u,
                            recon_ids["user"][recon_ids["user"] >= 0])
        base_i = np.union1d(base_i,
                            recon_ids["item"][recon_ids["item"] >= 0])

        chains = []
        tgt_u, tgt_i = base_u, base_i
        for _ in range(cfg.nblocks):
            blocks = sampler.sample(tgt_u, tgt_i,
                                    exclude_keys=exclude_keys,
                                    removal_counts=removal)
            chains.append(blocks)
            f0 = blocks.frontiers[0]
            tgt_u = np.union1d(base_u, f0["user"][f0["user"] >= 0])
            tgt_i = np.union1d(base_i, f0["item"][f0["item"] >= 0])
        chains = chains[::-1]  # block 0 = deepest chain

        def positions(top_ids, query_ids):
            """(pos, ok) of query_ids within top_ids (-1 slots -> ok=0)."""
            size = int(max(top_ids.max(initial=0),
                           query_ids.max(initial=0))) + 1
            pos_map = np.full(size + 1, -1, np.int32)
            valid_top = top_ids >= 0
            pos_map[top_ids[valid_top]] = np.nonzero(valid_top)[0]
            safe = np.where(query_ids >= 0, query_ids, size)
            pos = pos_map[np.minimum(safe, size)]
            ok = (pos >= 0) & (query_ids >= 0)
            return (np.where(ok, pos, 0).astype(np.int32),
                    ok.astype(np.float32))

        pu = np.asarray(pairs_user, np.int32)
        pi = np.asarray(pairs_item, np.int32)
        pairs_pos, cross_gather, recon_pos = [], [], []
        for b, blocks in enumerate(chains):
            top = blocks.frontiers[-1]
            pairs_pos.append({
                "user": positions(top["user"], pu)[0],
                "item": positions(top["item"], pi)[0],
            })
            recon_pos.append({
                t: positions(top[t], recon_ids[t]) for t in ("user", "item")
            })
            if b == 0:
                cross_gather.append(None)
            else:
                prev_top = chains[b - 1].frontiers[-1]
                f0 = blocks.frontiers[0]
                cross_gather.append({
                    t: positions(prev_top[t], f0[t])
                    for t in ("user", "item")})
        return StackedPlan(chains=chains, pairs_pos=pairs_pos,
                           cross_gather=cross_gather, recon_ids=recon_ids,
                           recon_pos=recon_pos)

    def as_host_tree(self):
        """The plan as the tree of numpy arrays that ``sampled_forward``
        reads (after ``to`` or ``pack_tree`` / ``unpack_tree``).

        Feed it through :func:`pack_tree` to ship the whole plan to the
        device as two flat buffers: the plan is ~30 small arrays, and a
        copy per array pays the host-to-device latency each time."""
        return {
            "frontiers": [
                {t: np.asarray(f[t]) for t in ("user", "item")}
                for c in self.chains for f in [c.frontiers[0]]],
            "blocks": [[{t: _blk_host(lvl[t],
                                      len(c.frontiers[li][_SRC_OF[t]]))
                         for t in ("user", "item")}
                        for li, lvl in enumerate(c.blocks)]
                       for c in self.chains],
            "pairs_pos": [{t: np.asarray(p[t]) for t in ("user", "item")}
                          for p in self.pairs_pos],
            "cross_gather": [
                None if cg is None else
                {t: (np.asarray(cg[t][0]), np.asarray(cg[t][1]))
                 for t in ("user", "item")}
                for cg in self.cross_gather],
            "recon_pos": [
                {t: (np.asarray(rp[t][0]), np.asarray(rp[t][1]))
                 for t in ("user", "item")}
                for rp in self.recon_pos],
            "recon_ids": {t: np.asarray(self.recon_ids[t])
                          for t in ("user", "item")},
        }

    def to(self, device):
        """``as_host_tree()`` with every array a tensor on ``device`` (one
        copy per array; the trainer packs the tree into two buffers
        instead)."""
        return _map_leaves(
            self.as_host_tree(),
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))


_SRC_OF = {"user": "item", "item": "user"}


def _blk_host(b, n_src):
    """ELL block as shipped arrays: the per-slot rating level and source
    position fold into ONE combined index ``rating * n_src + nbr_pos``
    (what :func:`_ell_aggregate` indexes the (R*n_src, units) projection
    with) — halving the plan's int payload; the 'stack' accumulator
    recovers the rating as ``idx // n_src`` on device."""
    return {"idx": (np.asarray(b.rating) * np.int32(n_src)
                    + np.asarray(b.nbr_pos)).astype(np.int32),
            "weight": np.asarray(b.weight)}


# ------------------------------ packed trees ------------------------------


def _map_leaves(tree, fn):
    """``tree`` (dicts, lists, tuples, ``None``, array leaves) with ``fn``
    applied to every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _flatten(tree, leaves):
    """Append the leaves of ``tree`` to ``leaves`` (dict keys in sorted
    order, ``None`` a node without leaves) and return its hashable
    structure."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return ("leaf",)


def _unflatten(struct, leaves):
    kind = struct[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(struct[1],
                                                         struct[2])}
    seq = [_unflatten(s, leaves) for s in struct[1]]
    return seq if kind == "list" else tuple(seq)


def pack_tree(tree):
    """Flatten a tree of numpy arrays into ``(int_buf, float_buf, spec)``.

    One int32 and one float32 buffer carry every leaf, so a step that
    takes the pair costs exactly TWO host-to-device copies no matter how
    many arrays the plan holds.  ``spec`` is hashable (the tree structure +
    per-leaf (is_float, offset, shape)); rebuild the tree on the device
    with :func:`unpack_tree` (slices of the two buffers: views, no
    copies).  Leaves are laid out in the JAX package's order (dict keys
    sorted), so the buffers equal its ``pack_tree``'s."""
    leaves = []
    struct = _flatten(tree, leaves)
    int_parts, flt_parts, metas = [], [], []
    io = fo = 0
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.dtype == np.float32:
            metas.append((True, fo, a.shape))
            flt_parts.append(a.ravel())
            fo += a.size
        elif a.dtype == np.int32:
            metas.append((False, io, a.shape))
            int_parts.append(a.ravel())
            io += a.size
        else:
            raise TypeError(f"pack_tree: unsupported dtype {a.dtype}")
    ibuf = (np.concatenate(int_parts) if int_parts
            else np.zeros(0, np.int32))
    fbuf = (np.concatenate(flt_parts) if flt_parts
            else np.zeros(0, np.float32))
    return ibuf, fbuf, (struct, tuple(metas))


def unpack_tree(int_buf, float_buf, spec):
    """Inverse of :func:`pack_tree` over numpy arrays or tensors (on any
    device): every leaf is a reshaped slice of its buffer."""
    struct, metas = spec
    leaves = []
    for is_float, off, shape in metas:
        buf = float_buf if is_float else int_buf
        n = 1
        for d in shape:
            n *= d
        leaves.append(buf[off:off + n].reshape(shape))
    return _unflatten(struct, iter(leaves))


# ------------------------------ device phase ------------------------------


def _masked_embed_rows(table, ids, noise, lo=None):
    """Gather embedding rows for frontier ids through the noise array
    (-1 / padded frontier slots -> zero rows).  ``lo``: ``table`` holds
    rows ``[lo, lo + len(table))`` of the whole table, and ids outside
    them read zero rows too."""
    safe_ids = torch.where(ids >= 0, ids, torch.zeros_like(ids))
    redirected = noise[safe_ids.long()]
    keep = (redirected != -1) & (ids >= 0)
    if lo is not None:
        redirected = redirected - lo
        keep = keep & (redirected >= 0) & (redirected < table.shape[0])
    rows = take_rows(table, torch.where(
        keep, redirected, torch.zeros_like(redirected)).long())
    return rows * keep[:, None].to(table.dtype)


def _own_rows(table, ids, lo):
    """Rows ``ids`` (-1 read row 0) of a whole table of which ``table``
    holds rows ``[lo, lo + len(table))``; the other ids read zero rows."""
    local = ids.clamp_min(0).long() - lo
    keep = (local >= 0) & (local < table.shape[0])
    rows = take_rows(table, torch.where(keep, local, torch.zeros_like(local)))
    return rows * keep[:, None].to(table.dtype)


def _block_rows(block, lo, hi, rows):
    """Rows ``[lo, hi)`` of an ELL block, padded with empty rows (index 0,
    weight 0) to ``rows``."""
    pad = rows - (hi - lo)
    return {k: F.pad(block[k][lo:hi], (0, 0, 0, pad))
            for k in ("idx", "weight")}


def _dropout_rows(x, rate, train, generator, n, lo):
    """``common.dropout`` of ``x``, rows ``[lo, lo + len(x))`` of an
    ``(n, F)`` whole (rows past ``n`` are padding): the mask is drawn at
    the whole's shape, as one process draws it, and this slice kept."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = x.new_empty((n, x.shape[1])).bernoulli_(1.0 - rate,
                                                    generator=generator)
    keep = keep[lo:lo + x.shape[0]]
    keep = F.pad(keep, (0, 0, 0, x.shape[0] - keep.shape[0]))
    return x * keep / (1.0 - rate)


def _take_slots(x, idx):
    """``x[idx]`` for a 2-D slot index: ``(N, K, F)``."""
    n, k = idx.shape
    return take_rows(x, idx.reshape(-1).long()).reshape(n, k, -1)


def _onehot(levels, num_links, dtype):
    return F.one_hot(levels.long(), num_links).to(dtype)


def _ell_aggregate(proj, block, accum, use_pallas):
    """Pool per-rating projections over an ELL block.

    'sum' is one fused gather-pool (``ell_spmm`` when ``use_pallas``);
    'stack' gathers once and splits the per-slot messages across rating
    channels with a one-hot contraction (no per-rating re-gather).
    """
    R, n_src, units = proj.shape
    flat = proj.reshape(R * n_src, units)
    idx = block["idx"]  # rating * n_src + nbr_pos, combined on host
    w = block["weight"]
    if accum == "sum":
        if use_pallas:
            return ell_kernels.ell_spmm(flat, idx, w)
        return (_take_slots(flat, idx) * w[:, :, None]).sum(dim=1)
    # 'stack': msg[n,k,u] routed to channel block rating[n,k].
    msg = _take_slots(flat, idx) * w[:, :, None]                   # N,K,U
    onehot = _onehot(idx // n_src, R, msg.dtype)                   # N,K,R
    pooled = torch.einsum("nku,nkr->nru", msg, onehot)
    return pooled.reshape(pooled.shape[0], R * units)


def _pool_then_project(x, weight, bias, block, accum, ordinal_sharing,
                       group=None):
    """Aggregate RAW source rows per rating level, then project the
    pooled result — linear-equivalent to project-then-pool (projection
    and pooling are both linear: ``pool_r(xW_r + b_r) = pool_r(x)W_r +
    wsum_r b_r``), with the per-level intermediate shrunk from
    ``(R, n_src, agg_units)`` to ``(n_dst, R, embed)``.

    Mixed precision rides on ``x.dtype``: in bf16 the messages and the
    slot weights are bf16, every contraction accumulates in float32, the
    pooled rows are rounded to bf16 before the projection and the bias is
    added in float32 (the JAX package's contract).  The output is
    float32.  ``group``: the process group over whose ranks the block's
    rows are split; ``weight``'s cotangent is summed over it
    (``matmul_f32``'s ``b_group``)."""
    if ordinal_sharing:
        weight = torch.cumsum(weight, dim=0)
        bias = torch.cumsum(bias, dim=0)
    R = weight.shape[0]
    n_src = x.shape[0]
    idx = block["idx"]          # rating * n_src + nbr_pos (combined)
    w = block["weight"].to(x.dtype)  # (n_dst, K); 0 on padded slots
    msg = _take_slots(x, idx % n_src) * w[:, :, None]              # N,K,E
    onehot_t = _onehot(idx // n_src, R, x.dtype).transpose(1, 2)   # N,R,K
    raw = matmul_f32(onehot_t, msg).to(x.dtype)                    # N,R,E
    wsum = matmul_f32(onehot_t, w[:, :, None])[..., 0]             # N,R
    weight, bias = weight.to(x.dtype), bias.float()
    n = raw.shape[0]
    if accum == "sum":
        return matmul_f32(raw.reshape(n, -1),
                          weight.reshape(-1, weight.shape[-1]),
                          b_group=group) + wsum @ bias
    ch = matmul_f32(raw.transpose(0, 1), weight,
                    b_group=group).transpose(0, 1)                 # N,R,A
    return (ch + wsum[:, :, None] * bias).reshape(n, -1)


def _named(params):
    """``name -> tensor`` from a module or from a mapping."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


class _Replay:
    """One level's dropout stream under ``remat``: the first run (the
    forward) draws from the caller's generator, which ends where it would
    without remat; every later run (the recomputation in the backward)
    draws from a generator restored to the state the first run started
    from, so it replays the same masks.  ``torch.utils.checkpoint``'s own
    ``preserve_rng_state`` saves only the default generators, not an
    explicit one."""

    def __init__(self, generator):
        self.generator = generator
        self.state = None if generator is None else generator.get_state()
        self.runs = 0

    def next(self):
        self.runs += 1
        if self.generator is None or self.runs == 1:
            return self.generator
        g = torch.Generator(device=self.generator.device)
        g.set_state(self.state)
        return g


def sampled_forward(params, cfg, plan, noise_user, noise_item,
                    backend: str = "xla", *, train: bool = False,
                    generator=None, features=None, row_sharding=None,
                    identity_frontiers=None, remat: bool = False):
    """Bottom-up execution of the stacked plan.

    ``params`` is the full-graph ``STARGCN`` module or its parameters by
    name (``named_parameters`` / ``state_dict`` keys).  ``plan`` may be a
    ``StackedPlan`` (copied to the parameters' device on the fly) or a tree
    of tensors on that device: ``StackedPlan.to(device)`` or an unpacked
    ``as_host_tree()``.  ``noise_user`` / ``noise_item`` are the full-size
    int noise arrays (-1 = mask the embedding to zero).  Dropout (``train``
    with ``cfg.gcn_dropout`` > 0) falls on the source features inside each
    aggregator and on the aggregated features before the out-FC, drawn from
    ``generator``, a ``torch.Generator`` on the same device.

    ``features`` = ``(user, item)`` raw feature tensors on the device,
    required with ``cfg.use_fea_proj``: each frontier's rows go through the
    two-layer feature MLP (never noise-masked; padded slots give zero
    rows) and join the embedding rows, or replace them without
    ``cfg.use_embed``.  ``cfg.compute_dtype`` bf16 runs every level in
    bf16 with float32 accumulation and keeps the heads, the decoder and
    the predictions in float32; the ``pallas`` route feeds the ELL kernel
    float32 rows, as the JAX package does.

    ``identity_frontiers`` (``{"user": bool, "item": bool}``, the device
    planner's ``aux["identity"]``) marks the types whose every frontier is
    the whole node set in id order: with ``cfg.self_noise_only``, their
    embedding reads become an elementwise row mask (no gather, so no
    scatter in the backward), their features are projected table-wide and
    cross-block features pass straight through.

    ``remat`` recomputes each level in the backward instead of keeping its
    ``(N, K, E)`` messages and ``(N, R, E)`` pooled rows
    (``torch.utils.checkpoint``); each level replays its own dropout masks
    (``_Replay``), so loss and gradients equal those without ``remat``.
    On a mesh the recomputed part is the rank's own rows; the level's
    ``gather_rows`` lies outside it, so no collective is replayed.

    ``row_sharding``: a ``parallel.Mesh`` to split the work over (the
    module docstring), every rank calling with the same plan and inputs;
    ``params`` then hold this rank's rows of each table split over
    'model' (a table of the whole row count is whole).  The outputs are
    whole on every rank.

    Returns {'pred_ratings': (nblocks, B), 'pred_embed': per block per
    type (n_recon, emb) rows, 'recon_ok': per block per type validity,
    'gt_embed': (n_recon, emb) reconstruction targets (empty without
    embeddings)}.
    """
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown sampled backend: {backend!r}")
    if row_sharding is not None and not isinstance(row_sharding, Mesh):
        raise TypeError("row_sharding must be a stargcn_tpu_torch.parallel."
                        f"Mesh (parallel.make_mesh), not {type(row_sharding)!r}")
    if train and cfg.gcn_dropout > 0.0 and generator is None:
        raise ValueError("train=True with dropout requires a generator")
    if cfg.use_fea_proj and features is None:
        raise ValueError("cfg.use_fea_proj needs features=(user, item)")
    p = _named(params)
    table = ({"user": p["embed_user.weight"], "item": p["embed_item.weight"]}
             if cfg.use_embed else None)
    device = next(iter(p.values())).device
    if isinstance(plan, StackedPlan):
        plan = plan.to(device)
    act = get_activation(cfg.activation)
    cdt = compute_dtype(cfg.compute_dtype) or torch.float32
    use_pallas = backend == "pallas"
    noise = {"user": torch.as_tensor(noise_user, device=device),
             "item": torch.as_tensor(noise_item, device=device)}
    fea = ({"user": features[0], "item": features[1]}
           if cfg.use_fea_proj else None)
    mesh = row_sharding
    data = None if mesh is None else mesh.group("data")
    n_nodes = {"user": cfg.num_users, "item": cfg.num_items}

    def table_lo(t):
        """On a mesh, the first row of table ``t`` this rank holds when
        the table is split over 'model' (None: whole)."""
        if mesh is None:
            return None
        rows = table[t].shape[0]
        if rows * mesh.size("model") != n_nodes[t]:
            return None
        return mesh.index("model") * rows

    def embed_rows(t, ids):
        """The frontier's embedding rows through the noise, whole."""
        lo = table_lo(t)
        if lo is None:
            return _masked_embed_rows(table[t], ids, noise[t])
        return leave(_masked_embed_rows(table[t], ids, noise[t], lo),
                     mesh.group("model"))

    def target_rows(t, ids):
        """The reconstruction targets' embedding rows, whole."""
        lo = table_lo(t)
        if lo is None:
            return take_rows(table[t], ids.clamp_min(0).long())
        return leave(_own_rows(table[t], ids, lo), mesh.group("model"))

    def linear(x, name):
        w = p[f"{name}.weight"]
        return F.linear(x.to(w.dtype), w, p[f"{name}.bias"])

    def fea_rows(t, ids=None):
        """Projected feature rows of ``ids`` (the whole table when
        None)."""
        rows = fea[t] if ids is None else take_rows(fea[t],
                                                    ids.clamp_min(0).long())
        h = linear(act(linear(rows, f"fea_map_{t}_l0")), f"fea_map_{t}_l1")
        return h if ids is None else h * (ids >= 0)[:, None].to(h.dtype)

    ident = identity_frontiers or {}

    def is_ident(t):
        return bool(ident.get(t)) and cfg.self_noise_only

    def level_body(feats_u, feats_i, layer, lvl, gen):
        """One level on this rank's destination rows (all of them
        without a mesh)."""
        def drop(x):
            return _dropout(x, cfg.gcn_dropout, train, gen)

        fin = {"user": feats_u, "item": feats_i}
        out = {}
        for t, s in (("user", "item"), ("item", "user")):
            agg_w = p[f"{layer}.agg_{t}_{s}.weight"]
            agg_b = p[f"{layer}.agg_{t}_{s}.bias"]
            w = p[f"{layer}.out_fc_{t}.weight"]
            b = p[f"{layer}.out_fc_{t}.bias"]
            blk = lvl[t]
            n_dst = blk["idx"].shape[0]
            x = drop(fin[s])
            if mesh is not None:
                lo, hi, rows = padded_split(n_dst, mesh.size("data"),
                                            mesh.index("data"))
                blk = _block_rows(blk, lo, hi, rows)
                agg_b, b = enter(agg_b, data), enter(b, data)
            if use_pallas:
                # The ELL kernel pools pre-projected float32 rows (the
                # reference kernel's contract); the 'xla' default pools
                # raw rows first.
                x = x.float()
                if mesh is not None:
                    x, agg_w = enter(x, data), enter(agg_w, data)
                proj = multi_link_project(
                    x, agg_w, agg_b, ordinal_sharing=cfg.agg_ordinal_sharing)
                pooled = _ell_aggregate(proj, blk, cfg.agg_accum, True)
            else:
                if mesh is not None:
                    x = enter(x, data)
                pooled = _pool_then_project(
                    x, agg_w, agg_b, blk, cfg.agg_accum,
                    cfg.agg_ordinal_sharing, group=data)
            # agg_act then dropout
            if mesh is None:
                pooled = drop(act(pooled))
            else:
                pooled = _dropout_rows(act(pooled), cfg.gcn_dropout, train,
                                       gen, n_dst, lo)
            # The out-FC in the compute dtype, accumulated in float32.
            h = matmul_f32(pooled.to(cdt), w.to(cdt).t(), b_group=data) + b
            out[t] = act(h).to(cdt)  # the next level reads the compute dtype
        return out["user"], out["item"]

    def whole(t, local, n_dst):
        """A level's output for type ``t`` made whole over 'data'."""
        if mesh is None:
            return local
        return gather_rows(local, data)[:n_dst]

    nblocks = len(plan["blocks"])
    pred_ratings, pred_embed, recon_ok = [], [], []
    gt_embed = {}
    if cfg.use_embed:
        gt_embed = {t: target_rows(t, plan["recon_ids"][t])
                    for t in ("user", "item")}
        if cfg.use_fea_proj and cfg.recon_fea:
            gt_embed = {t: torch.cat([gt_embed[t], fea_rows(
                t, plan["recon_ids"][t])], -1) for t in ("user", "item")}
    prev_top_feats = None
    for block_id in range(nblocks):
        pidx = 0 if cfg.use_recurrent else block_id
        f0 = plan["frontiers"][block_id]
        feats = {}
        for t in ("user", "item"):
            parts = []
            if block_id == 0:
                if cfg.use_embed and is_ident(t) and mesh is None:
                    keep = noise[t] != -1
                    parts.append(table[t] * keep[:, None].to(
                        table[t].dtype))
                elif cfg.use_embed:
                    parts.append(embed_rows(t, f0[t]))
                if cfg.use_fea_proj:
                    parts.append(fea_rows(t, None if is_ident(t)
                                          else f0[t]))
            else:
                if is_ident(t):
                    parts.append(prev_top_feats[t])
                else:
                    pos, ok = plan["cross_gather"][block_id][t]
                    parts.append(take_rows(prev_top_feats[t], pos.long())
                                 * ok[:, None])
                if cfg.use_fea_proj and not cfg.recon_fea:
                    # The next block's input joins the decoder's output
                    # and the projected features.
                    parts.append(fea_rows(t, f0[t]))
            feats[t] = (parts[0] if len(parts) == 1
                        else torch.cat(parts, -1)).to(cdt)

        for li, lvl in enumerate(plan["blocks"][block_id]):
            depth = 0 if cfg.gcn_use_recurrent else li
            layer = f"enc_b{pidx}.l{depth}"
            gen = generator if train and cfg.gcn_dropout > 0.0 else None
            if remat and torch.is_grad_enabled():
                replay = _Replay(gen)

                def run(fu, fi, layer=layer, lvl=lvl, replay=replay):
                    return level_body(fu, fi, layer, lvl, replay.next())

                fu, fi = torch.utils.checkpoint.checkpoint(
                    run, feats["user"], feats["item"], use_reentrant=False,
                    preserve_rng_state=False)
            else:
                fu, fi = level_body(feats["user"], feats["item"], layer,
                                    lvl, gen)
            feats = {"user": whole("user", fu, lvl["user"]["idx"].shape[0]),
                     "item": whole("item", fi, lvl["item"]["idx"].shape[0])}

        # rating head, in float32
        pp = plan["pairs_pos"][block_id]
        u_rows = linear(take_rows(feats["user"], pp["user"].long()),
                        f"rating_user_proj_b{pidx}")
        i_rows = linear(take_rows(feats["item"], pp["item"].long()),
                        f"rating_item_proj_b{pidx}")
        pred_ratings.append((u_rows * i_rows).sum(dim=-1))

        if cfg.use_dae:
            mapped = {
                t: linear(act(linear(feats[t],
                                     f"embed_map_b{pidx}_{t}_l0")),
                          f"embed_map_b{pidx}_{t}_l1")
                for t in ("user", "item")}
            rp = plan["recon_pos"][block_id]
            pred_embed.append({
                t: take_rows(mapped[t], rp[t][0].long())
                for t in ("user", "item")})
            recon_ok.append({t: rp[t][1] for t in ("user", "item")})
            prev_top_feats = mapped

    return {"pred_ratings": torch.stack(pred_ratings, dim=0),
            "pred_embed": pred_embed, "recon_ok": recon_ok,
            "gt_embed": gt_embed}


def recon_losses(out):
    """Per block, the sum over node types of the mean squared
    reconstruction error over the valid recon slots: ``(nblocks,)``, or
    ``None`` without reconstructions."""
    if not out["pred_embed"]:
        return None
    rls = []
    for blk, ok in zip(out["pred_embed"], out["recon_ok"]):
        block_loss = 0.0
        for t in ("user", "item"):
            diff = ((blk[t] - out["gt_embed"][t]) ** 2).sum(dim=-1)
            block_loss = block_loss + (diff * ok[t]).sum() \
                / ok[t].sum().clamp_min(1.0)
        rls.append(block_loss)
    return torch.stack(rls)


def sampled_loss(params, cfg, plan, noise_user, noise_item, gt_ratings,
                 pairs_valid, rating_mean, rating_std, recon_lambda,
                 *, train=False, generator=None, backend="xla",
                 features=None, remat=False, row_sharding=None):
    """Rating + reconstruction loss on a sampled plan — the sampled-mode
    twin of the full-graph loss.  Returns ``(loss, (rating_loss,
    pred_ratings))``."""
    out = sampled_forward(params, cfg, plan, noise_user, noise_item,
                          backend=backend, train=train,
                          generator=generator, features=features,
                          remat=remat, row_sharding=row_sharding)
    target = (gt_ratings - rating_mean) / rating_std
    n_valid = pairs_valid.sum().clamp_min(1.0)
    sq = (out["pred_ratings"] - target[None, :]) ** 2
    rating_loss = 0.5 * (sq * pairs_valid[None, :]).sum(dim=1) / n_valid
    loss = rating_loss.sum()
    rls = recon_losses(out)
    if rls is not None:
        loss = loss + recon_lambda * rls.sum()
    return loss, (rating_loss, out["pred_ratings"])
