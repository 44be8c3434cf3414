"""STAR-GCN: stacked & reconstructed GCN for rating prediction (PyTorch).

The port of ``stargcn_tpu/models/stargcn.py`` on the full-graph backends
``bitdense``, ``ell``, ``dense`` and ``xla``: embeddings with noise
masking -> per block [encoder -> rating head -> decoder].  Each backend
aggregates through its own operands, which ``train.loop.GraphVariants``
builds per graph variant: the static bit packs (``bitdense``), the static
chunked-ELL packs (``ell``), the static 0/1 dense adjacency (``dense``),
or the edge arrays under an edge mask (``xla``).  In training the batch's
own edges leave the graph: as a batch-sized correction of the degrees and
of the static operands (``bitdense``, ``ell``, ``dense``), or through the
step's edge mask (``xla``).  Dropout draws from
the caller's generator.  Module names match the flax tree
(``embed_user``, ``enc_b{p}``, ``rating_user_proj_b{p}``,
``embed_map_b{p}_{key}_l{0,1}``), so ``convert.params_from_flax`` maps
parameters one to one.

The model options of the JAX package run too: feature projection
(``MODEL.USE_FEA_PROJ``: a two-layer MLP per node type over the raw
features, ``fea_map_{user,item}_l{0,1}``, joined to the embedding, and with
``MODEL.RECON_FEA`` to the reconstruction target), feature-only input
(``MODEL.USE_EMBED: false``), bf16 compute (``MODEL.COMPUTE_DTYPE``:
parameters float32, operands cast per call, predictions float32), per-edge
dropout (``GCN.DROPOUT_PER_EDGE``, on ``xla``) and one encoder layer reused
at every depth (``GCN.USE_RECURRENT``).  PyTorch states every input width
where flax infers it, so the model takes the raw feature widths
(``feature_dims``) when it projects features.

On a device mesh (``parallel/shardings.py``) the same forward runs on
every rank: embedding tables split by rows (``row_shards``, set by
``GraphShardings.place_params``) are gathered whole, and the operands say
what else is split (an ``EdgeSet`` with a ``shard``, bit packs of
``Shard``s); everything after the aggregations is replicated.

``build_model_config``, ``resolve_backend`` and ``resolve_edge_chunk`` are
the port of ``stargcn_tpu/train/loop.py:40-115``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

from stargcn_tpu_torch.graph.device import EdgeSet
from stargcn_tpu_torch.models.common import (compute_dtype, dense,
                                             get_activation)
from stargcn_tpu_torch.models.layers import (
    BitStatic,
    DenseStatic,
    EllStatic,
    InnerProductLayer,
    Relation,
    StackedHeterGCNLayers,
)
from stargcn_tpu_torch.ops.agg import (
    build_dense_support,
    edge_support,
    masked_degrees,
)
from stargcn_tpu_torch.ops.bitdense import pack_row_interleave, resolve_impl
from stargcn_tpu_torch.ops.gather import onehot_segment_sum, take_rows
from stargcn_tpu_torch.parallel.collectives import (all_reduce_, enter,
                                                    gather_rows)

BACKENDS = ("bitdense", "ell", "dense", "xla")


@dataclasses.dataclass(frozen=True)
class STARGCNConfig:
    """Model hyperparameters (the fields of
    ``stargcn_tpu.models.stargcn.STARGCNConfig`` that the port reads or
    rejects)."""

    num_users: int
    num_items: int
    num_links: int
    use_embed: bool = True
    use_fea_proj: bool = False
    recon_fea: bool = False
    use_dae: bool = True
    nblocks: int = 2
    use_recurrent: bool = False
    activation: str = "leaky"
    fea_mid_map: int = 16
    fea_units: int = 16
    embed_units: int = 64
    gcn_dropout: float = 0.7
    gcn_use_recurrent: bool = False
    agg_norm_symm: bool = True
    agg_units: tuple = (500,)
    agg_accum: str = "stack"
    agg_ordinal_sharing: bool = False
    out_units: tuple = (75,)
    gen_rating_mid_map: int = 64
    backend: str = "bitdense"
    # xla backend: edges per chunk of the aggregation's gather/scatter
    # (bounds its (E, units) message buffer on big graphs); None = all.
    edge_chunk: Optional[int] = None
    # ell backend: slots per virtual row, virtual rows per gather, bf16
    # gathers (KERNEL.ELL_K, ELL_CHUNK, ELL_BF16).
    ell_k: int = 64
    ell_chunk: Optional[int] = 16384
    ell_bf16: bool = False
    bit_impl: str = "auto"
    dropout_per_edge: bool = False
    compute_dtype: str = "float32"
    self_noise_only: bool = True

    def __post_init__(self):
        assert self.use_embed or self.use_fea_proj
        if self.nblocks > 1:
            assert self.use_dae, "stacked blocks require the DAE structure"
        assert len(self.agg_units) == len(self.out_units)


def _check_supported(cfg: STARGCNConfig):
    if cfg.backend not in BACKENDS:
        raise NotImplementedError(
            f"unknown full-graph backend {cfg.backend!r} (ported: "
            f"{', '.join(BACKENDS)})")
    if cfg.dropout_per_edge and cfg.backend != "xla":
        raise NotImplementedError(
            "GCN.DROPOUT_PER_EDGE runs on the flat edge arrays of the xla "
            f"backend only, not on {cfg.backend!r} (build_model_config "
            "forces xla)")
    compute_dtype(cfg.compute_dtype)


def _input_widths(cfg: STARGCNConfig):
    """``(first, later, out_emb)``: the input width of the first block, of
    every later block, and the width of the reconstructed embedding.  The
    projected features join the embedding in the first block's input; in
    later blocks they join the decoder's output unless the decoder
    reconstructs them (``RECON_FEA``)."""
    fea = cfg.fea_units if cfg.use_fea_proj else 0
    out_emb = cfg.embed_units + (fea if cfg.recon_fea else 0)
    first = (cfg.embed_units if cfg.use_embed else 0) + fea
    later = out_emb + (0 if cfg.recon_fea else fea)
    return first, later, out_emb


class STARGCN(nn.Module):
    """The full network: embeddings and projected features -> [encoder ->
    heads -> decoder] x B.

    Parameters are initialised from ``generator`` as the JAX package
    initialises its flax tree: ``U(-0.1, 0.1)`` embeddings, Xavier-in
    kernels, zero biases.  ``feature_dims`` ``(user, item)`` are the raw
    feature widths, read with ``cfg.use_fea_proj`` (``feature_dims``
    gives them for a data iterator).
    """

    def __init__(self, cfg: STARGCNConfig, generator=None,
                 feature_dims=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.cdt = compute_dtype(cfg.compute_dtype)
        g = generator
        E = cfg.embed_units
        first, later, out_emb = _input_widths(cfg)
        depth = len(cfg.agg_units)
        if cfg.use_recurrent and cfg.nblocks > 1 and first != later:
            raise ValueError(
                "MODEL.USE_RECURRENT shares one block's parameters, so "
                f"every block's input must be {first} wide, not {later}")
        if cfg.use_embed:
            self.embed_user = nn.Embedding(
                cfg.num_users, E,
                _weight=torch.empty(cfg.num_users, E).uniform_(
                    -0.1, 0.1, generator=g))
            self.embed_item = nn.Embedding(
                cfg.num_items, E,
                _weight=torch.empty(cfg.num_items, E).uniform_(
                    -0.1, 0.1, generator=g))
        if cfg.use_fea_proj:
            if feature_dims is None:
                raise ValueError("MODEL.USE_FEA_PROJ needs feature_dims="
                                 "(user, item): the raw feature widths")
            for key, dim in zip(("user", "item"), feature_dims):
                self.add_module(f"fea_map_{key}_l0",
                                dense(int(dim), cfg.fea_mid_map, g))
                self.add_module(f"fea_map_{key}_l1",
                                dense(cfg.fea_mid_map, cfg.fea_units, g))
        meta = {"user": ["item"], "item": ["user"]}
        n_param_blocks = 1 if cfg.use_recurrent else cfg.nblocks
        units = list(zip(cfg.agg_units, cfg.out_units))
        if cfg.gcn_use_recurrent:
            units = units[:1]
        for p in range(n_param_blocks):
            in_units, layer_cfgs = (first if p == 0 else later), []
            if cfg.gcn_use_recurrent and depth > 1 \
                    and cfg.out_units[0] != in_units:
                raise ValueError(
                    f"GCN.USE_RECURRENT reuses one layer at all {depth} "
                    f"depths, so its output width (GCN.OUT.UNITS[0] = "
                    f"{cfg.out_units[0]}) must equal its input width "
                    f"({in_units})")
            for au, ou in units:
                layer_cfgs.append(dict(
                    meta=meta, in_units=in_units, agg_units=au,
                    out_units=ou, num_links=cfg.num_links,
                    dropout_rate=cfg.gcn_dropout,
                    agg_ordinal_sharing=cfg.agg_ordinal_sharing,
                    agg_accum=cfg.agg_accum, agg_act=cfg.activation,
                    out_act=cfg.activation, backend=cfg.backend,
                    edge_chunk=cfg.edge_chunk,
                    dropout_per_edge=cfg.dropout_per_edge, dtype=self.cdt))
                in_units = ou
            self.add_module(f"enc_b{p}", StackedHeterGCNLayers(
                layer_cfgs, generator=g,
                recurrent_layer_num=depth if cfg.gcn_use_recurrent
                else None))
            for key in ("user", "item"):
                self.add_module(f"rating_{key}_proj_b{p}", dense(
                    in_units, cfg.gen_rating_mid_map, g, self.cdt))
            if cfg.use_dae:
                for key in ("user", "item"):
                    self.add_module(f"embed_map_b{p}_{key}_l0",
                                    dense(in_units, out_emb, g, self.cdt))
                    self.add_module(f"embed_map_b{p}_{key}_l1",
                                    dense(out_emb, out_emb, g, self.cdt))
        self.gen_ratings = InnerProductLayer()
        # Parameter name -> parallel.shardings.Shard of the embedding
        # tables split by rows over a mesh ('model'); empty on one process.
        self.row_shards = {}

    def embedding_table(self, key: str) -> torch.Tensor:
        """The whole ``(N, E)`` embedding table of ``key`` ('user' or
        'item'): the parameter, or on a mesh the rows of every rank
        gathered (``collectives.gather_rows``)."""
        w = getattr(self, f"embed_{key}").weight
        shard = self.row_shards.get(f"embed_{key}.weight")
        if shard is None:
            return w
        return gather_rows(w, shard.group)

    def project_features(self, user_features, item_features):
        """``{'user', 'item'}``: the raw features through their two-layer
        MLPs (float32)."""
        if user_features is None or item_features is None:
            raise ValueError("MODEL.USE_FEA_PROJ needs user_features= and "
                             "item_features=")
        act = get_activation(self.cfg.activation)
        return {key: getattr(self, f"fea_map_{key}_l1")(act(getattr(
                    self, f"fea_map_{key}_l0")(fea)))
                for key, fea in (("user", user_features),
                                 ("item", item_features))}

    def forward(self, noise_user, noise_item, pairs_user, pairs_item,
                variant_degrees, operands, removed_pairs=None, *,
                graph=None, train: bool = False, generator=None,
                return_rating_feats: bool = False, user_features=None,
                item_features=None, batch_group=None):
        """Forward over one graph variant.

        Args:
          noise_user / noise_item: ``(N,)`` int noise arrays (-1 = mask
            the embedding to zero, else the node's own id), or ``None``.
          pairs_user / pairs_item: ``(B,)`` rating-pair node indices.
          variant_degrees: ``(deg_user, deg_item)`` float degree vectors
            of the variant, read by ``bitdense``, ``ell`` and by ``dense``
            with an adjacency; elsewhere the degrees come from the edge
            mask.
          operands: what the backend aggregates through
            (``train.loop.GraphVariants.operands``): the variant's
            ``ops.bitdense.build_bit_pack`` dict (``bitdense``); its
            ``ops.chunked_ell.build_ell_pack`` dict (``ell``); its
            ``(R, Nu, Ni)`` 0/1 adjacency (``dense``); or a
            ``graph.device.EdgeSet`` of the edge arrays and the step's
            edge mask (``xla``, and ``dense`` without an adjacency, which
            then scatters a dense support every call).
          removed_pairs: the batch edges to take out of the graph for this
            step, read by ``bitdense``, ``ell`` and by ``dense`` with an
            adjacency:
            ``(pu, pi, hit, rating)`` from the host lookup (int64 node ids
            and rating levels, ``hit`` float, 1 where the pair is an edge
            of the variant), or ``(pu, pi, valid)``, looked up on the
            device through the pair keys of ``graph``.  With an
            ``EdgeSet`` the removal is in its mask
            (``BipartiteGraphData.edge_mask_from_pairs``), as in the JAX
            package, and ``removed_pairs`` is not read.
          graph: the ``BipartiteGraphData``, for the 3-tuple lookup.
          train: apply dropout (``GCN.DROPOUT``), drawn from
            ``generator``, a ``torch.Generator`` on the model's device.
          user_features / item_features: the raw feature matrices, read
            with ``use_fea_proj`` (never noise-masked).
          batch_group: on a device mesh whose 'data' axis splits the
            pairs, its process group: each block's rating projection then
            runs on every node and enters the pairs' gather through
            ``collectives.enter``, so the ranks' partial cotangents are
            summed into the node states there and every step before it
            (and every parameter's gradient) is whole on every rank.

        Returns a dict with ``pred_ratings`` ``(nblocks, B)`` (float32),
        ``pred_embed`` (per block ``{'user', 'item'}`` reconstructed
        embeddings, in the compute dtype), ``gt_embed`` (the
        reconstruction targets: the embedding tables, joined by the
        projected features with ``recon_fea``; empty without embeddings)
        and, with ``return_rating_feats``, ``rating_feats``: the last
        block's projected node states, from which any rating is one inner
        product.
        """
        cfg = self.cfg
        act = get_activation(cfg.activation)
        edges = operands if isinstance(operands, EdgeSet) else None
        if edges is not None and cfg.backend == "bitdense":
            raise ValueError("the bitdense backend reads a bit pack, not "
                             "an EdgeSet")
        if edges is not None and cfg.backend == "ell":
            raise ValueError("the ell backend reads its chunked-ELL packs, "
                             "not an EdgeSet")
        if edges is None and cfg.backend == "xla":
            raise ValueError("the xla backend reads an EdgeSet (the edge "
                             "arrays and the step's edge mask)")
        if edges is not None:
            relations = _edge_relations(cfg, edges)
        else:
            removed = _removed_info(removed_pairs, graph)
            deg_u, deg_i = variant_degrees
            if removed is not None:
                # Static variant degrees corrected for the removed batch
                # edges.
                pu, pi, hit, _ = removed
                deg_u = deg_u - onehot_segment_sum(hit, pu, cfg.num_users)
                deg_i = deg_i - onehot_segment_sum(hit, pi, cfg.num_items)
            if cfg.backend == "bitdense":
                static_u, static_i = _build_bit_static_operands(
                    cfg, operands, deg_u, deg_i, removed)
                relations = {
                    ("user", "item"): Relation(cfg.num_links,
                                               bit_static=static_u),
                    ("item", "user"): Relation(cfg.num_links,
                                               bit_static=static_i)}
            elif cfg.backend == "ell":
                static_u, static_i = _build_ell_static_operands(
                    cfg, operands, deg_u, deg_i, removed)
                relations = {
                    ("user", "item"): Relation(cfg.num_links,
                                               ell_static=static_u),
                    ("item", "user"): Relation(cfg.num_links,
                                               ell_static=static_i)}
            else:
                static_u, static_i = _build_dense_static_operands(
                    cfg, operands, deg_u, deg_i, removed)
                relations = {
                    ("user", "item"): Relation(cfg.num_links,
                                               dense_static=static_u),
                    ("item", "user"): Relation(cfg.num_links,
                                               dense_static=static_i)}

        gt_embed, feats = {}, {}
        if cfg.use_embed:
            gt_embed = {"user": self.embedding_table("user"),
                        "item": self.embedding_table("item")}
            feats = {
                "user": _masked_embed(gt_embed["user"], noise_user,
                                      cfg.self_noise_only),
                "item": _masked_embed(gt_embed["item"], noise_item,
                                      cfg.self_noise_only),
            }
        fea_proj = {}
        if cfg.use_fea_proj:
            fea_proj = self.project_features(user_features, item_features)
            feats = ({k: torch.cat([feats[k], fea_proj[k]], -1)
                      for k in feats} if cfg.use_embed else dict(fea_proj))
            if cfg.recon_fea:
                gt_embed = {k: torch.cat([gt_embed[k], fea_proj[k]], -1)
                            for k in gt_embed}
        if self.cdt is not None:
            feats = {k: v.to(self.cdt) for k, v in feats.items()}
        pred_ratings, pred_embed = [], []
        rating_feats = None
        for block_id in range(cfg.nblocks):
            p = 0 if cfg.use_recurrent else block_id
            output = getattr(self, f"enc_b{p}")(
                feats, relations, train=train, generator=generator)
            user_proj = getattr(self, f"rating_user_proj_b{p}")
            item_proj = getattr(self, f"rating_item_proj_b{p}")
            if batch_group is None:
                score = self.gen_ratings(
                    user_proj(take_rows(output["user"], pairs_user)),
                    item_proj(take_rows(output["item"], pairs_item)))
            else:
                score = self.gen_ratings(
                    take_rows(enter(user_proj(output["user"]), batch_group),
                              pairs_user),
                    take_rows(enter(item_proj(output["item"]), batch_group),
                              pairs_item))
            pred_ratings.append(score[:, 0])
            if return_rating_feats and block_id == cfg.nblocks - 1:
                rating_feats = {"user": user_proj(output["user"]),
                                "item": item_proj(output["item"])}
            if cfg.use_dae:
                mapped = {}
                for key in ("user", "item"):
                    l0 = getattr(self, f"embed_map_b{p}_{key}_l0")
                    l1 = getattr(self, f"embed_map_b{p}_{key}_l1")
                    mapped[key] = l1(act(l0(output[key])))
                pred_embed.append(mapped)
                feats = mapped
                if cfg.use_fea_proj and not cfg.recon_fea:
                    feats = {k: torch.cat([v, fea_proj[k].to(v.dtype)], -1)
                             for k, v in feats.items()}

        out = {"pred_ratings": torch.stack(pred_ratings, dim=0),
               "pred_embed": pred_embed, "gt_embed": gt_embed}
        if return_rating_feats:
            out["rating_feats"] = rating_feats
        return out


def _norm_scales(cfg, deg_u, deg_i):
    """Separable degree-scale vectors per direction: ``{target_type:
    (dst_scale, src_scale)}`` with ``support = dst_scale * src_scale``
    (symmetric norm) or ``1/d_dst``."""
    zero = deg_u.new_zeros(())
    if cfg.agg_norm_symm:
        s_u = torch.where(deg_u > 0, torch.rsqrt(deg_u.clamp_min(1e-12)),
                          zero)
        s_i = torch.where(deg_i > 0, torch.rsqrt(deg_i.clamp_min(1e-12)),
                          zero)
        return {"user": (s_u, s_i), "item": (s_i, s_u)}
    inv_u = torch.where(deg_u > 0, 1.0 / deg_u.clamp_min(1e-12), zero)
    inv_i = torch.where(deg_i > 0, 1.0 / deg_i.clamp_min(1e-12), zero)
    return {"user": (inv_u, torch.ones_like(deg_i)),
            "item": (inv_i, torch.ones_like(deg_u))}


def _removed_info(removed_pairs, graph):
    """``removed_pairs`` as the 4-tuple ``(pu, pi, hit, rating)``: a
    3-tuple ``(pu, pi, valid)`` is looked up through ``graph``'s sorted
    pair keys."""
    if removed_pairs is None or len(removed_pairs) == 4:
        return removed_pairs
    if graph is None:
        raise ValueError(
            "the 3-tuple removed_pairs (pu, pi, valid) is looked up "
            "through the graph's pair keys: pass graph=, or the "
            "host-computed (pu, pi, hit, rating) tuple")
    pu, pi, valid = removed_pairs
    pos, found = graph.lookup_pairs(pu, pi)
    hit = (found & (valid > 0)).to(torch.float32)
    rating = graph.edge_rating.index_select(
        0, graph.lookup_perm[pos].long()).long()
    return pu, pi, hit, rating


def _edge_relations(cfg, edges: EdgeSet):
    """Relations over the edge arrays: degrees and per-edge support of the
    masked graph, and for ``dense`` the per-step dense support (one tensor,
    shared transposed between the two directions under the symmetric
    norm).  On an edge shard the degrees are the ranks' partial sums added
    over the shard's group (no gradient flows through them)."""
    g = edges.graph
    shard = edges.shard
    if shard is not None and cfg.backend == "dense":
        raise ValueError("on a mesh the dense backend reads its adjacency, "
                         "not an edge shard")
    mask = edges.mask * g.edge_pad_mask
    deg_u, deg_i = masked_degrees(g.edge_user, g.edge_item, mask,
                                  g.num_users, g.num_items)
    if shard is not None:
        deg_u, deg_i = (all_reduce_(d.detach().clone(), shard.group)
                        for d in (deg_u, deg_i))
    if cfg.agg_norm_symm:
        sup_u = sup_i = edge_support(deg_u, deg_i, g.edge_user, g.edge_item,
                                     mask, symm=True)
    else:
        # target user <- item: the support is 1/d_user.
        sup_u = edge_support(deg_u, deg_i, g.edge_user, g.edge_item, mask,
                             symm=False)
        sup_i = edge_support(deg_i, deg_u, g.edge_item, g.edge_user, mask,
                             symm=False)
    dense_u = dense_i = None
    transposed = False
    if cfg.backend == "dense":
        # The support depends on the mask only, so no gradient flows
        # through the scatter.
        dense_u = build_dense_support(
            g.edge_item, g.edge_user, g.edge_rating, sup_u, g.num_links,
            g.num_users, g.num_items).detach()
        if cfg.agg_norm_symm:
            dense_i, transposed = dense_u, True
        else:
            dense_i = build_dense_support(
                g.edge_user, g.edge_item, g.edge_rating, sup_i, g.num_links,
                g.num_items, g.num_users).detach()
    return {
        ("user", "item"): Relation(
            g.num_links, edge_src=g.edge_item, edge_dst=g.edge_user,
            edge_rating=g.edge_rating, support=sup_u,
            dense_support=dense_u, shard=shard),
        ("item", "user"): Relation(
            g.num_links, edge_src=g.edge_user, edge_dst=g.edge_item,
            edge_rating=g.edge_rating, support=sup_i,
            dense_support=dense_i, dense_transposed=transposed,
            shard=shard),
    }


def _build_dense_static_operands(cfg, dense_adj, deg_u, deg_i,
                                 removed_info=None):
    """``DenseStatic`` operands for both directions over the ``(R, Nu,
    Ni)`` variant adjacency; the item direction reads it transposed.  A
    removal is folded into the adjacency as one scalar scatter,
    ``adj - delta``, 0/1-exact in bf16, so every aggregation and its
    gradient stay one product."""
    scales = _norm_scales(cfg, deg_u, deg_i)
    adj = dense_adj.detach()
    if removed_info is not None:
        pu, pi, hit, r = removed_info
        R, nu, ni = adj.shape
        idx = (r.long() * nu + pu.long()) * ni + pi.long()
        adj = adj.clone()
        adj.view(-1).index_add_(0, idx, -hit.to(adj.dtype))
    return (DenseStatic(adj=adj, dst_scale=scales["user"][0],
                        src_scale=scales["user"][1], transposed=False),
            DenseStatic(adj=adj, dst_scale=scales["item"][0],
                        src_scale=scales["item"][1], transposed=True))


def _build_bit_static_operands(cfg, bit_pack, deg_u, deg_i,
                               removed_info=None):
    """``BitStatic`` operands for both aggregation directions; each
    direction's ``pb`` is the other's forward layout.  ``removed_info``:
    optional ``(pu, pi, hit, rating)`` removed-edge arrays."""
    impl = resolve_impl(cfg.bit_impl)
    want = pack_row_interleave(impl)
    if bit_pack.get("row_interleave", 0) != want:
        raise ValueError(
            f"bit_impl {cfg.bit_impl!r} reads packs with row_interleave="
            f"{want}, but these were built with "
            f"{bit_pack.get('row_interleave', 0)}")
    scales = _norm_scales(cfg, deg_u, deg_i)
    rem = {"user": (None,) * 4, "item": (None,) * 4}
    if removed_info is not None:
        pu, pi, hit, r = removed_info
        rem = {"user": (pi, pu, r, hit), "item": (pu, pi, r, hit)}

    def make(t):
        p = bit_pack[t]
        rs, rd, rr, rw = rem[t]
        pf, pb = p["pf"], p["pb"]
        # On a mesh the layouts are parallel.shardings.Shard placements,
        # each split by rows or replicated on its own.
        split = [getattr(q, "sharded", False) for q in (pf, pb)]
        rows_f, rows_b = (q.global_shape[0] if hasattr(q, "global_shape")
                          else q.shape[0] for q in (pf, pb))
        return BitStatic(
            p_fwd=getattr(pf, "local", pf), p_bwd=getattr(pb, "local", pb),
            dst_scale=scales[t][0], src_scale=scales[t][1],
            rem_src=rs, rem_dst=rd, rem_rating=rr, rem_weight=rw,
            d8_dst=rows_f // cfg.num_links, d8_src=rows_b // cfg.num_links,
            impl=impl, fwd_group=pf.group if split[0] else None,
            bwd_group=pb.group if split[1] else None,
            fwd_row0=pf.offset if split[0] else 0,
            bwd_row0=pb.offset if split[1] else 0)

    return make("user"), make("item")


def _build_ell_static_operands(cfg, ell_pack, deg_u, deg_i,
                               removed_info=None):
    """``EllStatic`` operands for both aggregation directions.
    ``ell_pack`` holds each direction's arrays (dst = that type); a
    direction's backward arrays are the other direction's forward ones
    (the same edges seen from the other side).  ``removed_info``:
    optional ``(pu, pi, hit, rating)`` removed-edge arrays."""
    scales = _norm_scales(cfg, deg_u, deg_i)
    rem = {"user": (None,) * 4, "item": (None,) * 4}
    if removed_info is not None:
        pu, pi, hit, r = removed_info
        rem = {"user": (pi, pu, r, hit), "item": (pu, pi, r, hit)}

    def make(t, other):
        p, q = ell_pack[t], ell_pack[other]
        rs, rd, rr, rw = rem[t]
        return EllStatic(
            f_idx=p["idx"], f_rat=p["rat"], f_row=p["row"],
            b_idx=q["idx"], b_rat=q["rat"], b_row=q["row"],
            dst_scale=scales[t][0], src_scale=scales[t][1],
            rem_src=rs, rem_dst=rd, rem_rating=rr, rem_weight=rw,
            chunk=cfg.ell_chunk, bf16=cfg.ell_bf16)

    return make("user", "item"), make("item", "user")


def feature_dims(data_iter):
    """``(user, item)`` raw feature widths of a data iterator's graph."""
    f = data_iter.all_graph.features
    return (int(np.shape(f[data_iter.name_user])[1]),
            int(np.shape(f[data_iter.name_item])[1]))


def _masked_embed(table, noise, self_noise_only: bool = True):
    """Embeddings through the noise array (-1 -> zero vector)."""
    if noise is None:
        return table
    keep = (noise != -1)[:, None].to(table.dtype)
    if self_noise_only:
        # noise[i] in {-1, i}: a row mask over the table suffices.
        return table * keep
    ids = torch.where(noise != -1, noise, torch.zeros_like(noise))
    return table[ids.long()] * keep


# ------------------------ config translation ------------------------


def resolve_backend(backend: str, num_links, num_users, num_items) -> str:
    """'auto' picks the dense adjacency when the (R, Nu, Ni) support
    tensor has at most 150M entries, else the bit-packed backend.
    'pallas' (the sampled mode's ELL kernels) resolves to 'xla' for the
    full-graph model."""
    if backend == "pallas":
        logging.warning("KERNEL.BACKEND 'pallas' applies to the sampled "
                        "mode; full-graph training uses 'xla'.")
        return "xla"
    if backend != "auto":
        return backend
    entries = num_links * num_users * num_items
    return "dense" if entries <= 150_000_000 else "bitdense"


def resolve_edge_chunk(backend, num_edges, agg_units,
                       budget_mb: int = 1500):
    """Edges per chunk of the ``xla`` aggregation, so that its ``(chunk,
    units)`` float32 message buffer stays within ``budget_mb``
    (``KERNEL.XLA_MSG_BUDGET_MB``); None where all edges fit, on other
    backends, or without an edge count.  Chunks are multiples of 65,536
    edges."""
    if backend != "xla" or not num_edges:
        return None
    units = max(agg_units)
    budget = int(budget_mb) * 10**6
    if num_edges * units * 4 <= budget:
        return None
    chunk = max(budget // (units * 4), 65536)
    return (chunk // 65536) * 65536


def build_model_config(cfg, num_users, num_items, num_links,
                       num_edges=None) -> STARGCNConfig:
    """Translate the experiment config tree into a STARGCNConfig;
    ``num_edges`` sizes the ``xla`` backend's edge chunks."""
    backend = resolve_backend(cfg.KERNEL.BACKEND, num_links,
                              num_users, num_items)
    dropout_per_edge = cfg.GCN.get("DROPOUT_PER_EDGE", False)
    if dropout_per_edge and backend != "xla":
        logging.warning("GCN.DROPOUT_PER_EDGE forces the flat-edge "
                        "(xla) backend (was %r)", backend)
        backend = "xla"
    return STARGCNConfig(
        num_users=num_users, num_items=num_items, num_links=num_links,
        use_embed=cfg.MODEL.USE_EMBED,
        use_fea_proj=cfg.MODEL.USE_FEA_PROJ,
        recon_fea=cfg.MODEL.RECON_FEA,
        use_dae=cfg.MODEL.USE_DAE,
        nblocks=cfg.MODEL.NBLOCKS,
        use_recurrent=cfg.MODEL.USE_RECURRENT,
        activation=cfg.MODEL.ACTIVATION,
        embed_units=cfg.EMBED.UNITS,
        gcn_dropout=cfg.GCN.DROPOUT,
        gcn_use_recurrent=cfg.GCN.USE_RECURRENT,
        agg_norm_symm=cfg.GCN.AGG.NORM_SYMM,
        agg_units=tuple(cfg.GCN.AGG.UNITS),
        agg_accum=cfg.GCN.AGG.ACCUM,
        agg_ordinal_sharing=cfg.GCN.AGG.get("ORDINAL_SHARING", False),
        out_units=tuple(cfg.GCN.OUT.UNITS),
        gen_rating_mid_map=cfg.GEN_RATING.MID_MAP,
        backend=backend,
        fea_mid_map=cfg.FEA.MID_MAP,
        fea_units=cfg.FEA.UNITS,
        edge_chunk=resolve_edge_chunk(
            backend, num_edges, tuple(cfg.GCN.AGG.UNITS),
            budget_mb=cfg.KERNEL.get("XLA_MSG_BUDGET_MB", 1500)),
        ell_k=cfg.KERNEL.get("ELL_K", 64),
        ell_chunk=cfg.KERNEL.get("ELL_CHUNK", 16384),
        ell_bf16=cfg.KERNEL.get("ELL_BF16", False),
        bit_impl=cfg.KERNEL.get("BIT_IMPL", "auto"),
        dropout_per_edge=dropout_per_edge,
        self_noise_only=cfg.MODEL.get("SELF_NOISE_ONLY", True),
        compute_dtype=cfg.MODEL.get("COMPUTE_DTYPE", "float32"),
    )
