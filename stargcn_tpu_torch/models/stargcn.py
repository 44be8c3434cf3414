"""STAR-GCN: stacked & reconstructed GCN for rating prediction (PyTorch).

The port of ``stargcn_tpu/models/stargcn.py`` on the ``bitdense`` backend:
embeddings with noise masking -> per block [encoder -> rating head ->
decoder], with the static per-variant bit packs and degree vectors built
outside the forward.  In training the batch's own edges leave the graph as
a batch-sized correction of the degrees and of each aggregation, and
dropout draws from the caller's generator.  Module names match the flax tree
(``embed_user``, ``enc_b{p}``, ``rating_user_proj_b{p}``,
``embed_map_b{p}_{key}_l{0,1}``), so ``convert.params_from_flax`` maps
parameters one to one.

``build_model_config`` and ``resolve_backend`` are the port of
``stargcn_tpu/train/loop.py:40-115``.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
from torch import nn

from stargcn_tpu_torch.models.common import dense, get_activation
from stargcn_tpu_torch.models.layers import (
    BitStatic,
    InnerProductLayer,
    StackedHeterGCNLayers,
)
from stargcn_tpu_torch.ops.bitdense import resolve_impl
from stargcn_tpu_torch.ops.gather import onehot_segment_sum, take_rows


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
    unsupported = {
        "backend other than 'bitdense'": cfg.backend != "bitdense",
        "MODEL.USE_FEA_PROJ": cfg.use_fea_proj,
        "MODEL.USE_EMBED false": not cfg.use_embed,
        "GCN.USE_RECURRENT": cfg.gcn_use_recurrent,
        "GCN.DROPOUT_PER_EDGE": cfg.dropout_per_edge,
        "MODEL.COMPUTE_DTYPE other than float32":
            cfg.compute_dtype != "float32",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet ({', '.join(bad)}): the port trains and "
            "serves the bitdense backend in float32 with learned "
            "embeddings; the other backends come with the slice that "
            "ports ops/agg.py and ops/chunked_ell.py, bfloat16 compute, "
            "per-edge dropout and feature projection with the slices "
            "that port them")


class STARGCN(nn.Module):
    """The full network: embeddings -> [encoder -> heads -> decoder] x B.

    Parameters are initialised from ``generator`` as the JAX package
    initialises its flax tree: ``U(-0.1, 0.1)`` embeddings, Xavier-in
    kernels, zero biases.
    """

    def __init__(self, cfg: STARGCNConfig, generator=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        g = generator
        E = cfg.embed_units
        self.embed_user = nn.Embedding(
            cfg.num_users, E,
            _weight=torch.empty(cfg.num_users, E).uniform_(
                -0.1, 0.1, generator=g))
        self.embed_item = nn.Embedding(
            cfg.num_items, E,
            _weight=torch.empty(cfg.num_items, E).uniform_(
                -0.1, 0.1, generator=g))
        meta = {"user": ["item"], "item": ["user"]}
        n_param_blocks = 1 if cfg.use_recurrent else cfg.nblocks
        for p in range(n_param_blocks):
            in_units, layer_cfgs = E, []
            for au, ou in zip(cfg.agg_units, cfg.out_units):
                layer_cfgs.append(dict(
                    meta=meta, in_units=in_units, agg_units=au,
                    out_units=ou, num_links=cfg.num_links,
                    dropout_rate=cfg.gcn_dropout,
                    agg_ordinal_sharing=cfg.agg_ordinal_sharing,
                    agg_accum=cfg.agg_accum, agg_act=cfg.activation,
                    out_act=cfg.activation))
                in_units = ou
            self.add_module(f"enc_b{p}",
                            StackedHeterGCNLayers(layer_cfgs, generator=g))
            for key in ("user", "item"):
                self.add_module(f"rating_{key}_proj_b{p}", dense(
                    in_units, cfg.gen_rating_mid_map, g))
            if cfg.use_dae:
                for key in ("user", "item"):
                    self.add_module(f"embed_map_b{p}_{key}_l0",
                                    dense(in_units, E, g))
                    self.add_module(f"embed_map_b{p}_{key}_l1",
                                    dense(E, E, g))
        self.gen_ratings = InnerProductLayer()

    def forward(self, noise_user, noise_item, pairs_user, pairs_item,
                variant_degrees, bit_pack, removed_pairs=None, *,
                train: bool = False, generator=None,
                return_rating_feats: bool = False):
        """Forward over one graph variant.

        Args:
          noise_user / noise_item: ``(N,)`` int noise arrays (-1 = mask
            the embedding to zero, else the node's own id), or ``None``.
          pairs_user / pairs_item: ``(B,)`` rating-pair node indices.
          variant_degrees: ``(deg_user, deg_item)`` float degree vectors
            of the variant.
          bit_pack: the variant's ``ops.bitdense.build_bit_pack`` dict.
          removed_pairs: ``(pu, pi, hit, rating)`` of the batch edges to
            take out of the graph for this step: int64 node ids and
            rating levels, ``hit`` float, 1 where the pair is an edge of
            the variant (the lookup is done on the host).
          train: apply dropout (``GCN.DROPOUT``), drawn from
            ``generator``, a ``torch.Generator`` on the model's device.

        Returns a dict with ``pred_ratings`` ``(nblocks, B)``,
        ``pred_embed`` (per block ``{'user', 'item'}`` reconstructed
        embeddings), ``gt_embed`` (the embedding tables) and, with
        ``return_rating_feats``, ``rating_feats``: the last block's
        projected node states, from which any rating is one inner product.
        """
        cfg = self.cfg
        act = get_activation(cfg.activation)
        if removed_pairs is not None and len(removed_pairs) != 4:
            raise NotImplementedError(
                "removed_pairs takes the host-computed (pu, pi, hit, "
                "rating) tuple; the 3-tuple form with the lookup on the "
                "device comes with the pair-lookup keys of graph/device.py")
        deg_u, deg_i = variant_degrees
        if removed_pairs is not None:
            # Static variant degrees corrected for the removed batch edges.
            pu, pi, hit, _ = removed_pairs
            deg_u = deg_u - onehot_segment_sum(hit, pu, cfg.num_users)
            deg_i = deg_i - onehot_segment_sum(hit, pi, cfg.num_items)
        bit_u, bit_i = _build_bit_static_operands(cfg, bit_pack, deg_u,
                                                  deg_i, removed_pairs)
        relations = {("user", "item"): bit_u, ("item", "user"): bit_i}

        gt_embed = {"user": self.embed_user.weight,
                    "item": self.embed_item.weight}
        feats = {
            "user": _masked_embed(self.embed_user.weight, noise_user,
                                  cfg.self_noise_only),
            "item": _masked_embed(self.embed_item.weight, noise_item,
                                  cfg.self_noise_only),
        }
        pred_ratings, pred_embed = [], []
        rating_feats = None
        for block_id in range(cfg.nblocks):
            p = 0 if cfg.use_recurrent else block_id
            output = getattr(self, f"enc_b{p}")(
                feats, relations, train=train, generator=generator)
            user_proj = getattr(self, f"rating_user_proj_b{p}")
            item_proj = getattr(self, f"rating_item_proj_b{p}")
            score = self.gen_ratings(
                user_proj(take_rows(output["user"], pairs_user)),
                item_proj(take_rows(output["item"], pairs_item)))
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


def _build_bit_static_operands(cfg, bit_pack, deg_u, deg_i,
                               removed_info=None):
    """``BitStatic`` operands for both aggregation directions; each
    direction's ``pb`` is the other's forward layout.  ``removed_info``:
    optional ``(pu, pi, hit, rating)`` removed-edge arrays."""
    impl = resolve_impl(cfg.bit_impl)
    scales = _norm_scales(cfg, deg_u, deg_i)
    rem = {"user": (None,) * 4, "item": (None,) * 4}
    if removed_info is not None:
        pu, pi, hit, r = removed_info
        rem = {"user": (pi, pu, r, hit), "item": (pu, pi, r, hit)}

    def make(t):
        p = bit_pack[t]
        rs, rd, rr, rw = rem[t]
        return BitStatic(
            p_fwd=p["pf"], p_bwd=p["pb"],
            dst_scale=scales[t][0], src_scale=scales[t][1],
            rem_src=rs, rem_dst=rd, rem_rating=rr, rem_weight=rw,
            d8_dst=p["pf"].shape[0] // cfg.num_links,
            d8_src=p["pb"].shape[0] // cfg.num_links, impl=impl)

    return make("user"), make("item")


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


def build_model_config(cfg, num_users, num_items,
                       num_links) -> STARGCNConfig:
    """Translate the experiment config tree into a STARGCNConfig."""
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
        bit_impl=cfg.KERNEL.get("BIT_IMPL", "auto"),
        dropout_per_edge=dropout_per_edge,
        self_noise_only=cfg.MODEL.get("SELF_NOISE_ONLY", True),
        compute_dtype=cfg.MODEL.get("COMPUTE_DTYPE", "float32"),
    )
