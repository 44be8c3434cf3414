"""STAR-GCN, written from its equations in plain float32 PyTorch.

Notation: users ``u``, items ``i``, rating levels ``r``; ``A_r`` the 0/1
user-item adjacency at level ``r`` of the graph a forward runs on; ``d`` the
node degrees over all levels of that graph; ``s_n = 1 / sqrt(d_n)`` (0
where ``d_n`` is 0), so an edge's weight is ``c_ui = s_u s_i``.
``leaky(x) = x`` for ``x >= 0``, else ``0.1 x``.

* Input: the embedding tables ``E_u``, ``E_i``, a row set to zero where
  the noise array holds -1.
* A block ``b`` is one graph-convolution layer, then the heads.  Into
  target type ``t`` from source type ``s``:
  ``h_t = drop(leaky(acc_r sum_s c_ts A_r[t, s] (drop(x_s) W_r + b_r)))``,
  ``acc`` the sum over levels ('sum') or their concatenation ('stack');
  ``o_t = leaky(h_t W_out_t^T + b_out_t)``.  Dropout (training only) keeps
  an element with probability ``1 - p`` and scales it by ``1 / (1 - p)``;
  it never falls on the bias.
* Rating head: ``pred_b(u, i) = <P_u(o_u[u]), P_i(o_i[i])>``, ``P`` affine
  maps to ``gen_rating_mid_map`` units.
* Reconstruction (DAE): ``e_t = l1(leaky(l0(o_t)))``; the next block's
  input is ``e``.
* Loss: ``sum_b 0.5 mean_pairs (pred_b - (r - mean) / std)^2 + lambda
  sum_b sum_t sum_{n in M_t} ||e_t[n] - E_t[n]||^2 / |M_t|`` over the
  reconstruction targets ``M_t``; ``mean`` and ``std`` of the training
  ratings.

The adjacency's operand (``ModelSpec.operand``) is the one place the
system computes below float32, and the reference rounds it where the
system states it does; everything else is float32:

* ``'float32'``: no rounding;
* ``'dense_bf16'`` (the ``dense`` path): the product with the 0/1
  adjacency contracts in the adjacency's dtype, bf16, with a float32
  sum: each level's projection ``s_s (x_s W_r + b_r)`` is rounded to bf16
  before the sum over edges, and its cotangent (a float32 sum over the
  edges) is rounded to bf16 on its way back;
* ``'bit_bf16'`` (the ``bitdense`` path on a card): the bit walks pool
  the scaled source rows ``s_s [x_s, 1]`` from a bf16 table over every
  edge of the graph the walks hold (the training graph), summing in
  float32; the batch's own edges are then taken out again in float32
  from the unrounded rows; in the backward each element of the pooled
  table's cotangent is rounded to bf16 before the float32 sum over edges.

Parameters carry the names of the published module tree (``embed_user``,
``enc_b{b}.l0.agg_{t}_{s}``, ``out_fc_{t}``, ``rating_{t}_proj_b{b}``,
``embed_map_b{b}_{t}_l{0,1}``), affine weights as ``(out, in)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

TYPES = (("user", "item"), ("item", "user"))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The published hyperparameters the reference reads."""

    num_users: int
    num_items: int
    num_links: int
    nblocks: int
    embed_units: int
    agg_units: int
    agg_accum: str
    out_units: int
    mid_units: int
    dropout: float
    recon_lambda: float
    use_dae: bool
    operand: str = "float32"

    @staticmethod
    def from_yaml(y: dict, num_users, num_items, num_links,
                  operand="float32"):
        m, g = y["MODEL"], y["GCN"]
        unsupported = [
            k for k, ok in (
                ("MODEL.USE_EMBED", m["USE_EMBED"]),
                ("MODEL.USE_FEA_PROJ", not m["USE_FEA_PROJ"]),
                ("MODEL.USE_RECURRENT", not m["USE_RECURRENT"]),
                ("GCN.USE_RECURRENT", not g["USE_RECURRENT"]),
                ("GCN.AGG.NORM_SYMM", g["AGG"]["NORM_SYMM"]),
                ("GCN.TYPE", g["TYPE"] == "gcn"),
                ("MODEL.ACTIVATION", m["ACTIVATION"] == "leaky"),
                ("one layer a block", len(g["AGG"]["UNITS"]) == 1
                 and len(g["OUT"]["UNITS"]) == 1),
                ("EMBED.P_ZERO", y["EMBED"]["P_ZERO"] == 0.0),
                ("TRAIN.OPTIMIZER", y["TRAIN"]["OPTIMIZER"] == "adam"))
            if not ok]
        if unsupported:
            raise NotImplementedError(
                f"the reference does not model {unsupported}")
        return ModelSpec(
            num_users=num_users, num_items=num_items, num_links=num_links,
            nblocks=m["NBLOCKS"], embed_units=y["EMBED"]["UNITS"],
            agg_units=g["AGG"]["UNITS"][0], agg_accum=g["AGG"]["ACCUM"],
            out_units=g["OUT"]["UNITS"][0],
            mid_units=y["GEN_RATING"]["MID_MAP"], dropout=g["DROPOUT"],
            recon_lambda=m["RECON_LAMBDA"], use_dae=m["USE_DAE"],
            operand=operand)


def param_spec(s: ModelSpec):
    """``[(name, shape, init)]``: ``init`` is ``('uniform', limit)``
    (embeddings ``0.1``; weights ``sqrt(3 / fan_in)``) or ``('zeros',)``."""
    E, R = s.embed_units, s.num_links
    link = s.agg_units // R if s.agg_accum == "stack" else s.agg_units
    out_in = s.agg_units
    spec = [("embed_user.weight", (s.num_users, E), ("uniform", 0.1)),
            ("embed_item.weight", (s.num_items, E), ("uniform", 0.1))]

    def affine(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in),
                     ("uniform", math.sqrt(3.0 / n_in))))
        spec.append((f"{name}.bias", (n_out,), ("zeros",)))

    for b in range(s.nblocks):
        for t, src in TYPES:
            name = f"enc_b{b}.l0.agg_{t}_{src}"
            spec.append((f"{name}.weight", (R, E, link),
                         ("uniform", math.sqrt(3.0 / (R * E)))))
            spec.append((f"{name}.bias", (R, link), ("zeros",)))
            affine(f"enc_b{b}.l0.out_fc_{t}", out_in, s.out_units)
        for t in ("user", "item"):
            affine(f"rating_{t}_proj_b{b}", s.out_units, s.mid_units)
        if s.use_dae:
            for t in ("user", "item"):
                affine(f"embed_map_b{b}_{t}_l0", s.out_units, E)
                affine(f"embed_map_b{b}_{t}_l1", E, E)
    return spec


def make_params(s: ModelSpec, seed: int, device) -> dict:
    """The weights of ``param_spec`` drawn on ``device`` from ``seed`` in
    one call: one uniform vector, cut and scaled per leaf."""
    spec = param_spec(s)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = (u[at:at + n] * init[1]).reshape(shape)
        at += n
    return out


def leaky(x):
    return torch.where(x >= 0, x, 0.1 * x)


def affine(p, name, x):
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


class Graph:
    """The edge arrays on the device: users, items, level indices, and the
    sorted pair keys ``u * num_items + i`` of a subset of the edges."""

    def __init__(self, user, item, level, num_users, num_items, num_links,
                 device):
        self.user = torch.as_tensor(user, device=device).long()
        self.item = torch.as_tensor(item, device=device).long()
        self.level = torch.as_tensor(level, device=device).long()
        self.num_users, self.num_items = num_users, num_items
        self.num_links = num_links

    def keys(self):
        return self.user * self.num_items + self.item

    def find(self, edges, pu, pi):
        """For pairs ``(pu, pi)``: the index into the edge subset
        ``edges`` (sorted by key) of each pair, and whether it is there."""
        k = self.keys()[edges]
        order = torch.argsort(k)
        ks = k[order]
        q = pu.long() * self.num_items + pi.long()
        pos = torch.searchsorted(ks, q).clamp_max(ks.numel() - 1)
        hit = ks[pos] == q
        return edges[order[pos]], hit


def bf16_value(x):
    """``x`` rounded to bf16 (nearest even) in the forward; its gradient
    passes unrounded."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


class _Bf16Cotangent(torch.autograd.Function):
    """The identity, whose cotangent is rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def pool(rows, src, slot, n_slots):
    """``out[k] = sum_{e: slot_e = k} rows[src_e]``, float32."""
    return rows.new_zeros(n_slots, rows.shape[1]).index_add(
        0, slot, rows.index_select(0, src))


def aggregate(p, name, x_src, g: Graph, keep, static, scales, into_user,
              s: ModelSpec):
    """``sum_r c A_r (x_src W_r + b_r)`` ('sum') or its levels side by side
    ('stack'), into users (``into_user``) or items, over the edges
    ``keep``; ``static`` are the edges of the graph the system's
    aggregation holds (``keep`` and the batch's removed edges), and
    ``scales`` the ``(s_dst, s_src)`` vectors."""
    src_all = g.item if into_user else g.user
    dst_all = g.user if into_user else g.item
    n_dst = s.num_users if into_user else s.num_items
    R = s.num_links
    s_dst, s_src = scales
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if s.operand == "dense_bf16":
        # Each level's projection of every source row, scaled and rounded.
        proj = torch.einsum("sf,rfu->rsu", x_src, w) + b[:, None, :]
        scaled = (proj * s_src[None, :, None]).to(torch.bfloat16).float()
        src, dst, lvl = src_all[keep], dst_all[keep], g.level[keep]
        h = pool(scaled.reshape(R * x_src.shape[0], -1),
                 lvl * x_src.shape[0] + src, dst * R + lvl, n_dst * R)
        h = h.reshape(n_dst, R, -1) * s_dst[:, None, None]
    else:
        x1 = torch.cat([x_src, x_src.new_ones(x_src.shape[0], 1)], 1) \
            * s_src[:, None]
        if s.operand == "bit_bf16":
            on = static
            rows = bf16_value(x1)
        elif s.operand == "float32":
            on, rows = keep, x1
        else:
            raise ValueError(f"unknown operand: {s.operand!r}")
        pooled = pool(rows, src_all[on], dst_all[on] * R + g.level[on],
                      n_dst * R)
        if s.operand == "bit_bf16":
            pooled = _Bf16Cotangent.apply(pooled)
            out = static & ~keep
            pooled = pooled - pool(x1, src_all[out],
                                   dst_all[out] * R + g.level[out],
                                   n_dst * R)
        pooled = pooled.reshape(n_dst, R, -1) * s_dst[:, None, None]
        w_aug = torch.cat([w, b[:, None, :]], 1)
        h = torch.einsum("drf,rfu->dru", pooled, w_aug)
    return h.sum(1) if s.agg_accum == "sum" else h.reshape(n_dst, -1)


def forward(p, s: ModelSpec, g: Graph, keep, noise_u, noise_i, pu, pi,
            masks=None, static=None):
    """``(pred (nblocks, B), recon [{t: e_t}])`` over the graph of the
    edges ``keep`` (bool); ``static`` (bool, default ``keep``) the edges
    of the graph the system's aggregation holds, of which the others are
    taken out.  ``masks``: the dropout keep-masks in the order the
    equations apply them (per block, per target type: the source
    features, then the aggregate), or ``None`` (evaluation)."""
    static = keep if static is None else static

    def scale(n, nodes):
        d = torch.bincount(nodes[keep], minlength=n).float()
        return torch.where(d > 0, d.clamp_min(1).rsqrt(), torch.zeros_like(d))

    s_u, s_i = scale(s.num_users, g.user), scale(s.num_items, g.item)
    x = {"user": p["embed_user.weight"] * (noise_u != -1)[:, None],
         "item": p["embed_item.weight"] * (noise_i != -1)[:, None]}
    n_masks = None if masks is None else len(masks)
    masks = None if masks is None else iter(masks)

    def drop(v):
        if masks is None:
            return v
        m = next(masks, None)
        if m is None:
            raise ValueError(f"the step recorded {n_masks} dropout masks; "
                             "the model applies more")
        if tuple(m.shape) != tuple(v.shape):
            raise ValueError(f"dropout mask {tuple(m.shape)} for a "
                             f"{tuple(v.shape)} operand")
        return v * m.to(v.device, v.dtype) / (1.0 - s.dropout)

    preds, recon = [], []
    for b in range(s.nblocks):
        o = {}
        for t, src in TYPES:
            h = aggregate(p, f"enc_b{b}.l0.agg_{t}_{src}", drop(x[src]), g,
                          keep, static,
                          (s_u, s_i) if t == "user" else (s_i, s_u),
                          t == "user", s)
            h = drop(leaky(h))
            o[t] = leaky(affine(p, f"enc_b{b}.l0.out_fc_{t}", h))
        pu_f = affine(p, f"rating_user_proj_b{b}", o["user"][pu])
        pi_f = affine(p, f"rating_item_proj_b{b}", o["item"][pi])
        preds.append((pu_f * pi_f).sum(-1))
        if s.use_dae:
            x = {t: affine(p, f"embed_map_b{b}_{t}_l1", leaky(affine(
                p, f"embed_map_b{b}_{t}_l0", o[t]))) for t in o}
            recon.append(x)
    if masks is not None and next(masks, None) is not None:
        raise ValueError(f"the step recorded {n_masks} dropout masks; the "
                         "model applies fewer")
    return torch.stack(preds), recon


def loss(p, s: ModelSpec, pred, recon, ratings, mean, std, recon_u,
         recon_i):
    """The training loss of one batch."""
    target = (ratings - mean) / std
    total = (0.5 * ((pred - target[None]) ** 2).mean(1)).sum()
    if s.use_dae:
        for e in recon:
            for t, m in (("user", recon_u), ("item", recon_i)):
                sq = ((e[t] - p[f"embed_{t}.weight"]) ** 2).sum(-1)
                total = total + s.recon_lambda * (sq * m).sum() \
                    / m.sum().clamp_min(1.0)
    return total
