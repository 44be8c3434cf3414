"""The collectives of one training step on a device mesh, stated in
advance, and a projection of the step to several cards.

The port of ``stargcn_tpu/parallel/perfmodel.py``.  The JAX package let
GSPMD insert its collectives and checked its model against the compiled
HLO within a band; the port issues every collective itself
(``parallel/collectives.py``), so the model is checked against what was
issued (``collectives.counted()``), call for call and byte for byte:

1. ``modeled_collectives`` -- the exact calls and bytes, by kind
   (``all_reduce``, ``all_gather``, ``broadcast``) and by mesh axis
   ('data', 'model', 'all'), of one ``train_iteration`` of ``Trainer``
   (full-graph, every backend but ``GCN.DROPOUT_PER_EDGE``) or of
   ``SampledTrainer`` (``sampled=``: both backends, host- or
   device-planned, with or without ``remat``, whose recomputation
   replays no collective) on a ``d x m`` mesh, in a steady step.  A world
   of one still issues every call.
2. ``link_seconds`` -- those calls' time on the links between cards: a
   ring all-reduce of B bytes over n ranks moves ``2 * B * (n - 1) / n``
   through each card's link, an all-gather of a B-byte whole ``B * (n -
   1) / n``, a pipelined broadcast B; an axis of one rank moves nothing.
3. ``project`` -- steps per second and examples per second at each mesh
   from a step measured on one card and the part of it, measured too,
   that the splitting axis divides: that part scales by the axis's size,
   the rest stays, and the link time adds on top (no overlap).  No share
   is assumed: the caller measures both times.

H100 SXM constants, each from NVIDIA's data sheet: NVLink 4, 18 links of
25 GB/s each way, 450 GB/s each way a card (900 GB/s in all); PCIe Gen5 x
16, 64 GB/s each way.
"""

from __future__ import annotations

import dataclasses

import torch

NVLINK_BYTES_PER_S = 450e9    # NVLink 4, each way, one card
PCIE_BYTES_PER_S = 64e9       # PCIe Gen5 x16, each way

_F32 = 4
_I32 = 4
_TABLES = ("embed_user.weight", "embed_item.weight")


def param_shapes(model_cfg, feature_dims=None) -> dict:
    """``{name: shape}`` of the ``STARGCN`` parameters of ``model_cfg``
    (built once on the CPU)."""
    from stargcn_tpu_torch.models.stargcn import STARGCN

    cfg = dataclasses.replace(model_cfg, backend="bitdense",
                              dropout_per_edge=False)
    model = STARGCN(cfg, generator=torch.Generator().manual_seed(0),
                    feature_dims=feature_dims)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def split_tables(model_cfg, m: int) -> dict:
    """``{name: split}``: whether each embedding table is split by rows
    over a 'model' axis of ``m`` (``GraphShardings.place_params``: where
    its rows divide)."""
    if not model_cfg.use_embed:
        return {}
    return {"embed_user.weight": model_cfg.num_users % m == 0,
            "embed_item.weight": model_cfg.num_items % m == 0}


def param_bytes(model_cfg, m: int = 1, feature_dims=None, shapes=None):
    """float32 parameter bytes: ``embed_sharded`` (the tables split over
    a 'model' axis of ``m``, whole), ``embed_local`` (one rank's rows of
    them) and ``replicated`` (everything else)."""
    shapes = shapes or param_shapes(model_cfg, feature_dims)
    split = split_tables(model_cfg, m)
    out = {"embed_sharded": 0, "embed_local": 0, "replicated": 0}
    for k, s in shapes.items():
        b = _numel(s) * _F32
        if split.get(k):
            out["embed_sharded"] += b
            out["embed_local"] += b // m
        else:
            out["replicated"] += b
    return out


class _Tally:
    def __init__(self):
        self.by_kind = {}

    def add(self, kind, axis, nbytes, times=1):
        entry = self.by_kind.setdefault(kind, {}).setdefault(axis, [0, 0])
        entry[0] += times
        entry[1] += int(nbytes) * times


def _level_dims(model_cfg, shapes):
    """Per block and level: ``(in_units, link_units, agg_units,
    out_units)`` of its aggregators, read from the parameter shapes."""
    cfg = model_cfg
    dims = []
    for b in range(cfg.nblocks):
        p = 0 if cfg.use_recurrent else b
        row = []
        for li in range(len(cfg.agg_units)):
            depth = 0 if cfg.gcn_use_recurrent else li
            R, fin, link = shapes[f"enc_b{p}.l{depth}.agg_user_item.weight"]
            out, agg = shapes[f"enc_b{p}.l{depth}.out_fc_user.weight"]
            row.append((fin, link, agg, out))
        dims.append(row)
    return dims


def _replica_broadcasts(t, pb):
    """``Trainer._replica_grads``: the replicated gradients from the
    mesh's first rank, the split tables' from the first 'data' rank."""
    if pb["replicated"]:
        t.add("broadcast", "all", pb["replicated"])
    if pb["embed_local"]:
        t.add("broadcast", "data", pb["embed_local"])


def _full_graph(t, cfg, d, m, backend, shapes, pb):
    from stargcn_tpu_torch.ops.bitdense import pad_dims

    split = split_tables(cfg, m)
    n = {"user": cfg.num_users, "item": cfg.num_items}
    other = {"user": "item", "item": "user"}
    R = cfg.num_links
    # The valid count of the whole batch; the projected node states'
    # cotangents (batch_group) per block and type; the statistics.
    t.add("all_reduce", "data", _F32)
    for _ in range(cfg.nblocks):
        for key in ("user", "item"):
            t.add("all_reduce", "data", n[key] * cfg.gen_rating_mid_map
                  * _F32)
    t.add("all_reduce", "data", 2 * cfg.nblocks * _F32)
    for key in ("user", "item"):
        if split.get(f"embed_{key}.weight"):
            t.add("all_gather", "model", n[key] * cfg.embed_units * _F32)
    if any(split.values()):
        t.add("all_reduce", "model", _F32)       # the clip's global norm
    dims = _level_dims(cfg, shapes)
    if backend == "xla":
        # Degrees of the edge shards; per level and direction the pooled
        # partial sums (leave) and the projection's cotangent (enter).
        for key in ("user", "item"):
            t.add("all_reduce", "model", n[key] * _F32)
        for row in dims:
            for fin, link, agg, out in row:
                for key in ("user", "item"):
                    t.add("all_reduce", "model", n[key] * agg * _F32)
                    t.add("all_reduce", "model",
                          R * n[other[key]] * link * _F32)
    elif backend == "bitdense":
        from stargcn_tpu_torch.ops.bitdense import (pack_row_interleave,
                                                    resolve_impl)
        from stargcn_tpu_torch.parallel.shardings import _ROW_BLOCK

        ril = pack_row_interleave(resolve_impl(cfg.bit_impl))
        geo = {key: pad_dims(n[key], n[other[key]]) for key in n}

        def splits(rows):
            return rows % m == 0 and (not ril
                                      or (rows // m) % _ROW_BLOCK == 0)

        for row in dims:
            for fin, link, agg, out in row:
                f = fin + 1        # the ones column that carries the bias
                for key in ("user", "item"):
                    d8, d_pad, _ = geo[key]
                    if splits(R * d8):          # the expand's rows
                        t.add("all_gather", "model", R * d_pad * f * _F32)
                    d8_s, d_pad_s, _ = geo[other[key]]
                    if splits(R * d8_s):        # the reduce's rows
                        t.add("all_reduce", "model", d_pad_s * f * _F32)
    elif backend not in ("dense", "ell"):
        raise ValueError(f"no model of the {backend!r} backend")
    _replica_broadcasts(t, pb)


def packed_lengths(model_cfg, sampled) -> tuple:
    """``(int32 count, float32 count)`` of one training step's packed
    feed (``SampledTrainer._pack_batch``) under ``sampled``'s caps."""
    cfg = model_cfg
    caps, B, rc = sampled["caps"], sampled["batch"], sampled["recon"]
    n = {"user": cfg.num_users, "item": cfg.num_items}
    both = ("user", "item")
    recon = sum(rc[k] for k in both)
    if sampled.get("plan_device"):
        return 2 * B + sum(n.values()) + recon, 2 * B
    K, L, nb = sampled["fanout"], len(cfg.agg_units), cfg.nblocks
    cap = sum(caps[k] for k in both)
    ints = (nb * cap                       # the deepest frontiers
            + nb * L * cap * K             # the blocks' combined indices
            + nb * 2 * B                   # the pairs' positions
            + (nb - 1) * cap               # cross-block positions
            + nb * recon + recon           # recon positions and ids
            + sum(n.values()))             # the noise arrays
    flts = nb * L * cap * K + (nb - 1) * cap + nb * recon + 2 * B
    return ints, flts


def _sampled(t, cfg, d, m, backend, shapes, pb, sampled):
    split = split_tables(cfg, m)
    n = {"user": cfg.num_users, "item": cfg.num_items}
    other = {"user": "item", "item": "user"}
    R = cfg.num_links
    caps = dict(sampled["caps"])
    if sampled.get("plan_device"):
        # The device planner's frontiers never outgrow the node sets.
        caps = {k: min(caps[k], n[k]) for k in caps}
    rc = sampled["recon"]
    cdt_bytes = 2 if cfg.compute_dtype == "bfloat16" else _F32
    # The feed: the header and the two buffers (a step whose packed spec
    # changed also broadcasts the pickled spec, which a steady step does
    # not).
    ints, flts = packed_lengths(cfg, sampled)
    t.add("broadcast", "all", 5 * 8)
    t.add("broadcast", "all", ints * _I32)
    t.add("broadcast", "all", flts * _F32)
    if cfg.use_embed:
        for key in ("user", "item"):
            if split.get(f"embed_{key}.weight"):
                # The frontier's rows and the recon targets' rows.
                t.add("all_reduce", "model",
                      caps[key] * cfg.embed_units * _F32)
                t.add("all_reduce", "model", rc[key] * cfg.embed_units
                      * _F32)
    if any(split.values()):
        t.add("all_reduce", "model", _F32)       # the clip's global norm
    for row in _level_dims(cfg, shapes):
        for fin, link, agg, out in row:
            for key in ("user", "item"):
                src = other[key]
                rows = -(-caps[key] // d)
                # The source rows' cotangent (widened to float32), the
                # aggregator's weight and bias, the out-FC's weight and
                # bias, then the level's output made whole.
                t.add("all_reduce", "data", caps[src] * fin * _F32)
                t.add("all_reduce", "data", R * fin * link * _F32)
                t.add("all_reduce", "data", R * link * _F32)
                t.add("all_reduce", "data", out * agg * _F32)
                t.add("all_reduce", "data", out * _F32)
                t.add("all_gather", "data", d * rows * out * cdt_bytes)
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown sampled backend: {backend!r}")
    _replica_broadcasts(t, pb)


def modeled_collectives(model_cfg, d: int, m: int, backend: str = "xla",
                        *, sampled=None, feature_dims=None) -> dict:
    """The collectives of one ``train_iteration`` on a ``(data=d,
    model=m)`` mesh: ``{kind: {axis: [count, bytes]}}``, the layout of
    ``collectives.CollectiveCounts.by_kind``.

    ``backend`` is the full-graph trainer's (``xla``, ``bitdense``,
    ``dense``, ``ell``), or with ``sampled`` the sampled trainer's
    (``xla``, ``pallas``).  ``sampled`` holds ``caps`` (``{'user',
    'item'}``, the trainer's frontier caps), ``batch`` (its padded batch),
    ``recon`` (``{'user', 'item'}``, its recon caps), ``fanout``, and
    optionally ``plan_device``.  ``remat`` issues the same calls (the
    level's gather lies outside the recomputation).  ``feature_dims`` as
    ``STARGCN``'s, with ``MODEL.USE_FEA_PROJ``."""
    shapes = param_shapes(model_cfg, feature_dims)
    pb = param_bytes(model_cfg, m, shapes=shapes)
    t = _Tally()
    if sampled is None:
        _full_graph(t, model_cfg, d, m, backend, shapes, pb)
    else:
        _sampled(t, model_cfg, d, m, backend, shapes, pb, sampled)
    return t.by_kind


def total(by_kind: dict) -> tuple:
    """``(calls, bytes)`` over every kind and axis."""
    return (sum(c for axes in by_kind.values() for c, _ in axes.values()),
            sum(b for axes in by_kind.values() for _, b in axes.values()))


def link_seconds(by_kind: dict, d: int, m: int,
                 bytes_per_s: float = NVLINK_BYTES_PER_S) -> float:
    """The collectives' time on the links, one after another: over an
    axis of n ranks an all-reduce of B bytes moves ``2 B (n - 1) / n``
    through each card's link, an all-gather of a B-byte whole ``B (n -
    1) / n`` and a broadcast B (pipelined); nothing where n is 1."""
    size = {"data": d, "model": m, "all": d * m}
    secs = 0.0
    for kind, axes in by_kind.items():
        for axis, (_, nbytes) in axes.items():
            ranks = size.get(axis, d * m)
            if ranks <= 1:
                continue
            share = {"all_reduce": 2 * (ranks - 1) / ranks,
                     "all_gather": (ranks - 1) / ranks,
                     "broadcast": 1.0}[kind]
            secs += share * nbytes / bytes_per_s
    return secs


def project(model_cfg, *, step_s_1card: float, split_s_1card: float,
            batch: int,
            meshes=((1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1)),
            backend: str = "bitdense", sampled=None,
            feature_dims=None) -> list:
    """One row per mesh: the step's time and examples per second
    projected from ``step_s_1card``, the step measured on one card, and
    ``split_s_1card``, the part of it (measured too) that the splitting
    axis divides: 'model' for the full-graph trainer (its edge and
    bit-pack work), 'data' for the sampled trainer (the device step; the
    plan and the pack stay whole on the first rank).  The modeled
    collectives' NVLink time adds on top, not overlapped; the PCIe time
    is given beside it.  Per-call latency and the ranks' lockstep are
    not in the model."""
    if not 0.0 <= split_s_1card <= step_s_1card:
        raise ValueError(f"the divided part ({split_s_1card} s) must lie "
                         f"within the step ({step_s_1card} s)")
    rows = []
    for d, m in meshes:
        vol = modeled_collectives(model_cfg, d, m, backend, sampled=sampled,
                                  feature_dims=feature_dims)
        split = d if sampled is not None else m
        t_link = link_seconds(vol, d, m)
        t = step_s_1card - split_s_1card + split_s_1card / split + t_link
        calls, nbytes = total(vol)
        rows.append({
            "mesh": f"{d}x{m}", "cards": d * m,
            "step_ms": t * 1e3, "link_ms": t_link * 1e3,
            "link_ms_pcie": link_seconds(vol, d, m, PCIE_BYTES_PER_S) * 1e3,
            "collectives": calls, "collective_MB": nbytes / 1e6,
            "examples_per_s": batch / t,
            "scaling_efficiency": step_s_1card / (t * d * m)})
    return rows
