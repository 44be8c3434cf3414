#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stargcn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the port, from ``ops/csrc/``, in parallel;
3. kernel check, small cases: ``bit_expand_matmul`` and
   ``bit_reduce_matmul`` on the card against their plain PyTorch versions
   fed the same bf16-rounded input (dense and sparse packs, f32 and bf16
   input, long rows that are split over warps, permuted-view cotangents);
4. set-up: ``configs/transductive_ml_10m.yml`` on a synthetic graph of the
   real ML-10M size, one ``DataIterator`` and one ``Trainer`` on the card
   (parameters from seed 123), the train and test bit packs;
5. kernel check, full size: both kernels on the ML-10M packs (a few row
   blocks compared with the plain versions; two launches on the same
   input give the same bits), their time per launch at the
   main path's shapes beside their bounds, and the adjoint identity
   ``<expand(x), g> = <x, reduce(g)>`` that ties the two kernels and the
   two pack layouts together;
6. training slice: one ``train_iteration`` (launch counts), the same step
   through a plain twin (loss and every gradient compared), ``fit`` for 20
   steps with two validations and checkpoints, ``restore_checkpoint``,
   then ``export_serving(trainer)`` and queries on the trained parameters;
7. serving slice: the export of random parameters from seed 123 through
   the kernel (launch counts), checked against the same export through
   the plain version, then ``predict`` and ``recommend`` on the card.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of
JAX and nothing of the JAX package.
"""

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
ML10M = dict(num_users=69_878, num_items=10_677, num_edges=10_000_000)
SEED = 123
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps):
    """Mean time per call on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn):
    """(result, seconds) on the host clock, ending in a synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_busy_ms(fn):
    """Device time of one call of ``fn`` (the kernels and copies of
    ``torch.profiler``'s trace, summed), or None where the trace shows
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side entries only: the host-side operator entries carry their
    # kernels' time a second time.
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 if total_us > 0 else None


# ------------------------------ kernel check ------------------------------


def _sub_err(got, want):
    """Max abs error, the tolerance (1e-4 of the largest output: kernel
    and plain version sum the same bf16 values in float32, in another
    order) and the scale."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, 1e-4 * max(scale, 1.0), scale


def expand_err(bd, P, x, R, d8, rows=None):
    """The expand kernel against its plain version fed the bf16-rounded
    x; ``rows = (r, m0, m1)`` compares packed rows r*d8 + [m0, m1) only."""
    import torch

    got = bd.bit_expand_matmul(P, x, R, d8)
    xr = x.to(torch.bfloat16).float()
    if rows is None:
        want = bd.xla_expand_matmul(P, xr, R, d8)
    else:
        r, m0, m1 = rows
        got = got[r:r + 1, :, m0:m1]
        want = bd.xla_expand_matmul(P[r * d8 + m0:r * d8 + m1], xr, 1,
                                    m1 - m0)
    return _sub_err(got, want)


def reduce_err(bd, P, g, R, d8, rows=None):
    """The reduce kernel against its plain version fed the bf16-rounded
    g; ``rows = (m0, m1)`` compares output rows [m0, m1) only."""
    import torch

    got = bd.bit_reduce_matmul(P, g, R, d8)
    gr = g.to(torch.bfloat16).float()
    if rows is None:
        want = bd.xla_reduce_matmul(P, gr, R, d8)
    else:
        m0, m1 = rows
        got = got[:, m0:m1]
        sub = torch.cat([P[r * d8 + m0:r * d8 + m1] for r in range(R)])
        want = bd.xla_reduce_matmul(sub, gr, R, m1 - m0)
    return _sub_err(got, want)


def small_kernel_checks(bd):
    """``{kernel name: worst max abs error}`` over the small cases."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    worst = {"bit_expand_matmul": 0.0, "bit_reduce_matmul": 0.0}
    # (R, F, dense P, input dtype, D, S, g as a permuted view): the long-S
    # cases split each row's walk across several warps, as the ML-10M item
    # direction does.
    for R, F, dense, dtype, D, S, view in (
            (1, 7, False, torch.float32, 2000, 1500, False),
            (3, 65, True, torch.float32, 2000, 1500, True),
            (10, 65, False, torch.float32, 2000, 1500, True),
            (10, 65, True, torch.bfloat16, 2000, 1500, False),
            (2, 300, True, torch.float32, 2000, 1500, True),
            (10, 65, False, torch.float32, 300, 70000, True),
            (3, 65, True, torch.float32, 300, 40000, False)):
        e = 40000
        P, d8 = bd.pack_bits(rng.randint(0, D, e), rng.randint(0, S, e),
                             rng.randint(0, R, e), R, D, S)
        if dense:
            P = rng.randint(0, 256, P.shape).astype(np.uint8)
        Pt = torch.from_numpy(P).to(DEVICE)
        s_pad = P.shape[1]
        x = torch.from_numpy(rng.randn(s_pad, F).astype(
            np.float32)).to(DEVICE, dtype)
        g = torch.from_numpy(rng.randn(s_pad, R, F).astype(
            np.float32)).to(DEVICE, dtype).permute(1, 0, 2)
        if not view:
            g = g.contiguous()
        what = (f"R={R} F={F} D={D} S={S} {'dense' if dense else 'sparse'} "
                f"{str(dtype)[6:]}")
        for name, (err, tol, scale) in (
                ("bit_expand_matmul", expand_err(bd, Pt, x, R, d8)),
                ("bit_reduce_matmul", reduce_err(bd, Pt, g, R, d8))):
            log(f"  {name} {what}"
                f"{' g=view' if view and 'reduce' in name else ''}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"{name} disagrees ({what})")
            worst[name] = max(worst[name], err)
    return worst


def bound_ms(nbytes, set_bits, f):
    """Least time for one launch: its operands and its output moved once
    at the HBM rate, or one f32 add per set bit per column at the f32
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = set_bits * f / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def set_bits(P):
    import torch

    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=P.device)
    total = 0
    for lo in range(0, P.shape[0], 8192):
        total += int(table[P[lo:lo + 8192].long()].sum())
    return total


def full_expand_checks(bd, pack, R, F, card):
    """``bit_expand_matmul`` on the full ML-10M packs of the serving path:
    a few row blocks checked, then timed against the plain version and the
    bound."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes, worst = [], 0.0
    for direction in ("user", "item"):
        P = pack[direction]["pf"]
        d8 = P.shape[0] // R
        s_pad = P.shape[1]
        x = torch.randn(s_pad, F, device=DEVICE, generator=gen)
        w = min(256, d8 // 2)
        for rows in ((0, 0, w), (R // 2, d8 // 2, d8 // 2 + w),
                     (R - 1, d8 - w, d8)):
            err, tol, scale = expand_err(bd, P, x, R, d8, rows)
            log(f"  full-size check {direction} rows {rows}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"bit_expand_matmul disagrees at ML-10M "
                              f"({direction}, rows {rows})")
            worst = max(worst, err)
        check(torch.equal(bd.bit_expand_matmul(P, x, R, d8),
                          bd.bit_expand_matmul(P, x, R, d8)),
              f"bit_expand_matmul does not repeat bit for bit ({direction})")
        ms = cuda_ms(lambda: bd.bit_expand_matmul(P, x, R, d8), reps=20)
        plain = cuda_ms(lambda: bd.xla_expand_matmul(P, x, R, d8), reps=2)
        ones = set_bits(P)
        bms, by = bound_ms(P.numel() + s_pad * F * 4 + R * 8 * d8 * F * 4,
                           ones, F)
        shapes.append(dict(direction=direction, P=list(P.shape), F=F,
                           set_bits=ones, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by))
        log(f"  bit_expand_matmul {direction} P={tuple(P.shape)} F={F}: "
            f"kernel {ms:.4f} ms/launch, plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms ({by}), set bits {ones} [{card}]")
    return worst, shapes


def full_reduce_checks(bd, pack, R, F, card):
    """``bit_reduce_matmul`` on the full ML-10M train packs, at the shapes
    the training step gives it: the backward of the aggregation into
    ``direction`` reads that direction's ``pb`` and a permuted view of the
    ``(D_pad, R, F)`` cotangent, and gives the gradient for the other
    type.  A few output-row blocks checked, then timed."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    shapes, worst = [], 0.0
    for direction, grad_for in (("user", "item"), ("item", "user")):
        P = pack[direction]["pb"]
        d8 = P.shape[0] // R
        s_pad = P.shape[1]
        g = torch.randn(s_pad, R, F, device=DEVICE,
                        generator=gen).permute(1, 0, 2)
        w = min(64, d8 // 2)
        for rows in ((0, w), (d8 // 2, d8 // 2 + w), (d8 - w, d8)):
            err, tol, scale = reduce_err(bd, P, g, R, d8, rows)
            log(f"  full-size check gradient for {grad_for} rows {rows}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"bit_reduce_matmul disagrees at ML-10M "
                              f"(gradient for {grad_for}, rows {rows})")
            worst = max(worst, err)
        check(torch.equal(bd.bit_reduce_matmul(P, g, R, d8),
                          bd.bit_reduce_matmul(P, g, R, d8)),
              f"bit_reduce_matmul does not repeat bit for bit (gradient "
              f"for {grad_for})")
        ms = cuda_ms(lambda: bd.bit_reduce_matmul(P, g, R, d8), reps=20)
        plain = cuda_ms(lambda: bd.xla_reduce_matmul(P, g, R, d8), reps=2)
        ones = set_bits(P)
        bms, by = bound_ms(P.numel() + R * s_pad * F * 4 + 8 * d8 * F * 4,
                           ones, F)
        shapes.append(dict(gradient_for=grad_for, P=list(P.shape),
                           g=[R, s_pad, F], F=F, set_bits=ones, ms=ms,
                           plain_ms=plain, bound_ms=bms, bound_by=by))
        log(f"  bit_reduce_matmul gradient for {grad_for} "
            f"P={tuple(P.shape)} g=({R}, {s_pad}, {F}) view: kernel "
            f"{ms:.4f} ms/launch, plain {plain:.3f} ms, bound {bms:.4f} ms "
            f"({by}), set bits {ones} [{card}]")
    return worst, shapes


def adjoint_check(bd, pack, R, F):
    """``<expand(p_fwd, x), g> = <x, reduce(p_bwd, g)>`` on the full packs
    with bf16-representable x and g, sums in float64, relative 1e-5."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    for direction in ("user", "item"):
        pf, pb = pack[direction]["pf"], pack[direction]["pb"]
        d8_dst, d8_src = pf.shape[0] // R, pb.shape[0] // R
        x = torch.randn(pf.shape[1], F, device=DEVICE,
                        generator=gen).to(torch.bfloat16).float()
        g = torch.randn(8 * d8_dst, R, F, device=DEVICE,
                        generator=gen).to(torch.bfloat16).float()
        fwd = bd.bit_expand_matmul(pf, x, R, d8_dst)
        lhs = float((fwd.permute(1, 2, 0, 3).reshape(8 * d8_dst, R, F)
                     .double() * g.double()).sum())
        bwd = bd.bit_reduce_matmul(pb, g.permute(1, 0, 2), R, d8_src)
        rhs = float((x.double() * bwd.reshape(8 * d8_src, F).double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        log(f"  adjoint, aggregation into {direction}: <expand(x), g> = "
            f"{lhs:.6f}, <x, reduce(g)> = {rhs:.6f}, rel diff {rel:.3e} "
            f"(tol 1e-5)")
        check(rel <= 1e-5, f"adjoint identity fails ({direction})")


# --------------------------------- set-up ---------------------------------


def build_ml10m():
    """The ML-10M-shaped synthetic graph and its split (seed 123, 10% test,
    10% valid), the config ``transductive_ml_10m.yml`` and its model
    config."""
    import numpy as np

    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(os.path.join(ROOT, "configs",
                                     "transductive_ml_10m.yml"))
    cfg.DATASET.NAME = "synthetic"
    g = synthetic_graph(**ML10M, rating_values=tuple(np.arange(0.5, 5.01,
                                                               0.5)),
                        seed=SEED)
    csr = g["user", "movie"]
    pairs = csr.node_pair_ids
    perm = np.random.RandomState(SEED).permutation(pairs.shape[1])
    n_test = pairs.shape[1] // 10
    it = DataIterator(g, "user", "movie",
                      test_node_pairs=pairs[:, perm[:n_test]],
                      valid_node_pairs=pairs[:, perm[n_test:2 * n_test]],
                      embed_P_mask=cfg.EMBED.MASK_PROP,
                      embed_p_zero=cfg.EMBED.P_ZERO,
                      embed_p_self=1.0 - cfg.EMBED.P_ZERO, seed=SEED)
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link))
    return cfg, it, model_cfg


def plain_twin(owner):
    """The same ``Trainer`` or ``ServingState`` (a shallow copy: same
    operands, same dropout stream) with the model on the plain versions."""
    from stargcn_tpu_torch.models import STARGCN

    twin = copy.copy(owner)
    twin.model = STARGCN(dataclasses.replace(owner.model_cfg,
                                             bit_impl="xla"))
    twin.model.load_state_dict(owner.model.state_dict())
    twin.model.to(owner.device)
    return twin


@contextlib.contextmanager
def bf16_fed_plain_versions(bd):
    """While open, the plain versions round their float operand to bf16
    first, as the kernels do."""
    import torch

    expand, reduce = bd.xla_expand_matmul, bd.xla_reduce_matmul

    def rounded(fn):
        return lambda P, v, *args: fn(P, v.to(torch.bfloat16).float(), *args)

    bd.xla_expand_matmul, bd.xla_reduce_matmul = (rounded(expand),
                                                  rounded(reduce))
    try:
        yield
    finally:
        bd.xla_expand_matmul, bd.xla_reduce_matmul = expand, reduce


def rel_err(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def zero_launches(bd):
    for k in bd.LAUNCHES:
        bd.LAUNCHES[k] = 0


def check_queries(art, card, what):
    """``predict`` and ``recommend`` on the card over ``art``."""
    import numpy as np

    from stargcn_tpu_torch.serve import Predictor

    pred = Predictor(art, device=DEVICE)
    rng = np.random.RandomState(SEED)
    uu = rng.randint(0, art.num_users, 4096)
    ii = rng.randint(0, art.num_items, 4096)
    ratings, t_pred = host_s(lambda: pred.predict(uu, ii))
    want = np.clip((art.user_feats[uu] * art.item_feats[ii]).sum(-1)
                   * art.rating_std + art.rating_mean, art.rating_min,
                   art.rating_max)
    check(ratings.shape == (4096,) and np.isfinite(ratings).all(),
          "predict output")
    check(ratings.min() >= 0.5 and ratings.max() <= 5.0,
          "ratings outside [0.5, 5.0]")
    check(np.abs(ratings - want).max() <= 1e-4, "predict disagrees with "
          "the artifact's inner product")
    users = rng.choice(art.num_users, 256, replace=False)
    (idx, vals), t_rec = host_s(lambda: pred.recommend(users, k=10))
    check(idx.shape == (256, 10) and np.isfinite(vals).all(),
          "recommend output")
    for r, u in enumerate(users):
        rated = art.rated_items[art.rated_indptr[u]:art.rated_indptr[u + 1]]
        check(not np.isin(idx[r], rated).any(),
              f"user {u} was recommended an item it rated")
    log(f"  {what}: predict 4096 pairs: {t_pred * 1e3:.2f} ms; recommend "
        f"k=10 for 256 users: {t_rec * 1e3:.2f} ms [{card}]")


def check_artifact(art):
    import numpy as np

    check(art.user_feats.shape == (ML10M["num_users"], 64)
          and art.item_feats.shape == (ML10M["num_items"], 64),
          "artifact shapes")
    check(np.isfinite(art.user_feats).all()
          and np.isfinite(art.item_feats).all(), "non-finite features")


# ----------------------------- training slice -----------------------------


def next_batches(trainer, rating_sampler, recon_sampler):
    rb = next(rating_sampler)
    noise_dict, _, recon_ids = next(recon_sampler)
    return rb, trainer.prepare_recon_batch(noise_dict, recon_ids)


def run_training_slice(bd, trainer, card):
    """Phase 6.  Returns the launch counts of one training step."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import export_serving

    it, s = trainer.data_iter, trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    batch = next_batches(trainer, rating_sampler, recon_sampler)
    check(trainer.do_remove and batch[0][1].size == 100_000,
          "the step should remove a batch of 100,000 train edges")
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    # (a) one step through the entry point: counts from 0, then read.
    torch.cuda.reset_peak_memory_stats()
    trainer.seed_dropout(SEED)
    zero_launches(bd)
    stats, t_first = host_s(lambda: trainer.train_iteration(*batch))
    launches = dict(bd.LAUNCHES)
    log(f"  first train_iteration: {t_first * 1e3:.1f} ms (start-up "
        f"included), loss {float(stats['loss']):.4f}, gnorm "
        f"{float(stats['gnorm']):.4f}, launches {launches} [{card}]")
    check(launches == {"bit_expand_matmul": 4, "bit_reduce_matmul": 4},
          f"expected 4 + 4 kernel launches in a step, got {launches}")
    check(bool(torch.isfinite(stats["loss"])), "non-finite first loss")

    # (b) the same step, from the same parameters, batch and dropout
    # masks, through the kernels and through a plain twin: once with the
    # plain versions fed bf16-rounded x and g (the kernels' arithmetic in
    # another order), once as they are (what the rounding costs).
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    trainer.seed_dropout(SEED)
    (k_stats, k_grads), t_k = host_s(lambda: trainer.loss_and_grads(*batch))
    repeats = []
    for _ in range(4):
        trainer.seed_dropout(SEED)
        repeats.append(trainer.loss_and_grads(*batch))
    twin = plain_twin(trainer)
    trainer.seed_dropout(SEED)
    with bf16_fed_plain_versions(bd):
        (r_stats, r_grads), _ = host_s(lambda: twin.loss_and_grads(*batch))
    trainer.seed_dropout(SEED)
    (p_stats, p_grads), t_p = host_s(lambda: twin.loss_and_grads(*batch))
    del twin

    def compare(stats, grads):
        loss_rel = abs(float(k_stats["loss"]) - float(stats["loss"])) \
            / abs(float(stats["loss"]))
        worst, worst_name, diff2, norm2 = 0.0, "", 0.0, 0.0
        for name, pg in grads.items():
            scale = float(pg.abs().max())
            check(scale > 0, f"zero gradient for {name}")
            rel = float((k_grads[name] - pg).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, name
            diff2 += float((k_grads[name] - pg).double().pow(2).sum())
            norm2 += float(pg.double().pow(2).sum())
        return loss_rel, worst, worst_name, (diff2 / norm2) ** 0.5

    log(f"  forward+backward through the kernels {t_k * 1e3:.1f} ms, "
        f"through the plain versions {t_p * 1e3:.1f} ms")
    floor = [compare(*rep) for rep in repeats]
    del repeats
    log(f"  the same step 4 more times through the kernels, each against "
        f"the first: all gradients together "
        f"{', '.join(f'{x[3]:.3e}' for x in floor)} relative; worst single "
        f"parameter {', '.join(f'{x[1]:.3e}' for x in floor)} of its "
        f"largest entry ({', '.join(sorted({x[2] for x in floor}))}).  "
        f"That is the floor for what follows: index_add_ and the row "
        f"gather's backward use atomics, the library's matrix products "
        f"may sum in another order from call to call, and at the seed's "
        f"parameters some gradients are sums that nearly cancel")
    loss_rel, worst, worst_name, glob = compare(r_stats, r_grads)
    log(f"  kernels against plain versions fed bf16-rounded x and g: loss "
        f"rel diff {loss_rel:.3e}, all gradients together {glob:.3e} "
        f"relative (tol 1e-3), worst single parameter {worst:.3e} of its "
        f"largest entry ({worst_name}; {len(r_grads)} parameters; tol "
        f"5e-2)")
    check(loss_rel <= 1e-3 and glob <= 1e-3 and worst <= 5e-2,
          "training step through the kernels disagrees with the plain "
          "versions fed the same rounded inputs")
    loss_rel, worst, worst_name, glob = compare(p_stats, p_grads)
    log(f"  kernels against plain versions as they are (no rounding): loss "
        f"rel diff {loss_rel:.3e}, all gradients together {glob:.3e} "
        f"relative (tol 1e-1), worst single parameter {worst:.3e} of its "
        f"largest entry ({worst_name}): at the seed's parameters these "
        f"gradients are sums that nearly cancel, so bf16 rounding of x "
        f"shows in them far above its 4e-3")
    check(loss_rel <= 1e-2 and glob <= 1e-1,
          "training step through the kernels disagrees with the plain twin")
    del k_grads, p_grads, r_grads

    # Steady-state step time: a few steps, host clock ending in a
    # synchronise, kernel time by CUDA events around the wrappers.
    times = []
    for _ in range(5):
        b = next_batches(trainer, rating_sampler, recon_sampler)
        _, t = host_s(lambda: trainer.train_iteration(*b))
        times.append(t * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    b = next_batches(trainer, rating_sampler, recon_sampler)
    t0 = time.perf_counter()
    host_arrays = trainer._prep_host_arrays(*b)
    prep_ms = (time.perf_counter() - t0) * 1e3
    del host_arrays
    log(f"  train_iteration, 5 steps after the first: "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (median {step_ms:.1f} "
        f"ms/step at batch {s.rating_batch_size}); of a step, the host's "
        f"_prep_host_arrays takes {prep_ms:.1f} ms [{card}]")
    busy_ms = device_busy_ms(lambda: trainer.train_iteration(*b))
    if busy_ms is None:
        log("  device busy time of a step: not measured (the profiler "
            "showed no device time)")
    else:
        log(f"  device busy time of one step (torch.profiler, kernels and "
            f"copies summed): {busy_ms:.1f} ms, so the card idles for "
            f"about {max(0.0, 1 - busy_ms / step_ms):.0%} of a "
            f"{step_ms:.1f} ms step [{card}]")

    # (c) fit: 20 steps with the config's intervals -> two validations.
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    trainer.seed_dropout(SEED)
    losses = []
    real_step = trainer.train_iteration

    def recording_step(rb, cb):
        st = real_step(rb, cb)
        losses.append(st["loss"])
        return st

    trainer.train_iteration = recording_step
    lines = []
    zero_launches(bd)
    summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                log=lines.append))
    trainer.train_iteration = real_step
    fit_launches = dict(bd.LAUNCHES)
    for line in lines:
        log(f"  fit: {line}")
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  fit(max_iter=20): {t_fit:.2f} s with two validations, two test "
        f"evaluations at most and checkpoints; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; launches {fit_launches};"
        f" peak device memory {peak_gb:.2f} GiB [{card}]")
    check(len(losses) == 20 and np.isfinite(losses).all(),
          "fit should take 20 steps with finite losses")
    check(np.mean(losses[10:]) < losses[0],
          "mean loss of steps 11-20 is not below step 1's")
    eval_batches = -(-it.valid_node_pairs.shape[1] // s.rating_batch_size)
    check(fit_launches["bit_reduce_matmul"] == 80
          and fit_launches["bit_expand_matmul"] >= 80 + 2 * 4 * eval_batches,
          f"fit launch counts {fit_launches}")
    span = trainer.rating_max - trainer.rating_min
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] in (10, 20) and np.isfinite(rmses).all()
          and 0 <= min(rmses) and max(rmses) <= span,
          f"fit summary {summary}")
    check(sum("Val RMSE" in x for x in lines) == 2, "two validations")

    # (d) the best checkpoint gives back the parameters that were saved.
    best = os.path.join(trainer.save_dir, "ckpt_best_0.pt")
    last = os.path.join(trainer.save_dir, "ckpt_last_0.pt")
    check(os.path.exists(best) and os.path.exists(last), "checkpoints")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    trainer.restore_checkpoint(best)
    for name, t in trainer.model.state_dict().items():
        check(torch.equal(t.cpu(), saved["params"][name]),
              f"restored parameter {name} differs from the saved one")
    check(trainer.opt.count == summary["best_iter"],
          "restored optimizer step count")
    moved = max(float((t.cpu() - params0[k].cpu()).abs().max())
                for k, t in trainer.model.state_dict().items())
    check(moved > 0, "training did not move the parameters")
    log(f"  restore_checkpoint({os.path.basename(best)}): parameters equal "
        f"the saved ones, optimizer at step {trainer.opt.count}")

    # (e) export and serve the trained parameters.
    zero_launches(bd)
    art, t_export = host_s(lambda: export_serving(trainer, segment="test"))
    check(bd.LAUNCHES["bit_expand_matmul"] == 4,
          f"export launches {bd.LAUNCHES}")
    check_artifact(art)
    log(f"  export_serving(trainer): {t_export:.3f} s [{card}]")
    check_queries(art, card, "trained parameters")
    return launches, dict(step_ms=step_ms, first_step_ms=t_first * 1e3,
                          prep_ms=prep_ms, device_busy_ms=busy_ms,
                          peak_gib=peak_gb, fit_s=t_fit)


# ----------------------------- serving slice -----------------------------


def run_serving_slice(bd, trainer, card):
    """Phase 7.  Returns the launch counts of one export."""
    from stargcn_tpu_torch.serve import ServingState, export_serving

    state, t_state = host_s(lambda: ServingState(
        trainer.model_cfg, trainer.data_iter, device=DEVICE, seed=SEED,
        variants=trainer.variants))
    log(f"  serving state (parameters from seed {SEED}; operands shared "
        f"with the trainer): {t_state:.2f} s [{card}]")

    # ---- the main path: counts from 0, one export, counts read ----
    zero_launches(bd)
    art, t_export = host_s(lambda: export_serving(state, segment="test"))
    launches = dict(bd.LAUNCHES)
    log(f"  export through the kernel: {t_export:.3f} s, launches "
        f"{launches} [{card}]")
    check(launches == {"bit_expand_matmul": 4, "bit_reduce_matmul": 0},
          f"expected 4 bit_expand_matmul launches, got {launches}")

    ref, t_ref = host_s(lambda: export_serving(plain_twin(state),
                                               segment="test"))
    eu = rel_err(art.user_feats, ref.user_feats)
    ei = rel_err(art.item_feats, ref.item_feats)
    log(f"  export through the plain version: {t_ref:.3f} s; U rel err "
        f"{eu:.3e}, I rel err {ei:.3e} (tol 1e-2: the kernel rounds its "
        f"input to bf16, the plain version does not)")
    check_artifact(art)
    check(eu <= 1e-2 and ei <= 1e-2, "kernel export disagrees with plain")
    check_queries(art, card, "parameters from the seed")
    return launches


def kernel_row(name, source, replaces, launches, worst, shapes):
    mean = lambda key: sum(s[key] for s in shapes) / len(shapes)  # noqa
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=worst, ms=mean("ms"),
        plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=None, shapes=shapes)


def main():
    if not os.path.isdir(os.path.join(ROOT, "stargcn_tpu_torch")):
        fail("stargcn_tpu_torch/ is not beside chip_smoke.py: run it from "
             "a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    # Full float32 in the plain versions' matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. environment")
    card = card_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card: {card}")

    log("== 2. build")
    from stargcn_tpu_torch.ops import _build
    from stargcn_tpu_torch.ops import bitdense as bd

    _, t_build = host_s(_build.build)
    log(f"  nvcc build of {sorted(_build.SIGNATURES)}: {t_build:.2f} s")
    for name, text in _build.build_logs.items():
        # ptxas -v: registers, shared memory and spills of every instance.
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "rror" in line:
                log(f"  [{name}] {line.strip()}")

    log("== 3. kernel check (small cases)")
    worst = small_kernel_checks(bd)

    log("== 4. set-up: ML-10M graph, iterator, trainer, bit packs")
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    (cfg, it, model_cfg), t_graph = host_s(build_ml10m)
    log(f"  host graph build ({ML10M['num_users']} x {ML10M['num_items']}, "
        f"{it.all_graph['user', 'movie'].nnz} edges): {t_graph:.2f} s "
        f"[{card}]")
    check(model_cfg.backend == "bitdense",
          f"ML-10M resolved to {model_cfg.backend!r}, not 'bitdense'")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        trainer, t_trainer = host_s(lambda: Trainer(
            model_cfg, it, TrainSettings.from_cfg(cfg), save_dir=save_dir,
            device=DEVICE))
        log(f"  trainer (parameters, edge arrays, pair lookup): "
            f"{t_trainer:.2f} s [{card}]")
        packs = {}
        for variant in ("train", "test"):
            packs[variant], t_pack = host_s(
                lambda: trainer.variants.bit_pack(variant))
            log(f"  {variant}-variant bit packs (both directions): "
                f"{t_pack:.2f} s; user "
                f"{tuple(packs[variant]['user']['pf'].shape)}, item "
                f"{tuple(packs[variant]['item']['pf'].shape)} [{card}]")
        check(trainer.variants.bit_pack("valid") is packs["train"],
              "the valid variant should share the train variant's packs")

        log("== 5. kernel check (ML-10M packs) and times")
        R = model_cfg.num_links
        F = model_cfg.embed_units + 1    # the ones column carries the bias
        e_worst, e_shapes = full_expand_checks(bd, packs["test"], R, F, card)
        r_worst, r_shapes = full_reduce_checks(bd, packs["train"], R, F,
                                               card)
        adjoint_check(bd, packs["train"], R, F)

        log("== 6. slice: ML-10M bitdense training (20 steps) + serving of "
            "the trained parameters")
        train_launches, train_numbers = run_training_slice(bd, trainer, card)

        log("== 7. slice: ML-10M bitdense serving export + queries")
        export_launches = run_serving_slice(bd, trainer, card)

    kernel_ms = sum(sum(s["ms"] for s in shapes) * 2
                    for shapes in (e_shapes, r_shapes))
    log(f"  one training step: {train_numbers['step_ms']:.1f} ms on the "
        f"host clock, of which the 8 bit-kernel launches take about "
        f"{kernel_ms:.1f} ms on the card (per-launch times of phase 5) "
        f"[{card}]")
    rows = [
        kernel_row("bit_expand_matmul",
                   "stargcn_tpu_torch/ops/csrc/bit_expand.cu",
                   "stargcn_tpu/ops/bitdense.py:328",
                   train_launches["bit_expand_matmul"]
                   + export_launches["bit_expand_matmul"],
                   max(e_worst, worst["bit_expand_matmul"]), e_shapes),
        kernel_row("bit_reduce_matmul",
                   "stargcn_tpu_torch/ops/csrc/bit_reduce.cu",
                   "stargcn_tpu/ops/bitdense.py:360",
                   train_launches["bit_reduce_matmul"],
                   max(r_worst, worst["bit_reduce_matmul"]), r_shapes),
    ]
    rows[0]["launches_by_path"] = {"train_iteration": train_launches[
        "bit_expand_matmul"], "export": export_launches["bit_expand_matmul"]}
    log(json.dumps({"training": train_numbers}))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
