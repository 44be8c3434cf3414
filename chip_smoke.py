#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stargcn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the serving path, from ``ops/csrc/``;
3. kernel check: ``bit_expand_matmul`` on the card against its plain
   PyTorch version fed the same bf16-rounded input, on small dense and
   sparse cases and on the full ML-10M packs (a few row blocks compared);
   its time per launch at the main path's shapes beside its bound;
4. slice: the ML-10M-width ``bitdense`` serving export
   (``configs/transductive_ml_10m.yml`` on a synthetic graph of the real
   ML-10M size, random parameters from seed 123) through the kernel,
   checked against the same export through the plain version, then
   ``predict`` and ``recommend`` on the card.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Needs one card; imports nothing of
JAX and nothing of the JAX package.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
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


# ------------------------------ kernel check ------------------------------


def expand_err(bd, P, x, R, d8, rows=None):
    """Max abs error of the kernel against the plain version fed the
    bf16-rounded x, and the tolerance: 1e-4 of the largest output (both
    sum the same bf16 values in float32, in another order)."""
    import torch

    got = bd.bit_expand_matmul(P, x, R, d8)
    xr = x.to(torch.bfloat16).float()
    if rows is None:
        want = bd.xla_expand_matmul(P, xr, R, d8)
    else:
        # Packed rows r*d8 + [m0, m1) of link r: out[r, :, m0:m1].
        r, m0, m1 = rows
        got = got[r:r + 1, :, m0:m1]
        want = bd.xla_expand_matmul(P[r * d8 + m0:r * d8 + m1], xr, 1,
                                    m1 - m0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, 1e-4 * max(scale, 1.0), scale


def small_kernel_checks(bd):
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    worst = 0.0
    # (R, F, dense P, x dtype, D, S): the long-S cases split each packed
    # row across several warps, as the ML-10M item direction does.
    for R, F, dense, xdtype, D, S in (
            (1, 7, False, torch.float32, 2000, 1500),
            (3, 65, True, torch.float32, 2000, 1500),
            (10, 65, False, torch.float32, 2000, 1500),
            (10, 65, True, torch.bfloat16, 2000, 1500),
            (2, 300, True, torch.float32, 2000, 1500),
            (10, 65, False, torch.float32, 300, 70000),
            (3, 65, True, torch.float32, 300, 40000)):
        e = 40000
        P, d8 = bd.pack_bits(rng.randint(0, D, e), rng.randint(0, S, e),
                             rng.randint(0, R, e), R, D, S)
        if dense:
            P = rng.randint(0, 256, P.shape).astype(np.uint8)
        Pt = torch.from_numpy(P).to(DEVICE)
        x = torch.from_numpy(rng.randn(P.shape[1], F).astype(
            np.float32)).to(DEVICE, xdtype)
        err, tol, scale = expand_err(bd, Pt, x, R, d8)
        log(f"  kernel check R={R} F={F} D={D} S={S} "
            f"{'dense' if dense else 'sparse'} x={str(xdtype)[6:]}: "
            f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
            f"tol={tol:.3e}")
        check(err <= tol, f"bit_expand_matmul disagrees (R={R}, F={F})")
        worst = max(worst, err)
    return worst


def bound_ms(P, s_pad, f, R, d8, set_bits):
    """Least time for one expand: P, x and out moved once at the HBM rate,
    or one f32 add per set bit per column at the f32 rate."""
    nbytes = P.numel() + s_pad * f * 4 + R * 8 * d8 * f * 4
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


def full_kernel_checks(bd, pack, R, F, card):
    """The kernel on the full ML-10M packs of the serving path: a few row
    blocks checked, then timed against the plain version and the bound."""
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
        ms = cuda_ms(lambda: bd.bit_expand_matmul(P, x, R, d8), reps=20)
        plain = cuda_ms(lambda: bd.xla_expand_matmul(P, x, R, d8), reps=2)
        ones = set_bits(P)
        bms, by = bound_ms(P, s_pad, F, R, d8, ones)
        shapes.append(dict(direction=direction, P=list(P.shape), F=F,
                           set_bits=ones, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by))
        log(f"  bit_expand_matmul {direction} P={tuple(P.shape)} F={F}: "
            f"kernel {ms:.4f} ms/launch, plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms ({by}), set bits {ones} [{card}]")
    return worst, shapes


# --------------------------------- slice ---------------------------------


def build_ml10m():
    """The ML-10M-shaped synthetic graph and its split (seed 123, 10% test,
    10% valid), and the model config of ``transductive_ml_10m.yml``."""
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
                      embed_P_mask=0.1, embed_p_zero=0.0, embed_p_self=1.0,
                      seed=SEED)
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link))
    return it, model_cfg


def plain_twin(state):
    """The same serving state with the model on the plain version."""
    from stargcn_tpu_torch.models import STARGCN

    twin = copy.copy(state)
    twin.model = STARGCN(dataclasses.replace(state.model_cfg,
                                             bit_impl="xla"))
    twin.model.load_state_dict(state.model.state_dict())
    twin.model.to(state.device).eval()
    return twin


def rel_err(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def run_slice(bd, card):
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import Predictor, ServingState, \
        export_serving

    (it, model_cfg), t_graph = host_s(build_ml10m)
    log(f"  host graph build ({ML10M['num_users']} x {ML10M['num_items']}, "
        f"{it.all_graph['user', 'movie'].nnz} edges): {t_graph:.2f} s "
        f"[{card}]")
    check(model_cfg.backend == "bitdense",
          f"ML-10M resolved to {model_cfg.backend!r}, not 'bitdense'")
    state, t_state = host_s(lambda: ServingState(model_cfg, it,
                                                 device=DEVICE, seed=SEED))
    log(f"  serving state (params, edge arrays): {t_state:.2f} s [{card}]")
    pack, t_pack = host_s(lambda: state.bit_pack("test"))
    log(f"  test-variant bit packs (both directions): {t_pack:.2f} s; "
        f"user {tuple(pack['user']['pf'].shape)}, "
        f"item {tuple(pack['item']['pf'].shape)} [{card}]")
    state.variant_degrees("test")

    R = model_cfg.num_links
    F = model_cfg.embed_units + 1      # the ones column carries the bias
    worst, shapes = full_kernel_checks(bd, pack, R, F, card)

    # ---- the main path: counts from 0, one export, counts read ----
    for k in bd.LAUNCHES:
        bd.LAUNCHES[k] = 0
    art, t_export = host_s(lambda: export_serving(state, segment="test"))
    launches = dict(bd.LAUNCHES)
    log(f"  export through the kernel: {t_export:.3f} s, launches "
        f"{launches} [{card}]")
    check(launches["bit_expand_matmul"] == 4,
          f"expected 4 bit_expand_matmul launches, got {launches}")

    ref, t_ref = host_s(lambda: export_serving(plain_twin(state),
                                               segment="test"))
    eu = rel_err(art.user_feats, ref.user_feats)
    ei = rel_err(art.item_feats, ref.item_feats)
    log(f"  export through the plain version: {t_ref:.3f} s; U rel err "
        f"{eu:.3e}, I rel err {ei:.3e} (tol 1e-2: the kernel rounds its "
        f"input to bf16, the plain version does not)")
    check(art.user_feats.shape == (ML10M["num_users"], 64)
          and art.item_feats.shape == (ML10M["num_items"], 64),
          "artifact shapes")
    check(np.isfinite(art.user_feats).all()
          and np.isfinite(art.item_feats).all(), "non-finite features")
    check(eu <= 1e-2 and ei <= 1e-2, "kernel export disagrees with plain")

    # ---- serving on the card ----
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
    log(f"  predict 4096 pairs: {t_pred * 1e3:.2f} ms; recommend k=10 for "
        f"256 users: {t_rec * 1e3:.2f} ms [{card}]")

    n = sum(s["set_bits"] for s in shapes)
    mean = lambda key: sum(s[key] for s in shapes) / len(shapes)  # noqa
    return dict(
        name="bit_expand_matmul", route="cuda",
        source="stargcn_tpu_torch/ops/csrc/bit_expand.cu",
        replaces="stargcn_tpu/ops/bitdense.py:328",
        launches=launches["bit_expand_matmul"], max_abs_err=worst,
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=None, shapes=shapes, set_bits=n)


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
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")

    log("== 3. kernel check (small cases)")
    small_worst = small_kernel_checks(bd)

    log("== 4. slice: ML-10M bitdense serving export + queries")
    row = run_slice(bd, card)
    row["max_abs_err"] = max(row["max_abs_err"], small_worst)

    log(json.dumps({"kernels": [row]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
