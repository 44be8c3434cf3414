"""Sampled training on a graph past the card's memory.

    python -m stargcn_tpu_torch.train.beyond_hbm [--users 400000
        --items 50000 --edges 50000000 --iters 200 --batch 4096
        --fanout 8 --scan 5 --plan_device --bf16 --device cuda]
    python -m stargcn_tpu_torch.train.beyond_hbm --routes host,device

The port of ``scripts/beyond_hbm_demo.py``: a synthetic rating graph of
400,000 users x 50,000 items, 50M edges and 10 rating levels (0.5 to 5.0,
seed 7), with 200,000 held-out pairs split in half between test and valid,
trained in sampled mini-batches (``SampledTrainer(fanout=8, remat=True)``)
under ``configs/transductive_ml_10m.yml`` at its published widths, batch
4096, recon 1024.  Sampled mode's step holds the frontiers of one batch,
not the graph: what lies on the card is the parameters (the embedding
tables grow with the node counts) and a step's frontiers under their caps.

Two routes (``--routes``; ``--plan_device`` alone is the device route):

* ``host``: plans on the host (the native planner), ``backend='pallas'``,
  so every step pools through the ELL kernels (``ops/csrc/ell_spmm.cu``,
  ``ell_spmm_t.cu``);
* ``device``: ``plan_device=True`` on ``'xla'``; at this scale the caps lie
  below both node counts (the planner's dedup path) and the id product
  ``users x items`` is beyond int32 (its REMOVE_RATING keys are int64).

The device route keeps each cap below its node count wherever the probed
frontier lies below it (``dedup_caps``): the trainer's rule (1.6 times the
probed frontier) can reach the count, and there the device planner samples
every node of the type (its dense path) instead of deduplicating.  Before
the timed window it runs the JAX script's pre-flight: probe chunks until
none overflows its caps, growing them (``_grow_caps``, then
``dedup_caps``) past what the rejected steps needed, so that the timed
window trains on no rejected step (it counts any that are).  The host
route keeps the trainer's caps, grows them while planning and rejects
nothing.

Prints one JSON line a route: the JAX script's keys (``first_step_s`` in
place of its ``compile_s``), and ``card`` (name and power limit),
``card_memory_gb``, ``peak_step_gib`` (the timed window's
``max_memory_allocated``), ``host_peak_rss_gib`` (the process's peak
resident memory so far: the graph build's, as a rule),
``full_graph_bytes`` and ``full_graph_possible`` per full-graph backend
(``full_graph_bytes``, computed from the port's own operands at this scale
against the card's memory), and ``launches`` of the ELL kernels in one
steady step.
``--device cpu`` runs on the CPU (small sizes only; no card numbers).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LEVELS = tuple(np.arange(0.5, 5.01, 0.5))
CAP_SLACK = 1.6     # SampledTrainer's factor over the probed frontiers
GROW_SLACK = 1.15   # the JAX script's pre-flight growth


def dedup_caps(caps, nodes, needed):
    """The device route's caps: each of ``caps`` lowered to the largest
    multiple of 256 below its node count in ``nodes`` where the frontier
    it must hold (``needed``, an upper bound) lies below that; else kept.
    A cap at or past its count sends the device planner down its dense
    path, which samples every node of the type."""
    out = {}
    for t, cap in caps.items():
        below = (nodes[t] - 1) // 256 * 256
        out[t] = below if cap > below and needed[t] < below else cap
    return out


def full_graph_bytes(num_users, num_items, num_links, num_edges, ell_k=64):
    """Bytes of the static operands that each full-graph backend would hold
    on the card for this graph (a lower bound of its footprint: no
    parameters, no activations), for training alone (the train variant,
    which validation shares) and with evaluation (the test variant too), as
    ``train/loop.py:GraphVariants`` builds them:

    * ``bitdense``: a variant's two bit layouts, ``R * D8 * S_pad`` bytes
      each (``ops/bitdense.py:pad_dims``; about ``R * Nu * Ni / 8``);
    * ``dense``: one bf16 ``(R, Nu, Ni)`` adjacency a variant;
    * ``xla``: the padded edge arrays (user, item, rating, pad mask, and
      the pair lookup's keys and permutation where ``Nu * Ni`` fits int32;
      4 B each) and a float32 mask and two degree vectors a variant;
    * ``ell``: a variant's chunked-ELL arrays in both directions at width
      ``ell_k`` (int32 index and rating a slot, a destination a row), rows
      counted as if every node's edges filled its rows (``ceil(deg / K)``
      rows a node, at most ``E / K + nodes``).
    """
    from stargcn_tpu_torch.ops.bitdense import pad_dims

    R, nu, ni, E = int(num_links), int(num_users), int(num_items), \
        int(num_edges)
    d8u, _, s_i = pad_dims(nu, ni)
    d8i, _, s_u = pad_dims(ni, nu)
    e_pad = -(-E // 256) * 256
    rows = E // ell_k + nu + E // ell_k + ni
    per_variant = {
        "bitdense": R * d8u * s_i + R * d8i * s_u,
        "dense": 2 * R * nu * ni,
        "xla": 4 * e_pad + 4 * (nu + ni),
        "ell": rows * ell_k * 8 + rows * 4,
    }
    edge_arrays = 6 if nu * ni < 2**31 else 4
    shared = {"bitdense": 0, "dense": 0, "xla": edge_arrays * 4 * e_pad,
              "ell": 0}
    return {k: {"train": shared[k] + v, "train_and_eval": shared[k] + 2 * v}
            for k, v in per_variant.items()}


def full_graph_possible(fg, memory):
    """Per backend and kind (``full_graph_bytes``'s), whether its static
    operands fit in ``memory`` bytes."""
    return {k: {kind: b < memory for kind, b in v.items()}
            for k, v in fg.items()}


def build_graph(users=400_000, items=50_000, edges=50_000_000, seed=7,
                holdout=200_000, log=logging.info):
    """``(data_iter, build_s)``: the JAX script's synthetic graph and split
    (``n_hold = min(holdout, edges // 5)`` pairs from a permutation of
    ``RandomState(seed)``, the first half test, the rest valid)."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph

    t0 = time.time()
    g = synthetic_graph(num_users=users, num_items=items, num_edges=edges,
                        rating_values=LEVELS, seed=seed)
    csr = g["user", "movie"]
    rng = np.random.RandomState(seed)
    pairs = csr.node_pair_ids
    n_hold = min(holdout, pairs.shape[1] // 5)
    hold = rng.permutation(pairs.shape[1])[:n_hold]
    it = DataIterator(g, "user", "movie",
                      test_node_pairs=pairs[:, hold[:n_hold // 2]],
                      valid_node_pairs=pairs[:, hold[n_hold // 2:]],
                      embed_P_mask=0.1, embed_p_zero=0.0,
                      embed_p_self=1.0, seed=seed)
    build_s = time.time() - t0
    log(f"# graph built: {csr.nnz} edges in {build_s:.1f} s")
    return it, build_s


def run(users=400_000, items=50_000, edges=50_000_000, iters=200,
        batch=4096, fanout=8, plan_device=False, scan=5, seed=7,
        holdout=200_000, bf16=False, device="cuda", built=None,
        log=logging.info):
    """One route of the run (``plan_device``: the device route); returns
    its JSON dict.  ``built``: ``build_graph``'s ``(data_iter, build_s)``
    for these arguments, to share one graph between routes."""
    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.ops import ell_kernels as ek
    from stargcn_tpu_torch.train.loop import TrainSettings
    from stargcn_tpu_torch.train.sampled_loop import SampledTrainer
    from stargcn_tpu_torch.utils import cfg_from_file, default_cfg
    from stargcn_tpu_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    it, build_s = built or build_graph(users, items, edges, seed, holdout,
                                       log)
    csr = it.all_graph["user", "movie"]
    cfg = default_cfg()
    cfg_from_file(os.path.join(ROOT, "configs", "transductive_ml_10m.yml"),
                  cfg)
    cfg.DATASET.NAME = "synthetic"
    cfg.TRAIN.RATING_BATCH_SIZE = batch
    cfg.TRAIN.RECON_BATCH_SIZE = 1024
    cfg.TRAIN.MAX_ITER = iters
    cfg.TRAIN.VALID_INTERVAL = max(iters // 2, 10)
    cfg.TRAIN.LOG_INTERVAL = 10
    if bf16:
        cfg.MODEL.COMPUTE_DTYPE = "bfloat16"
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link), num_edges=csr.nnz)
    gk.set_seed(seed)
    t0 = time.time()
    trainer = SampledTrainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                             fanout=fanout, plan_device=plan_device,
                             remat=True, device=dev, cap_slack=CAP_SLACK,
                             backend="xla" if plan_device else "pallas")
    n = {"user": csr.shape[0], "item": csr.shape[1]}
    probed_caps = dict(trainer.caps)
    if plan_device:
        # cap / slack bounds the probed frontier from above
        caps = dedup_caps(trainer.caps, n, {t: c / CAP_SLACK
                                            for t, c in trainer.caps.items()})
        trainer._take_caps((caps["user"], caps["item"]))
    setup_s = time.time() - t0
    log(f"# trainer ready in {setup_s:.1f} s; caps {trainer.caps} "
        f"(backend {trainer.backend}, remove_rating={trainer.do_remove})")

    rs = it.rating_sampler(batch_size=trainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=1024)

    def chunk():
        return [trainer._build_batch_safe(rs, recon) for _ in range(scan)]

    def host_stats(stats):
        return {k: v.detach().cpu().numpy() for k, v in stats.items()}

    t0 = time.time()
    first = host_stats(trainer.train_chunk(chunk()))
    first_step_s = time.time() - t0
    log(f"# first chunk of {scan} steps in {first_step_s:.1f} s")
    preflight = []
    if plan_device:
        # The JAX script's pre-flight: the device planner's dense side
        # samples every node of a clamped type, so a frontier can need more
        # than the host-probed caps; grow until a probe chunk fits.
        st = first
        for _ in range(4):
            if not int(st["overflow"].sum()):
                break
            need = {t: int(st[f"needed_{t}"].max()) for t in ("user", "item")}
            log(f"# overflow pre-flight: growing caps to cover {need}")
            trainer._grow_caps(need, slack=GROW_SLACK)
            caps = dedup_caps(trainer.caps, n, need)
            trainer._take_caps((caps["user"], caps["item"]))
            preflight.append(need)
            st = host_stats(trainer.train_chunk(chunk()))
        log(f"# caps after pre-flight: {trainer.caps}")

    losses, overflow_steps = [], 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    pending = []
    n_chunks = max(iters // scan, 1)
    for i in range(n_chunks):
        pending.append(trainer.train_chunk(chunk()))
        if (i + 1) % 4 == 0 or i == n_chunks - 1:
            # bound the queue: each chunk's feeds stay alive until read
            for st in map(host_stats, pending):
                losses.extend(st["loss"].reshape(-1).tolist())
                if "overflow" in st:
                    overflow_steps += int(st["overflow"].sum())
            pending.clear()
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    steps_done = n_chunks * scan
    log(f"# {steps_done} steps in {train_s:.1f} s "
        f"({train_s / steps_done * 1e3:.1f} ms/step), {overflow_steps} "
        "rejected on overflow")

    # ELL launches of one steady step (rows 5 and 6 of the kernel table).
    step_batch = trainer._build_batch_safe(rs, recon)
    for k in ek.LAUNCHES:
        ek.LAUNCHES[k] = 0
    trainer.train_iteration(step_batch)
    if cuda:
        torch.cuda.synchronize(dev)
    launches = dict(ek.LAUNCHES)
    t0 = time.time()
    rmse = trainer.evaluate("valid")
    eval_s = time.time() - t0

    card = card_line(dev)
    mem = torch.cuda.get_device_properties(dev).total_memory if cuda else None
    fg = full_graph_bytes(n["user"], n["item"], len(csr.multi_link),
                          csr.nnz, model_cfg.ell_k)
    out = {
        "metric": "beyond_hbm_sampled_training",
        "graph": f"{n['user']}x{n['item']}, {csr.nnz} edges, "
                 f"{len(csr.multi_link)} levels",
        "bitdense_layout_gb": fg["bitdense"]["train"] / 2 / 1e9,
        "card": card,
        "card_memory_gb": None if mem is None else mem / 1e9,
        "full_graph_bytes": fg,
        "full_graph_possible": (None if mem is None
                                else full_graph_possible(fg, mem)),
        "device": str(dev),
        "plan_device": bool(plan_device),
        "backend": trainer.backend,
        "scan_steps": scan,
        "steps_per_s": steps_done / train_s,
        "ms_per_step": train_s / steps_done * 1e3,
        "rating_pairs_per_s": steps_done * trainer.train_batch / train_s,
        "loss_first10": float(np.mean(losses[:10])),
        "loss_last10": float(np.mean(losses[-10:])),
        "loss_decreased": bool(np.mean(losses[-10:]) < np.mean(losses[:10])),
        "losses_finite": bool(np.isfinite(losses).all()),
        "valid_rmse": [float(x) for x in np.asarray(rmse)],
        "eval_s": eval_s,
        "graph_build_s": build_s,
        "trainer_setup_s": setup_s,
        "first_step_s": first_step_s,
        "peak_step_gib": None if peak is None else peak / 2**30,
        "host_peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "probed_caps": probed_caps,
        "frontier_caps": dict(trainer.caps),
        "dedup_regime": {t: trainer.caps[t] < n[t] for t in n},
        "remove_rating": bool(trainer.do_remove),
        "overflow_steps": overflow_steps,
        "preflight_growth": preflight,
        "id_product": n["user"] * n["item"],
        "launches": launches,
    }
    if plan_device:
        b = trainer._pack_batch(trainer._build_batch_safe(rs, recon))
        out["feed_mb"] = (b[0].nbytes + b[1].nbytes) / 1e6
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", type=int, default=400_000)
    p.add_argument("--items", type=int, default=50_000)
    p.add_argument("--edges", type=int, default=50_000_000)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--fanout", type=int, default=8)
    p.add_argument("--scan", type=int, default=5)
    p.add_argument("--holdout", type=int, default=200_000)
    p.add_argument("--plan_device", action="store_true",
                   help="the device route alone (--routes device)")
    p.add_argument("--routes", default=None,
                   help="host, device or host,device (one graph built "
                        "for all); default host, or device with "
                        "--plan_device")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    routes = (args.routes.split(",") if args.routes
              else ["device" if args.plan_device else "host"])
    if not set(routes) <= {"host", "device"}:
        p.error("--routes takes host, device or host,device")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    built = build_graph(args.users, args.items, args.edges, 7, args.holdout)
    outs = []
    for route in routes:
        outs.append(run(users=args.users, items=args.items,
                        edges=args.edges, iters=args.iters,
                        batch=args.batch, fanout=args.fanout,
                        plan_device=route == "device", scan=args.scan,
                        holdout=args.holdout, bf16=args.bf16,
                        device=args.device, built=built))
        print(json.dumps(outs[-1]), flush=True)
    return outs


if __name__ == "__main__":
    main()
