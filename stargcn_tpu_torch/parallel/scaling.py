"""Training-step throughput across mesh shapes, beside the collectives
each step issued and the ones ``perfmodel`` states for it.

The port's twin of ``experiments/scaling.py``.  For each ``DATAxMODEL``
mesh of ``--meshes`` it times the full-graph step (``Trainer`` on
``bitdense``) and the sampled step (``SampledTrainer`` on ``pallas``,
fanout 8, recon batch 1024) on a synthetic graph, and prints one JSON row
per mesh: ms per step, examples (rating pairs) per second, and the counted
collectives of one steady step with ``perfmodel.modeled_collectives``
beside them (``equal``: call for call and byte for byte).  The sampled
row adds ``plan_ms`` (the first rank's host plan of a batch) and, where
``1x1`` came first in ``--meshes``, ``projected_step_ms``
(``perfmodel.project`` fed the 1 x 1 step and its part past the plan)::

    python -m stargcn_tpu_torch.parallel.scaling --meshes 1x1,1x2,2x2
    python -m stargcn_tpu_torch.parallel.scaling --meshes 1x1,2x1 \\
        --device cpu --num_users 64 --num_items 64 --num_edges 800
    python -m stargcn_tpu_torch.parallel.scaling --ml10m --batch 4096 \\
        --meshes 1x1,1x2,2x1,2x2,1x4,4x1
    python -m stargcn_tpu_torch.parallel.scaling --project --sampled \\
        --step-ms 220 --split-ms 30 --batch 4096

By default the graph is small (1,024 x 1,024 nodes, 100,000 ratings) and
the model ``twin_model_cfg``'s; ``--ml10m`` takes ML-10M's node counts,
10,000,000 ratings on its 10 levels and ``transductive_ml_10m.yml``'s
model, the size ``--project`` projects.

The ranks (as many as the largest mesh has) are spawned here.  On
``cuda`` each takes a card and NCCL when there are enough cards, else
they share the card over gloo (``--backend gloo``); ranks that share one
card measure correctness, not scaling, and every row they print says so
(``"shared_card": true``).  ``--project`` prints ``perfmodel.project``'s
table for ``transductive_ml_10m.yml`` at the ML-10M node counts from a
step measured on one card (``--step-ms``) and the part of it that the mesh
divides (``--split-ms``, measured: the device step for ``--sampled``, the
edge and bit-pack work otherwise); H100 constants only; ``--sampled``: the
sampled step at ``chip_smoke.py`` phase 8's caps; it runs nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

FULL_BACKEND, SAMPLED_BACKEND = "bitdense", "pallas"
FANOUT, RECON_BATCH = 8, 1024
# ML-10M's node counts and rating levels, and the frontier caps that
# chip_smoke.py phase 8 probes there (batch 4096, fanout 8).
ML10M = (69_878, 10_677, 10)
ML10M_CAPS = {"user": 87_552, "item": 17_408}
ML10M_EDGES = 10_000_000


def _parse_meshes(text):
    return [tuple(int(x) for x in part.lower().split("x"))
            for part in text.split(",") if part]


def synthetic_iterator(num_users, num_items, num_edges, seed=0,
                       rating_values=None):
    """A synthetic graph (``data.synthetic.synthetic_graph``; its default
    rating levels unless ``rating_values``) split 20% test, 10% valid."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph

    kw = {} if rating_values is None else {"rating_values": rating_values}
    g = synthetic_graph(num_users=num_users, num_items=num_items,
                        num_edges=num_edges, seed=seed, **kw)
    pairs = g["user", "movie"].node_pair_ids
    perm = np.random.RandomState(seed).permutation(pairs.shape[1])
    n_test, n_valid = pairs.shape[1] // 5, pairs.shape[1] // 10
    return DataIterator(g, "user", "movie",
                        test_node_pairs=pairs[:, perm[:n_test]],
                        valid_node_pairs=pairs[:, perm[n_test:n_test
                                                        + n_valid]],
                        embed_P_mask=0.1, embed_p_zero=0.0, embed_p_self=1.0,
                        seed=seed)


def twin_model_cfg(it, backend):
    """The twins' small model (``__graft_entry__._make_trainer``'s: embed
    32, aggregator 250 ``sum``, out 75, dropout 0.5) on ``it``'s graph."""
    from stargcn_tpu_torch.models import STARGCNConfig

    csr = it.all_graph["user", "movie"]
    return STARGCNConfig(num_users=csr.shape[0], num_items=csr.shape[1],
                         num_links=len(csr.multi_link), embed_units=32,
                         agg_units=(250,), agg_accum="sum", out_units=(75,),
                         gcn_dropout=0.5, gen_rating_mid_map=64,
                         backend=backend)


def ml10m_model_cfg(num_users, num_items, num_links, backend):
    """``transductive_ml_10m.yml``'s model at these node counts."""
    import dataclasses

    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.utils import cfg_from_file, default_cfg

    cfg = default_cfg()
    cfg_from_file(os.path.join(os.path.dirname(__file__), "..", "..",
                               "configs", "transductive_ml_10m.yml"), cfg)
    return dataclasses.replace(
        build_model_config(cfg, num_users, num_items, num_links),
        backend=backend)


def _setup(args):
    """``(data iterator, model config of a backend)`` of the run."""
    if not args.ml10m:
        it = synthetic_iterator(args.num_users, args.num_items,
                                args.num_edges)
        return it, lambda backend: twin_model_cfg(it, backend)
    users, items, levels = ML10M
    it = synthetic_iterator(users, items, ML10M_EDGES, rating_values=tuple(
        np.arange(0.5, 5.01, 0.5)))
    csr = it.all_graph["user", "movie"]
    assert len(csr.multi_link) == levels, csr.multi_link
    return it, lambda backend: ml10m_model_cfg(
        csr.shape[0], csr.shape[1], len(csr.multi_link), backend)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(step, steps, device):
    """``(ms per step, the counted collectives of one more step)``."""
    from stargcn_tpu_torch.parallel import collectives as C

    step()                              # the first step agrees on shapes
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    with C.counted() as counts:
        step()
    return ms, counts.by_kind()


def measure_rank(rank, args, out):
    """Every mesh of ``args.meshes`` on this rank; rank 0 puts one row a
    mesh into ``out``."""
    from stargcn_tpu_torch.models.stargcn import feature_dims
    from stargcn_tpu_torch.parallel import make_mesh
    from stargcn_tpu_torch.parallel.perfmodel import (modeled_collectives,
                                                      project)
    from stargcn_tpu_torch.train import (SampledTrainer, Trainer,
                                         TrainSettings)

    device = args.device
    one = None          # the 1 x 1 sampled step: (step ms, plan ms)
    it, model_cfg = _setup(args)
    s = TrainSettings(rating_batch_size=args.batch,
                      recon_batch_size=RECON_BATCH, lr=2e-3,
                      grad_clip=1.0, seed=0, hang_timeout_s=0.0)
    for d, m in args.meshes:
        mesh = make_mesh(d, m, devices=range(d * m), device=device)
        if rank >= d * m:
            continue
        row = {"mesh": f"{d}x{m}", "ranks": d * m,
               "backend": mesh.backend, "device": device,
               "shared_card": args.shared_card}
        if args.shared_card:
            row["note"] = ("ranks share one card: these numbers check "
                           "correctness, they do not measure scaling")
        t = Trainer(model_cfg(FULL_BACKEND), it, s, device=device,
                    mesh=mesh)
        ratings = it.rating_sampler(batch_size=t.train_batch,
                                    segment="train")
        recon = it.recon_nodes_sampler(batch_size=10 ** 6)
        rb = next(ratings)
        noise, _, ids = next(recon)
        cb = t.prepare_recon_batch(noise, ids)
        ms, counted = _timed(lambda: t.train_iteration(rb, cb), args.steps,
                             device)
        modeled = modeled_collectives(t.model_cfg, d, m, FULL_BACKEND,
                                      feature_dims=feature_dims(it))
        row["full_graph"] = {
            "model_backend": FULL_BACKEND, "step_ms": ms,
            "examples_per_s": t.train_batch / ms * 1e3,
            "counted": counted, "modeled": modeled,
            "equal": counted == modeled}
        del t
        st = SampledTrainer(model_cfg(FULL_BACKEND), it, s,
                            fanout=FANOUT, backend=SAMPLED_BACKEND,
                            device=device, mesh=mesh)
        rs = it.rating_sampler(batch_size=st.train_batch, segment="train")
        rc = it.recon_nodes_sampler(batch_size=st.s.recon_batch_size)
        plan_s = []

        def sampled_step():
            t0 = time.perf_counter()
            batch = st._build_batch_safe(rs, rc)
            plan_s.append(time.perf_counter() - t0)
            st.train_iteration(batch)

        ms, counted = _timed(sampled_step, args.steps, device)
        plan_ms = sum(plan_s[1:-1]) / args.steps * 1e3
        sampled = dict(caps=st.caps, batch=st.train_batch_pad,
                       recon=st.recon_cap, fanout=FANOUT)
        modeled = modeled_collectives(st.model_cfg, d, m, SAMPLED_BACKEND,
                                      sampled=sampled,
                                      feature_dims=feature_dims(it))
        row["sampled"] = {
            "sampled_backend": SAMPLED_BACKEND, "step_ms": ms,
            "plan_ms": plan_ms,
            "examples_per_s": st.train_batch / ms * 1e3,
            "caps": st.caps, "counted": counted, "modeled": modeled,
            "equal": counted == modeled}
        if (d, m) == (1, 1):
            one = (ms, plan_ms)
        if one is not None:
            # The 1 x 1 step's part past the first rank's plan divided
            # over 'data' (its pack and feed too: an optimistic split).
            row["sampled"]["projected_step_ms"] = project(
                st.model_cfg, step_s_1card=one[0] * 1e-3,
                split_s_1card=(one[0] - one[1]) * 1e-3,
                batch=st.train_batch, backend=SAMPLED_BACKEND,
                sampled=sampled, meshes=((d, m),),
                feature_dims=feature_dims(it))[0]["step_ms"]
        del st
        if rank == 0:
            out.put(json.dumps(row))


def project_table(args):
    """``perfmodel.project`` for ``transductive_ml_10m.yml`` at ML-10M's
    node counts, from ``--step-ms`` and ``--split-ms``."""
    from stargcn_tpu_torch.parallel.perfmodel import project

    backend = SAMPLED_BACKEND if args.sampled else FULL_BACKEND
    model_cfg = ml10m_model_cfg(*ML10M, FULL_BACKEND)
    sampled = None
    if args.sampled:
        sampled = dict(caps=ML10M_CAPS, batch=args.batch,
                       recon={"user": RECON_BATCH, "item": RECON_BATCH},
                       fanout=FANOUT)
    rows = project(model_cfg, step_s_1card=args.step_ms * 1e-3,
                   split_s_1card=args.split_ms * 1e-3, batch=args.batch,
                   backend=backend, sampled=sampled, meshes=args.meshes)
    for row in rows:
        print(json.dumps(row))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", default="1x1", type=_parse_meshes,
                    help="comma list of DATAxMODEL shapes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda with a card "
                         "a rank, else gloo)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--num_users", type=int, default=1024)
    ap.add_argument("--num_items", type=int, default=1024)
    ap.add_argument("--num_edges", type=int, default=100_000)
    ap.add_argument("--ml10m", action="store_true",
                    help="ML-10M's node counts, ratings and levels, and "
                         "transductive_ml_10m.yml's model")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--project", action="store_true",
                    help="print the projection table (no execution)")
    ap.add_argument("--step-ms", dest="step_ms", type=float, default=None,
                    help="the step measured on one card, ms")
    ap.add_argument("--split-ms", dest="split_ms", type=float, default=None,
                    help="the part of --step-ms that the mesh divides, "
                         "measured, ms")
    ap.add_argument("--sampled", action="store_true",
                    help="project the sampled step (split over 'data')")
    args = ap.parse_args(argv)
    if args.project:
        if args.step_ms is None or args.split_ms is None:
            ap.error("--project needs --step-ms and --split-ms")
        if args.meshes == [(1, 1)]:
            args.meshes = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1))
        return project_table(args)
    world = max(d * m for d, m in args.meshes)
    import torch.multiprocessing as mp

    from stargcn_tpu_torch.parallel.mesh import rank_backend, spawn_ranks

    try:
        backend, args.shared_card = rank_backend(args.device, world)
    except RuntimeError as e:
        sys.exit(str(e))
    backend = args.backend or backend

    out = mp.get_context("spawn").SimpleQueue()
    spawn_ranks(measure_rank, world, (args, out), device=args.device,
                backend=backend, timeout=args.timeout)
    rows = []
    while not out.empty():
        rows.append(json.loads(out.get()))
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
