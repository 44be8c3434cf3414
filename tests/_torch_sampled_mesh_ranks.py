"""Rank processes for the sampled mesh tests
(``tests/test_torch_sampled_mesh*.py``, ``tests/test_torch_perfmodel.py``).

Imports the port alone (no JAX), so that a spawned rank starts quickly;
ranks are spawned by ``_torch_mesh_ranks.spawn`` (gloo, a rendezvous file,
two torch threads a rank, a timeout).  The set-up is
``tests/test_sampled_parallel.py:32-57``'s: a 48 x 40 synthetic graph of
600 edges and three rating levels, a two-block model of narrow widths,
batch 32, recon batch 8, fanout 4, on the CPU, with the loop planner
(whose draws are the JAX package's).  A rank writes what it found with
``torch.save``; the test process compares.
"""

import os

import numpy as np
import torch

from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data.synthetic import synthetic_graph
from stargcn_tpu_torch.graph import kernels as K
from stargcn_tpu_torch.models import STARGCNConfig
from stargcn_tpu_torch.parallel import collectives as C
from stargcn_tpu_torch.parallel import make_mesh
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings

GRAPH = dict(num_users=48, num_items=40, num_edges=600,
             rating_values=(1, 2, 3), seed=3)
# tests/test_sampled_parallel.py:146-173: counts no mesh axis divides.
ODD_GRAPH = dict(num_users=45, num_items=37, num_edges=500,
                 rating_values=(1, 2, 3), seed=21)
MODEL = dict(nblocks=2, embed_units=8, agg_units=(12,), out_units=(10,),
             gcn_dropout=0.0, gen_rating_mid_map=6, agg_accum="stack")
FEA = dict(use_fea_proj=True, fea_mid_map=7, fea_units=5)
SETTINGS = dict(rating_batch_size=32, recon_batch_size=8, max_iter=20,
                log_interval=5, valid_interval=10, lr=1e-2, seed=3,
                remove_rating=True)
MESHES = ((2, 1), (1, 2), (2, 2))
FANOUT = 4


def iterator(cls, synth, graph=GRAPH):
    """The graph and split of ``tests/test_sampled_parallel.py`` from either
    package's ``DataIterator`` and ``synthetic_graph``."""
    g = synth(**graph)
    pairs = g["user", "movie"].node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    odd = graph is ODD_GRAPH
    return cls(g, "user", "movie",
               test_node_pairs=pairs[:, perm[:60 if odd else 80]],
               valid_node_pairs=pairs[:, perm[60:100] if odd else
                                      perm[80:140]],
               embed_P_mask=0.21 if odd else 0.2, embed_p_zero=1.0,
               embed_p_self=0.0, seed=11)


def model_cfg(cls, it, **overrides):
    csr = it.all_graph["user", "movie"]
    return cls(num_users=csr.shape[0], num_items=csr.shape[1],
               num_links=len(csr.multi_link), **{**MODEL, **overrides})


def port_trainer(backend="xla", mesh=None, caps=None, graph=GRAPH,
                 model=None, settings=None, **kw):
    """The port's ``SampledTrainer`` of the set-up on the CPU."""
    it = iterator(DataIterator, synthetic_graph, graph)
    K.set_seed(5)
    return SampledTrainer(
        model_cfg(STARGCNConfig, it, **(model or {})), it,
        TrainSettings(**{**SETTINGS, **(settings or {})}), fanout=FANOUT,
        backend=backend, planner="loop", device="cpu", frontier_caps=caps,
        mesh=mesh, **kw)


def batches(trainer, n):
    """The first ``n`` batches of ``trainer``, as ``fit`` builds them."""
    it = trainer.data_iter
    rs = it.rating_sampler(batch_size=trainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    return [trainer._build_batch_safe(rs, recon) for _ in range(n)]


def mesh_of(rank, d, m):
    """A ``d x m`` mesh over the world's first ranks (every rank calls),
    or None on a rank past it."""
    mesh = make_mesh(d, m, devices=range(d * m), device="cpu")
    return mesh if rank < d * m else None


def step_found(t, batch):
    """One step of ``t`` on ``batch``: the statistics and whole gradients
    of the step without its update, then ``train_iteration``'s statistics,
    the collectives it issued and the whole parameters after it."""
    ours = batch if t._plans else None
    stats0, grads = t.loss_and_grads(ours)
    with C.counted() as counts:
        stats = t.train_iteration(ours)
    return {"grad_stats": {k: v.detach().clone() for k, v in stats0.items()},
            "grads": {k: t._whole(k, g) for k, g in grads.items()},
            "stats": {k: v.detach().clone() for k, v in stats.items()},
            "params": t.whole_params(), "counts": counts.by_kind(),
            "local": {k: tuple(p.shape)
                      for k, p in t.model.named_parameters()}}


# ------------------------------ rank bodies ------------------------------

def step_ranks(rank, cases, ckpt, batch, out_dir):
    """Per case ``(name, backend, (d, m), model overrides, swap, trainer
    keywords)``: the trainer from the checkpoint ``ckpt[name]``, one step
    on ``batch`` (``step_found``); ``swap`` replaces
    ``collectives.enter`` in the sampled forward by the identity (a
    conjugate pair the wrong way round)."""
    from stargcn_tpu_torch.models import sampled as sm

    for name, backend, (d, m), model, swap, kw in cases:
        mesh = mesh_of(rank, d, m)
        if mesh is None:
            continue
        t = port_trainer(backend, mesh, caps=ckpt["caps"], model=model, **kw)
        t.restore_checkpoint(ckpt[name])
        real = sm.enter
        if swap:
            sm.enter = lambda x, group: x
        try:
            found = step_found(t, batch)
        finally:
            sm.enter = real
        found["coords"] = mesh.coords
        torch.save(found, os.path.join(out_dir, f"{name}_r{rank}.pt"))


def device_plan(t, batch):
    """The plan ``t`` builds on its device for ``batch`` (a
    ``plan_device`` trainer)."""
    plan, pairs_pos, aux = t._device_plan(
        t._feed(t._pack_batch(batch) if t._plans else None))
    return {"plan": plan, "pairs_pos": pairs_pos,
            "overflow": aux["overflow"]}


def train_ranks(rank, ckpt, batches, out_dir):
    """On a 2 x 2 mesh from the checkpoints of ``ckpt``: ``train_chunk``
    of three batches (dropout 0.3); ``fit`` with evaluation and
    checkpoints; ``plan_device`` (its device plan, and one step);
    ``USE_FEA_PROJ`` (one step); the odd graph (three steps, dropout 0.5);
    then on 1 x 2 a ``fit`` whose first rank's caps are cut so that it
    grows them, and one whose second rank's are."""
    found = {}
    mesh = mesh_of(rank, 2, 2)
    drop = {"gcn_dropout": 0.3}
    t = port_trainer("pallas", mesh, caps=ckpt["caps"], model=drop)
    t.restore_checkpoint(ckpt["pallas"])
    stats = t.train_chunk(batches["main"][:3])
    found["chunk"] = {"stats": stats, "params": t.whole_params()}

    t = port_trainer("xla", mesh, caps=ckpt["caps"], model=drop,
                     save_dir=os.path.join(out_dir, "fit"))
    t.restore_checkpoint(ckpt["xla"])
    K.set_seed(17)
    found["fit"] = {"result": t.fit(max_iter=10, log=lambda *_: None),
                    "params": t.whole_params(), "count": t.opt.count}

    t = port_trainer("xla", mesh, plan_device=True)
    t.restore_checkpoint(ckpt["xla"])
    found["plan_device_plan"] = device_plan(t, batches["device"])
    t = port_trainer("xla", mesh, plan_device=True)
    t.restore_checkpoint(ckpt["xla"])
    stats = t.train_iteration(batches["device"])
    found["plan_device"] = {"stats": stats, "params": t.whole_params()}

    t = port_trainer("xla", mesh, caps=ckpt["caps"], model=FEA)
    t.restore_checkpoint(ckpt["fea"])
    found["fea"] = step_found(t, batches["main"][0])

    t = port_trainer("pallas", mesh, caps=ckpt["odd_caps"], graph=ODD_GRAPH,
                     model={"gcn_dropout": 0.5},
                     settings={"rating_batch_size": 31})
    t.restore_checkpoint(ckpt["odd"])
    found["odd"] = {"stats": [t.train_iteration(b)
                              for b in batches["odd"]],
                    "params": t.whole_params(),
                    "sizes": (t.train_batch_pad, dict(t.recon_cap))}

    mesh = mesh_of(rank, 1, 2)
    for cut in (0, 1):
        if mesh is None:
            break
        t = port_trainer("xla", mesh, caps=ckpt["caps"],
                         settings={"valid_interval": 5})
        t.restore_checkpoint(ckpt["xla"])
        if rank == cut:
            t._take_caps([8, 8])
        K.set_seed(19)
        result = t.fit(max_iter=5, log=lambda *_: None)
        found[f"caps_cut_r{cut}"] = {"caps": dict(t.caps),
                                     "result": result,
                                     "params": t.whole_params()}
    torch.save(found, os.path.join(out_dir, f"train_r{rank}.pt"))


# The steps whose collectives ``tests/test_torch_perfmodel.py`` counts:
# (name, trainer, backend, keyword arguments).
COUNT_CASES = (("full-xla", "full", "xla", {}),
               ("full-bitdense", "full", "bitdense", {}),
               ("sampled-xla", "sampled", "xla", {}),
               ("sampled-pallas", "sampled", "pallas", {}),
               ("sampled-xla-remat", "sampled", "xla", {"remat": True}),
               ("sampled-pallas-remat", "sampled", "pallas", {"remat": True}))


def count_ranks(rank, shapes, out_dir):
    """Per mesh of ``shapes`` and case of ``COUNT_CASES``: the collectives
    of one steady ``train_iteration`` (after a first step), and what
    ``perfmodel.modeled_collectives`` needs to state them."""
    import _torch_mesh_ranks as R

    found = {}
    for d, m in shapes:
        mesh = mesh_of(rank, d, m)
        if mesh is None:
            continue
        for name, kind, backend, kw in COUNT_CASES:
            if kind == "full":
                t = R.port_trainer(backend, mesh)
                it = t.data_iter
                rs = it.rating_sampler(64, "train")
                recon = it.recon_nodes_sampler(batch_size=10 ** 6)

                def step():
                    rb = next(rs)
                    noise, _, ids = next(recon)
                    return t.train_iteration(
                        rb, t.prepare_recon_batch(noise, ids))
                sampled = None
            else:
                t = port_trainer(backend, mesh, caps={"user": 48,
                                                      "item": 40}, **kw)
                bs = batches(t, 2) if t._plans else [None, None]

                def step():
                    return t.train_iteration(bs.pop(0))
                sampled = dict(caps=t.caps, batch=t.train_batch_pad,
                               recon=t.recon_cap, fanout=FANOUT)
            step()
            with C.counted() as counts:
                step()
            found[(d, m, name)] = {"counts": counts.by_kind(),
                                   "calls": counts.calls,
                                   "model_cfg": t.model_cfg,
                                   "backend": backend, "sampled": sampled}
    torch.save(found, os.path.join(out_dir, f"count_r{rank}.pt"))
