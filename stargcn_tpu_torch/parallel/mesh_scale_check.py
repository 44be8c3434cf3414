"""Mesh check at a given rank count and shape, with node counts that the
'model' axis does not divide.

The port's twin of ``scripts/mesh_scale_check.py``: ``N`` spawned ranks
run, on a ``DATA x MODEL`` mesh,

* a full-graph training step on ``bitdense`` and on ``xla`` (the
  embedding tables stay whole: their rows do not split),
* a sampled training step on ``pallas`` and on ``xla``, its frontier caps
  at the node counts so that every 'data' rank pools real rows and the
  last one padded ones,

each finite and with the collectives it issued equal, call for call and
byte for byte, to ``perfmodel.modeled_collectives``::

    python -m stargcn_tpu_torch.parallel.mesh_scale_check 4 2 2
    python -m stargcn_tpu_torch.parallel.mesh_scale_check 4 1 4 --device cpu

On ``cuda`` (the default) each rank takes a card over NCCL where there
are enough cards, else the ranks share the card over gloo; ``--device
cpu`` runs them on the CPU over gloo.  Prints ``MESH SCALE OK`` on
success.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _step(trainer, make_batch, sampled=None, backend=None):
    """One step's loss and whether its counted collectives equal the
    model's (``(loss, counted, modeled)``)."""
    from stargcn_tpu_torch.models.stargcn import feature_dims
    from stargcn_tpu_torch.parallel import collectives as C
    from stargcn_tpu_torch.parallel.perfmodel import modeled_collectives

    batch = make_batch()
    # The first step agrees on the packed spec; count a steady one.
    trainer.train_iteration(*batch)
    batch = make_batch()
    with C.counted() as counts:
        stats = trainer.train_iteration(*batch)
    d, m = trainer.mesh.shape["data"], trainer.mesh.shape["model"]
    modeled = modeled_collectives(
        trainer.model_cfg, d, m, backend or trainer.model_cfg.backend,
        sampled=sampled, feature_dims=feature_dims(trainer.data_iter))
    return float(stats["loss"]), counts.by_kind(), modeled


def check_rank(rank, data_ax, model_ax, device, out):
    """One rank of the check; rank 0 puts its line into ``out``."""
    import dataclasses

    from stargcn_tpu_torch.parallel import make_mesh
    from stargcn_tpu_torch.parallel.scaling import (synthetic_iterator,
                                                    twin_model_cfg)
    from stargcn_tpu_torch.train import (SampledTrainer, Trainer,
                                         TrainSettings)

    mesh = make_mesh(data_ax, model_ax, device=device)
    nodes = 8 * max(model_ax, 2) + 5
    assert model_ax <= 1 or nodes % model_ax, "want node counts it splits"
    it = synthetic_iterator(nodes, nodes + 2, 8 * nodes)
    csr = it.all_graph["user", "movie"]
    base = twin_model_cfg(it, "bitdense")
    s = TrainSettings(rating_batch_size=8 * data_ax, recon_batch_size=8,
                      lr=2e-3, grad_clip=1.0, seed=0, hang_timeout_s=0.0)
    found = []
    for backend in ("bitdense", "xla"):
        t = Trainer(dataclasses.replace(base, backend=backend), it, s,
                    device=device, mesh=mesh)
        ratings = it.rating_sampler(batch_size=t.train_batch,
                                    segment="train")
        recon = it.recon_nodes_sampler(batch_size=10 ** 6)

        def full_batch():
            rb = next(ratings)
            noise, _, ids = next(recon)
            return rb, t.prepare_recon_batch(noise, ids)

        found.append((f"full-graph {backend}",) + _step(t, full_batch))
    small = dataclasses.replace(base, embed_units=8, agg_units=(15,),
                                out_units=(10,), gcn_dropout=0.0,
                                gen_rating_mid_map=8)
    caps = {"user": csr.shape[0], "item": csr.shape[1]}
    for backend in ("pallas", "xla"):
        st = SampledTrainer(small, it, s, fanout=4, backend=backend,
                            frontier_caps=caps, device=device, mesh=mesh)
        rs = it.rating_sampler(batch_size=st.train_batch, segment="train")
        rc = it.recon_nodes_sampler(batch_size=st.s.recon_batch_size)
        sampled = dict(caps=st.caps, batch=st.train_batch_pad,
                       recon=st.recon_cap, fanout=4)
        found.append((f"sampled {backend} "
                      f"({st.samplers['train'].planner} planner)",) + _step(
            st, lambda: (st._build_batch_safe(rs, rc),), sampled, backend))
    for name, loss, counted, modeled in found:
        assert np.isfinite(loss), f"{name}: loss {loss}"
        assert counted == modeled, (f"{name} on rank {rank}: counted "
                                    f"{counted}, modeled {modeled}")
    if rank == 0:
        parts = [f"{name} loss={loss:.4f} "
                 f"{sum(c for a in counted.values() for c, _ in a.values())} "
                 "collectives = modeled"
                 for name, loss, counted, _ in found]
        out.put(f"MESH SCALE OK {data_ax * model_ax} ranks "
                f"{data_ax}x{model_ax} on {device} over {mesh.backend} "
                f"nodes={nodes} | " + " | ".join(parts))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("data", type=int)
    ap.add_argument("model", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.data * args.model != args.ranks:
        sys.exit(f"a {args.data}x{args.model} mesh needs "
                 f"{args.data * args.model} ranks, not {args.ranks}")
    import torch.multiprocessing as mp

    from stargcn_tpu_torch.parallel.mesh import rank_backend, spawn_ranks

    try:
        backend, _ = rank_backend(args.device, args.ranks)
    except RuntimeError as e:
        sys.exit(str(e))
    out = mp.get_context("spawn").SimpleQueue()
    spawn_ranks(check_rank, args.ranks,
                (args.data, args.model, args.device, out),
                device=args.device, backend=backend, timeout=args.timeout)
    print(out.get())


if __name__ == "__main__":
    main()
