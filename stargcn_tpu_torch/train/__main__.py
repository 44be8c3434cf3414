"""STAR-GCN training CLI (PyTorch).  The port of ``experiments/train.py``
for full-graph training on the ``dense``, ``xla``, ``bitdense`` and
``ell`` backends (``--backend auto``, the config's default, picks
``dense`` for graphs of at most 150M rating x user x item entries, such as
ML-1M and the default synthetic graph, and ``bitdense`` beyond; ``ell``,
the chunked-ELL sparse backend, only by name)::

    python -m stargcn_tpu_torch.train --cfg configs/transductive_ml_1m.yml \\
        --dataset synthetic --save_dir runs --max_iter 200

On a MovieLens archive already extracted under ``--data_root`` (nothing is
downloaded when the directory is there), transductive or inductive as the
config says (``--inductive`` forces the inductive split)::

    python -m stargcn_tpu_torch.train \\
        --cfg configs/inductive_ml_1m_item_10.yml --data_root datasets

and, with ``--num_neighbors K`` (``GRAPH_SAMPLER.NUM_NEIGHBORS`` > 0), for
sampled mini-batch training (``train/sampled_loop.py:SampledTrainer``),
where ``--backend pallas`` pools every frontier through the ELL kernels,
``--backend auto`` resolves by ``resolve_sampled_backend`` and anything
else takes the plain ``xla`` formulation::

    python -m stargcn_tpu_torch.train --cfg configs/transductive_ml_10m.yml \\
        --dataset synthetic --num_neighbors 8 --backend pallas --save_dir runs

Full-graph training on the card draws its batches on the card
(``TRAIN.DEVICE_SAMPLER``, see ``resolve_device_sampler``) unless
``--no_device_sampler`` is given.  In sampled mode ``--plan_device`` builds
the plans on the device (with the ``xla`` backend), ``--prefetch`` builds
batches in a producer thread ahead of the step and ``--remat`` recomputes
each level of the forward in the backward.  The model options of a YAML
(``MODEL.USE_FEA_PROJ``, ``MODEL.USE_EMBED``, ``MODEL.COMPUTE_DTYPE``,
``GCN.DROPOUT_PER_EDGE``, ``GCN.USE_RECURRENT``) run in both modes.

Both modes run on a device mesh of ``DATAxMODEL`` ranks, one process each
(``parallel/shardings.py``; in sampled mode ``models/sampled.py``), with
the JAX CLI's flags::

    python -m stargcn_tpu_torch.train --cfg configs/transductive_ml_10m.yml \
        --dataset synthetic --save_dir runs --mesh 1x2 \
        --coordinator host0:29500 --num_processes 2 --process_id 0
    # ... and --process_id 1 on the second rank

``--coordinator`` is rank 0's ``host:port`` (or a ``file://`` rendezvous
path); ranks run on ``cuda`` over NCCL, a card each, or with ``--device
cpu`` over gloo (two ranks that share one card need gloo on ``cuda``:
``python -m stargcn_tpu_torch.parallel.multiprocess_train`` runs so).
``--mesh 1x1`` needs no coordinator.  The mesh's first rank writes the
run's files (and in sampled mode draws and plans every batch).

With ``--prefetch`` the command sets ``OMP_WAIT_POLICY=PASSIVE`` and
``GOMP_SPINCOUNT=0`` where they are unset, so that the planner's idle
OpenMP threads sleep instead of spinning on the cores the step's thread
needs.  OpenMP reads them when it is loaded, and ``torch`` loads it, so the
command starts itself again with them set (``prefetch_env``); a caller of
``main`` in its own process sets them before importing ``torch``.

``--profile DIR`` first runs ``fit(max_iter=TRAIN.VALID_INTERVAL)`` under
``utils.profiling.trace(DIR)``, which writes a Chrome-trace JSON there (the
card's kernels too on ``cuda``, and the program's own ``stargcn.*`` spans:
host prep, prefetch wait, copies, forward and backward, optimiser, stats
fetch, evaluation), then the normal ``fit``.

Writes ``cfg{id}.yml``, ``log{id}.log``, ``train_loss{id}.csv``,
``valid_loss{id}.csv``, ``test_loss{id}.csv`` and the checkpoints
``ckpt_best_{id}.pt`` / ``ckpt_last_{id}.pt`` into ``--save_dir``, and logs
a final ``result:`` line.  ``--device`` defaults to ``cuda``; pass
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

# OpenMP's settings for a prefetching run: idle threads sleep.
PREFETCH_OMP_ENV = {"OMP_WAIT_POLICY": "PASSIVE", "GOMP_SPINCOUNT": "0"}


def prefetch_env(argv, environ):
    """The environment that ``argv`` should run in, or ``None`` when
    ``environ`` already does: with ``--prefetch``, ``environ`` with every
    unset variable of ``PREFETCH_OMP_ENV`` set."""
    if "--prefetch" not in argv or all(k in environ
                                       for k in PREFETCH_OMP_ENV):
        return None
    return {**PREFETCH_OMP_ENV, **environ}


def resolve_device_sampler(cfg, device, flag=None, mesh=False) -> bool:
    """``TRAIN.DEVICE_SAMPLER`` for a run: ``flag`` (the CLI's
    ``--device_sampler`` True / ``--no_device_sampler`` False) wins; else
    the config's setting when it is on; else on exactly where its semantics
    allow, as the JAX CLI decides it (``experiments/train.py:142-156``,
    whose "the accelerator is a TPU" reads "the run's device is cuda"
    here): full-graph mode and no mesh (neither ``--mesh``, which
    ``mesh`` says, nor mesh axes in the config)."""
    if flag is not None:
        return bool(flag)
    if cfg.TRAIN.get("DEVICE_SAMPLER", False):
        return True
    return (torch.device(device).type == "cuda"
            and int(cfg.GRAPH_SAMPLER.NUM_NEIGHBORS) <= 0
            and not mesh
            and cfg.PARALLEL.get("DATA_AXIS", 1)
            * cfg.PARALLEL.get("MODEL_AXIS", 1) <= 1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train STAR-GCN (PyTorch).")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None,
                        help="ml-100k | ml-1m | ml-10m | synthetic "
                             "(overrides cfg)")
    parser.add_argument("--data_root", type=str, default=None,
                        help="directory holding the extracted MovieLens "
                             "archive (default $STARGCN_DATA_ROOT or "
                             "<repo>/datasets)")
    parser.add_argument("--inductive", action="store_true",
                        help="the inductive node split "
                             "(DATASET.IS_INDUCTIVE)")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--silent", action="store_true")
    parser.add_argument("--max_iter", default=None, type=int)
    parser.add_argument("--backend", default=None, type=str,
                        help="full-graph aggregation backend: auto | "
                             "dense | xla | bitdense | ell (pallas reads as "
                             "xla); in sampled mode pallas | xla | auto")
    parser.add_argument("--num_neighbors", default=None, type=int,
                        help="sampled mini-batch mode with this fanout "
                             "(GRAPH_SAMPLER.NUM_NEIGHBORS)")
    parser.add_argument("--resume", default=None, type=str,
                        help="restore parameters + optimizer state from a "
                             "checkpoint (.pt) before training")
    parser.add_argument("--device_sampler", action="store_true",
                        default=None,
                        help="full-graph mode: draw batches on the device "
                             "(TRAIN.DEVICE_SAMPLER); the default on cuda")
    parser.add_argument("--no_device_sampler", action="store_true",
                        help="full-graph mode: draw batches on the host")
    parser.add_argument("--plan_device", action="store_true",
                        help="sampled mode: build the plans on the device "
                             "(graph/device_sampling.py; fanout drawn with "
                             "replacement); needs the xla backend")
    parser.add_argument("--remat", action="store_true",
                        help="sampled mode: recompute each level of the "
                             "forward in the backward instead of keeping "
                             "its messages (less memory, same gradients)")
    parser.add_argument("--prefetch", action="store_true",
                        help="sampled mode: build batches in a producer "
                             "thread one ahead of the step")
    parser.add_argument("--profile", default=None, type=str,
                        help="write a torch.profiler trace of the first "
                             "valid interval, with the program's stargcn.* "
                             "spans, into this directory")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    parser.add_argument("--mesh", default=None, type=str,
                        help="device mesh as DATAxMODEL, e.g. 2x4 (one "
                             "process a rank)")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="rank 0's host:port (or a file:// rendezvous "
                             "path); requires --num_processes and "
                             "--process_id")
    parser.add_argument("--num_processes", default=None, type=int)
    parser.add_argument("--process_id", default=None, type=int)
    args = parser.parse_args(argv)

    from stargcn_tpu_torch.graph import kernels as graph_kernels
    from stargcn_tpu_torch.predict import build_dataset
    from stargcn_tpu_torch.train.loop import Trainer, TrainSettings
    from stargcn_tpu_torch.train.sampled_loop import SampledTrainer
    from stargcn_tpu_torch.utils import (cfg_from_file, default_cfg,
                                         logging_config, save_cfg_dir)

    cfg = default_cfg()
    if args.cfg_file:
        cfg_from_file(args.cfg_file, cfg)
    if args.dataset:
        cfg.DATASET.NAME = args.dataset
    if args.inductive:
        cfg.DATASET.IS_INDUCTIVE = True
    if args.seed is not None:
        cfg.SEED = args.seed
    if args.max_iter is not None:
        cfg.TRAIN.MAX_ITER = args.max_iter
    if args.backend is not None:
        cfg.KERNEL.BACKEND = args.backend
    if args.num_neighbors is not None:
        cfg.GRAPH_SAMPLER.NUM_NEIGHBORS = args.num_neighbors
    if args.mesh is not None:
        d, m = (int(x) for x in args.mesh.lower().split("x"))
        cfg.PARALLEL.DATA_AXIS = d
        cfg.PARALLEL.MODEL_AXIS = m
    fanout = int(cfg.GRAPH_SAMPLER.NUM_NEIGHBORS)
    on_mesh = args.mesh is not None or (
        cfg.PARALLEL.get("DATA_AXIS", 1) * cfg.PARALLEL.get("MODEL_AXIS", 1)
        > 1)
    cfg.TRAIN.DEVICE_SAMPLER = resolve_device_sampler(
        cfg, args.device, False if args.no_device_sampler
        else args.device_sampler, mesh=on_mesh)

    mesh = None
    if on_mesh:
        from stargcn_tpu_torch.parallel import (initialize_distributed,
                                                make_mesh)
        from stargcn_tpu_torch.parallel.collectives import from_first

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        mesh = make_mesh(data=cfg.PARALLEL.DATA_AXIS,
                         model=cfg.PARALLEL.MODEL_AXIS, device=args.device)

    save_dir = args.save_dir
    if save_dir is None and args.cfg_file is not None:
        save_dir = os.path.splitext(args.cfg_file)[0] + "_runs"
    save_id = 0
    if save_dir and (mesh is None or mesh.leader):
        save_id = save_cfg_dir(save_dir, cfg)
        logging_config(save_dir, name=f"log{save_id}",
                       no_console=args.silent)
    else:
        logging.basicConfig(level=logging.INFO)
    if mesh is not None:
        # Every rank names the run's files by the first rank's id.
        save_id = int(from_first(torch.tensor([float(save_id)],
                                              device=args.device),
                                 mesh.group("all")).item())
    logging.info(cfg)

    graph_kernels.set_seed(cfg.SEED)
    _, data_iter, model_cfg = build_dataset(cfg, args.data_root)
    if fanout > 0:
        # Sampled mode reads KERNEL.BACKEND itself; the full-graph backend
        # of the model config is not used there.
        sampled_backend = (cfg.KERNEL.BACKEND
                           if cfg.KERNEL.BACKEND in ("pallas", "auto")
                           else "xla")
        trainer = SampledTrainer(
            model_cfg, data_iter, TrainSettings.from_cfg(cfg),
            fanout=fanout, save_dir=save_dir, save_id=save_id,
            backend=sampled_backend, device=args.device,
            plan_device=args.plan_device, remat=args.remat, mesh=mesh)
    else:
        trainer = Trainer(model_cfg, data_iter, TrainSettings.from_cfg(cfg),
                          save_dir=save_dir, save_id=save_id,
                          device=args.device, mesh=mesh)
    try:
        if args.resume:
            trainer.restore_checkpoint(args.resume)
            logging.info("resumed from %s", args.resume)
        if args.profile:
            from stargcn_tpu_torch.utils.profiling import trace

            with trace(args.profile):
                trainer.fit(max_iter=cfg.TRAIN.VALID_INTERVAL)
            logging.info("profile trace written to %s", args.profile)
        result = trainer.fit(**({"prefetch": True}
                                if fanout > 0 and args.prefetch else {}))
        logging.info("result: %s", result)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    env = prefetch_env(sys.argv[1:], os.environ)
    if env is not None:
        os.execve(sys.executable, [sys.executable, "-m",
                                   "stargcn_tpu_torch.train",
                                   *sys.argv[1:]], env)
    main()
