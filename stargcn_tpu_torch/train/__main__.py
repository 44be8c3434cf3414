"""STAR-GCN training CLI (PyTorch).  The port of ``experiments/train.py``
for full-graph transductive training on the ``bitdense`` backend::

    python -m stargcn_tpu_torch.train --cfg configs/transductive_ml_10m.yml \\
        --dataset synthetic --save_dir runs --max_iter 200

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


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train STAR-GCN (PyTorch).")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None,
                        help="synthetic (overrides cfg)")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--silent", action="store_true")
    parser.add_argument("--max_iter", default=None, type=int)
    parser.add_argument("--backend", default=None, type=str,
                        help="aggregation kernel backend: auto | bitdense")
    parser.add_argument("--resume", default=None, type=str,
                        help="restore parameters + optimizer state from a "
                             "checkpoint (.pt) before training")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from stargcn_tpu_torch.predict import build_dataset
    from stargcn_tpu_torch.train.loop import Trainer, TrainSettings
    from stargcn_tpu_torch.utils import (cfg_from_file, default_cfg,
                                         logging_config, save_cfg_dir)

    cfg = default_cfg()
    if args.cfg_file:
        cfg_from_file(args.cfg_file, cfg)
    if args.dataset:
        cfg.DATASET.NAME = args.dataset
    if args.seed is not None:
        cfg.SEED = args.seed
    if args.max_iter is not None:
        cfg.TRAIN.MAX_ITER = args.max_iter
    if args.backend is not None:
        cfg.KERNEL.BACKEND = args.backend
    if int(cfg.GRAPH_SAMPLER.NUM_NEIGHBORS) > 0:
        raise NotImplementedError(
            "sampled mini-batch training comes with the port of "
            "train/sampled_loop.py")

    save_dir = args.save_dir
    if save_dir is None and args.cfg_file is not None:
        save_dir = os.path.splitext(args.cfg_file)[0] + "_runs"
    save_id = 0
    if save_dir:
        save_id = save_cfg_dir(save_dir, cfg)
        logging_config(save_dir, name=f"log{save_id}",
                       no_console=args.silent)
    else:
        logging.basicConfig(level=logging.INFO)
    logging.info(cfg)

    _, data_iter, model_cfg = build_dataset(cfg)
    trainer = Trainer(model_cfg, data_iter, TrainSettings.from_cfg(cfg),
                      save_dir=save_dir, save_id=save_id,
                      device=args.device)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        logging.info("resumed from %s", args.resume)
    result = trainer.fit()
    logging.info("result: %s", result)
    return result


if __name__ == "__main__":
    main()
