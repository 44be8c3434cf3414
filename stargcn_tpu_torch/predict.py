"""STAR-GCN serving CLI (PyTorch): rating prediction and top-K
recommendation.  The port of ``experiments/predict.py``.

Export-and-serve on a synthetic graph, from a checkpoint that
``python -m stargcn_tpu_torch.train`` wrote (without ``--resume``:
untrained parameters made from the config's seed)::

    python -m stargcn_tpu_torch.predict --cfg configs/transductive_ml_10m.yml \\
        --dataset synthetic --resume runs/ckpt_best_0.pt \\
        --save_artifact art.npz --users 1,2,3 --topk 10

Artifact-only serving (an ``.npz`` written by either package)::

    python -m stargcn_tpu_torch.predict --artifact art.npz --pairs 1:10,2:33

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run on the CPU.
Output: one JSON line per request.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np


def build_dataset(cfg):
    """``(graph, data_iter, model_cfg)`` from a merged config, as
    ``experiments/common.py:build_dataset`` builds them for
    ``DATASET.NAME == 'synthetic'``."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import build_model_config

    if cfg.DATASET.NAME != "synthetic":
        raise NotImplementedError(
            "only DATASET.NAME 'synthetic' is ported; MovieLens loading "
            "comes with the port of data/movielens.py")
    if cfg.DATASET.IS_INDUCTIVE:
        raise NotImplementedError("synthetic runs are transductive")
    name_user, name_item = "user", "movie"
    graph = synthetic_graph(seed=cfg.SEED)
    csr = graph[name_user, name_item]
    rng = np.random.RandomState(cfg.SEED)
    pairs = csr.node_pair_ids
    perm = rng.permutation(pairs.shape[1])
    n_test = int(np.ceil(pairs.shape[1] * cfg.DATASET.TEST_RATIO))
    n_valid = int(np.ceil((pairs.shape[1] - n_test)
                          * cfg.DATASET.VALID_RATIO))
    data_iter = DataIterator(
        graph, name_user, name_item,
        test_node_pairs=pairs[:, perm[:n_test]],
        valid_node_pairs=pairs[:, perm[n_test:n_test + n_valid]],
        embed_P_mask=cfg.EMBED.MASK_PROP, embed_p_zero=cfg.EMBED.P_ZERO,
        embed_p_self=1.0 - cfg.EMBED.P_ZERO, seed=cfg.SEED)
    model_cfg = build_model_config(
        cfg, num_users=csr.shape[0], num_items=csr.shape[1],
        num_links=len(csr.multi_link))
    return graph, data_iter, model_cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve STAR-GCN (PyTorch).")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--resume", default=None, type=str,
                        help="checkpoint (.pt) with trained parameters, as "
                             "python -m stargcn_tpu_torch.train writes it")
    parser.add_argument("--segment", default="test",
                        choices=["valid", "test"],
                        help="graph variant to encode (as in evaluation)")
    parser.add_argument("--artifact", default=None, type=str,
                        help="load a previously exported .npz artifact "
                             "instead of building one")
    parser.add_argument("--save_artifact", default=None, type=str,
                        help="write the exported artifact to this path")
    parser.add_argument("--backend", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default) or cpu")
    parser.add_argument("--users", default=None, type=str,
                        help="comma list of user ids to recommend for")
    parser.add_argument("--topk", default=10, type=int)
    parser.add_argument("--include_rated", action="store_true",
                        help="allow recommending already-rated items")
    parser.add_argument("--pairs", default=None, type=str,
                        help="comma list of user:item pairs to score")
    parser.add_argument("--rank_eval", action="store_true",
                        help="HR@K/NDCG@K (not ported yet)")
    args = parser.parse_args(argv)
    if args.rank_eval:
        parser.error("--rank_eval is not ported yet: it comes with the "
                     "port of ranking.py")
    logging.basicConfig(level=logging.INFO)

    from stargcn_tpu_torch.serve import (
        Predictor,
        ServingArtifact,
        ServingState,
        export_serving,
    )

    if args.artifact:
        art = ServingArtifact.load(args.artifact)
    else:
        from stargcn_tpu_torch.utils import cfg_from_file, default_cfg

        cfg = default_cfg()
        if args.cfg_file:
            cfg_from_file(args.cfg_file, cfg)
        if args.dataset:
            cfg.DATASET.NAME = args.dataset
        if args.seed is not None:
            cfg.SEED = args.seed
        if args.backend is not None:
            cfg.KERNEL.BACKEND = args.backend
        _, data_iter, model_cfg = build_dataset(cfg)
        state_dict = None
        if args.resume:
            import torch

            state_dict = torch.load(args.resume, map_location="cpu",
                                    weights_only=True)["params"]
            logging.info("parameters restored from %s", args.resume)
        else:
            logging.warning("no checkpoint: serving UNTRAINED parameters "
                            "(smoke-test mode)")
        state = ServingState(model_cfg, data_iter, device=args.device,
                             seed=cfg.SEED, state_dict=state_dict)
        art = export_serving(state, segment=args.segment)
        if args.save_artifact:
            art.save(args.save_artifact)
            logging.info("artifact written to %s", args.save_artifact)

    pred = Predictor(art, device=args.device)
    if args.pairs:
        uu, ii = zip(*(p.split(":") for p in args.pairs.split(",")))
        uu = np.array([int(x) for x in uu], np.int64)
        ii = np.array([int(x) for x in ii], np.int64)
        scores = pred.predict(uu, ii)
        print(json.dumps({"mode": "predict",
                          "pairs": [[int(u), int(i)] for u, i in zip(uu, ii)],
                          "ratings": [round(float(s), 4) for s in scores]}))
    if args.users:
        users = np.array([int(x) for x in args.users.split(",")], np.int64)
        idx, vals = pred.recommend(users, k=args.topk,
                                   exclude_rated=not args.include_rated)
        for r, u in enumerate(users):
            print(json.dumps({"mode": "recommend", "user": int(u),
                              "items": idx[r].tolist(),
                              "ratings": [round(float(v), 4)
                                          for v in vals[r]]}))
    if not args.pairs and not args.users:
        print(json.dumps({"mode": "info", "num_users": art.num_users,
                          "num_items": art.num_items,
                          "feat_dim": int(art.user_feats.shape[1])}))


if __name__ == "__main__":
    main()
