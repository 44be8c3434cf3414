"""Two-process training on a device mesh, run end to end.

The port's twin of ``scripts/multiprocess_train.py``: two ranks, spawned
here and joined through a rendezvous file in a temporary directory, train
one small synthetic graph on a 1 x 2 mesh (edges, bit-pack rows and
embedding rows split over 'model') and then on a 2 x 1 mesh (the batch
split over 'data'): three sharded steps held against the same steps in one
process, an evaluation across the ranks, a checkpoint round trip of the
split parameters, and a short ``fit``::

    python -m stargcn_tpu_torch.parallel.multiprocess_train            # card
    python -m stargcn_tpu_torch.parallel.multiprocess_train --device cpu

On the CPU the ranks use gloo.  On ``cuda`` they use NCCL where there is a
card for each, else gloo with both on one card (NCCL refuses two ranks on
one device).  Prints ``MULTIPROCESS RUN PASSED`` when both ranks pass.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

MESHES = ((1, 2), (2, 1))


def _trainer(mesh, device, save_dir=None):
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import STARGCNConfig
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    g = synthetic_graph(num_users=24, num_items=16, num_edges=256, seed=11)
    csr = g["user", "movie"]
    pairs = csr.node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    it = DataIterator(g, "user", "movie",
                      test_node_pairs=pairs[:, perm[:40]],
                      valid_node_pairs=pairs[:, perm[40:80]],
                      embed_P_mask=0.2, seed=0, embed_p_zero=1.0,
                      embed_p_self=0.0)
    cfg = STARGCNConfig(
        num_users=24, num_items=16, num_links=len(csr.multi_link),
        nblocks=2, use_dae=True, embed_units=4, agg_units=(10,),
        out_units=(6,), agg_accum="sum", gcn_dropout=0.0,
        gen_rating_mid_map=4, backend="bitdense")
    s = TrainSettings(rating_batch_size=32, max_iter=4, log_interval=2,
                      valid_interval=2, lr=1e-2, seed=0, hang_timeout_s=0.0)
    return Trainer(cfg, it, s, device=device, mesh=mesh, save_dir=save_dir)


def run_rank(rank, device, workdir):
    from stargcn_tpu_torch.parallel import make_mesh

    for d, m in MESHES:
        mesh = make_mesh(d, m, device=device)
        t = _trainer(mesh, device, os.path.join(workdir, f"{d}x{m}"))
        ref = _trainer(None, device)
        it = ref.data_iter
        rs = it.rating_sampler(batch_size=ref.train_batch, segment="train")
        recon = it.recon_nodes_sampler(batch_size=ref.s.recon_batch_size)
        losses = []
        for _ in range(3):
            rb = next(rs)
            noise, _, ids = next(recon)
            cb = ref.prepare_recon_batch(noise, ids)
            got = float(t.train_iteration(rb, cb)["loss"])
            want = float(ref.train_iteration(rb, cb)["loss"])
            assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(
                want) + 1e-5, (d, m, got, want)
            losses.append(got)
        rmse = t.evaluate("valid")
        want = ref.evaluate("valid")
        assert np.allclose(rmse, want, rtol=1e-4, atol=1e-5), (rmse, want)
        before = {k: v.clone() for k, v in t.whole_params().items()}
        path = t.save_checkpoint("mp")
        fresh = _trainer(mesh, device)
        fresh.restore_checkpoint(path)
        for k, v in fresh.whole_params().items():
            assert torch.equal(v, before[k]), k
        result = t.fit(max_iter=4, log=lambda *a: None)
        assert np.isfinite(result["best_valid_rmse"]), result
        print(f"rank {rank} {d}x{m} ({mesh.backend}): losses={losses} "
              f"valid_rmse={rmse.tolist()} "
              f"fit={result['best_valid_rmse']:.4f}", flush=True)
    print(f"rank {rank}: MULTIPROCESS OK", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", default=600.0, type=float,
                    help="seconds before the ranks are stopped")
    args = ap.parse_args(argv)
    from stargcn_tpu_torch.parallel.mesh import rank_backend, spawn_ranks

    try:
        backend, _ = rank_backend(args.device, 2)
    except RuntimeError as e:
        sys.exit(str(e))

    with tempfile.TemporaryDirectory(prefix="stargcn_mp_") as workdir:
        try:
            spawn_ranks(run_rank, 2, (args.device, workdir),
                        device=args.device, backend=backend,
                        timeout=args.timeout)
        except TimeoutError as e:
            sys.exit(f"multiprocess run FAILED: {e}")
    print(f"MULTIPROCESS RUN PASSED (2 processes, {backend}, "
          f"meshes {', '.join(f'{d}x{m}' for d, m in MESHES)})")


if __name__ == "__main__":
    main()
