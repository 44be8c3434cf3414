"""ELL kernels against the gather formulation: the crossover sweep.

    python -m stargcn_tpu_torch.probes.ell_crossover_sweep [--quick]
        [--device cuda|cpu] [--out FILE] [--cells NAME,...]

The port of ``scripts/sweep_pallas_crossover.py``, and the measurement that
``train/sampled_loop.py:resolve_sampled_backend`` states its table from.

Pool rows, on the JAX script's grid (D = S in {8192, 32768, 131072}, K in
{8, 32, 64}, F in {64, 256, 512}; ``--quick``: {8192, 32768} x {8, 32} x
{64, 256}) with the inputs of ``numpy.random.RandomState(0)`` drawn in its
order: the forward ``ops/ell_kernels.py:ell_spmm_fwd_only`` against the
``xla`` backend's pool (``models/sampled.py:_ell_aggregate`` with
``use_pallas=False``: ``(take_rows(values, idx) * w[..., None]).sum(1)``),
and the forward with the values gradient (``ell_spmm``'s autograd, through
``ell_spmm_transpose``) against autograd of the same gather.  Each row also
gives the kernels' largest difference from their plain versions on its
inputs.

Model rows: what ``auto`` really switches.  The ``pallas`` backend
projects and then pools through the kernels, the ``xla`` backend pools and
then projects, so the rows time the whole sampled forward (one evaluation
batch, ``_eval_step``) and the whole training step (forward, backward and
the update, ``_loss_update``) of one ``SampledTrainer`` on the same packed
plan with each backend, in the same process: the ML-10M set-up of
``chip_smoke.py`` (its synthetic graph, ``transductive_ml_10m.yml``, batch
4096, recon 1024) at fanouts 8 and 16, and the ML-1M-sized graph under
``transductive_ml_1m.yml`` (every cap at most 32,768, inside the JAX
package's forward window) at fanout 8; the full run adds fanouts 16 and 32
on the ML-1M graph, 32 on the ML-10M graph, the ML-10M graph at batches
1024 and 256 (smaller caps) at fanouts 8 to 32, and the ML-100k-sized
graph under ``transductive_ml_100k.yml`` (the smallest caps) at fanouts 8
to 32.  ``--cells`` runs the named model rows alone.

Timing is the JAX script's ``time_fn`` on CUDA events: one warm call, then
three windows of six calls; a row gives the median window's milliseconds a
call and the spread of the three (largest less smallest).  ``winner`` says
``pallas`` or ``xla`` where one beats the other by more than the larger of
the two spreads, else ``tie``.  On ``--device cpu`` the wrappers take their
plain versions and the times are the host clock's (``clock: host``): they
say nothing of a card.  A point that runs out of device memory is written
down as such; every other error raises.  One JSON line a row, then a
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from stargcn_tpu_torch.ops import ell_kernels as ek
from stargcn_tpu_torch.utils.device import card_line, resolve_device

GRID = ((8192, 32768, 131072), (8, 32, 64), (64, 256, 512))
QUICK_GRID = ((8192, 32768), (8, 32), (64, 256))
ITERS, WINDOWS = 6, 3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 123
# The MovieLens-sized synthetic graphs, the sizes ``chip_smoke.py`` builds
# too (its ML10M and ML1M are taken from here).
GRAPHS = {
    "ml-10m": dict(num_users=69_878, num_items=10_677,
                   num_edges=10_000_000,
                   rating_values=tuple(np.arange(0.5, 5.01, 0.5))),
    "ml-1m": dict(num_users=6040, num_items=3706, num_edges=1_000_209,
                  rating_values=(1, 2, 3, 4, 5)),
    "ml-100k": dict(num_users=943, num_items=1682, num_edges=100_000,
                    rating_values=(1, 2, 3, 4, 5)),
}
CONFIGS = {"ml-10m": "transductive_ml_10m.yml",
           "ml-1m": "transductive_ml_1m.yml",
           "ml-100k": "transductive_ml_100k.yml"}
BATCH, RECON = 4096, 1024
# (cell name, graph, fanout, batch): recon 1024 throughout; the smaller
# batches give the ML-10M graph smaller frontier caps.
CELLS = (("ml10m_k8", "ml-10m", 8, BATCH), ("ml1m_k16", "ml-1m", 16, BATCH),
         ("ml1m_k32", "ml-1m", 32, BATCH), ("ml1m_k8", "ml-1m", 8, BATCH),
         ("ml10m_k16", "ml-10m", 16, BATCH),
         ("ml10m_k32", "ml-10m", 32, BATCH),
         ("ml10m_k8_b1024", "ml-10m", 8, 1024),
         ("ml10m_k16_b1024", "ml-10m", 16, 1024),
         ("ml10m_k16_b256", "ml-10m", 16, 256),
         ("ml10m_k32_b256", "ml-10m", 32, 256),
         ("ml100k_k8", "ml-100k", 8, BATCH),
         ("ml100k_k16", "ml-100k", 16, BATCH),
         ("ml100k_k32", "ml-100k", 32, BATCH))
QUICK_CELLS = (CELLS[0], CELLS[4], CELLS[3])


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def time_fn(fn, device, iters=ITERS, windows=WINDOWS):
    """``(ms, spread_ms)`` of ``fn()``: one warm call, then ``windows``
    windows of ``iters`` calls, timed by CUDA events on a card (the host
    clock on the CPU); the median window's ms a call and the largest less
    the smallest."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            per.append((time.perf_counter() - t0) * 1e3 / iters)
    return _median(per), max(per) - min(per)


def winner(pallas_ms, pallas_spread, xla_ms, xla_spread):
    """``'pallas'`` / ``'xla'`` where one is faster by more than the larger
    spread of the two, else ``'tie'``."""
    margin = max(pallas_spread, xla_spread)
    if xla_ms - pallas_ms > margin:
        return "pallas"
    if pallas_ms - xla_ms > margin:
        return "xla"
    return "tie"


def _gather_pool(values, idx, w):
    """The ``xla`` backend's pool of one level (``_ell_aggregate``)."""
    from stargcn_tpu_torch.models.sampled import _ell_aggregate

    return _ell_aggregate(values[None], {"idx": idx, "weight": w}, "sum",
                          use_pallas=False)


def point_inputs(D, K, F, device):
    """The JAX script's inputs of one point: ``(values, idx, w, cot)``
    from ``RandomState(0)`` in its order (S = D)."""
    S = D
    rng = np.random.RandomState(0)
    idx = rng.randint(0, S, size=(D, K)).astype(np.int32)
    w = rng.normal(size=(D, K)).astype(np.float32)
    vals = rng.normal(size=(S, F)).astype(np.float32)
    cot = rng.normal(size=(D, F)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (vals, idx, w, cot))


def pool_point(D, K, F, device):
    """One row of the pool grid (see the module docstring)."""
    row = {"D": D, "S": D, "K": K, "F": F}
    try:
        vals, idx, w, cot = point_inputs(D, K, F, device)

        def grad_of(pool):
            v = vals.detach().requires_grad_(True)
            return torch.autograd.grad((pool(v, idx, w) * cot).sum(), v)[0]

        fwd = ek.ell_spmm_fwd_only(vals, idx, w)
        d_vals = grad_of(ek.ell_spmm)
        row["max_abs_err"] = {
            "ell_spmm_fwd_only": float(
                (fwd - ek.plain_ell_spmm(vals, idx, w)).abs().max()),
            "ell_spmm_transpose": float(
                (d_vals - ek.plain_ell_spmm_transpose(cot, idx, w, D))
                .abs().max())}
        del fwd, d_vals
        timed = {
            "pallas_fwd": lambda: ek.ell_spmm_fwd_only(vals, idx, w),
            "xla_fwd": lambda: _gather_pool(vals, idx, w),
            "pallas_fb": lambda: grad_of(ek.ell_spmm),
            "xla_fb": lambda: grad_of(_gather_pool),
        }
        for name, fn in timed.items():
            row[f"{name}_ms"], row[f"{name}_spread_ms"] = time_fn(fn, device)
    except torch.cuda.OutOfMemoryError as e:
        row["error"] = f"OutOfMemoryError: {e}"[:200]
        torch.cuda.empty_cache()
        return row
    for kind in ("fwd", "fb"):
        row[f"{kind}_speedup"] = (row[f"xla_{kind}_ms"]
                                  / row[f"pallas_{kind}_ms"])
        row[f"{kind}_winner"] = winner(
            row[f"pallas_{kind}_ms"], row[f"pallas_{kind}_spread_ms"],
            row[f"xla_{kind}_ms"], row[f"xla_{kind}_spread_ms"])
    return row


def pool_rows(grid, device, log=print):
    """Every point of ``grid`` (``(Ds, Ks, Fs)``), one row each."""
    rows = []
    for D in grid[0]:
        for K in grid[1]:
            for F in grid[2]:
                rows.append(pool_point(D, K, F, device))
                log(json.dumps(rows[-1]))
    return rows


# ------------------------------ model rows -------------------------------


def build_cell(graph, seed=SEED, **graph_kw):
    """``(cfg, data_iter, model_cfg)`` of ``graph`` (a key of ``GRAPHS``):
    the synthetic graph of that size and its split (10% test, 10% valid,
    from ``seed``) under the shipped config; ``chip_smoke.py`` builds its
    ML-10M and ML-1M set-ups here.  ``graph_kw`` overrides the graph's
    sizes (tests and rehearsals shrink it)."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(os.path.join(ROOT, "configs", CONFIGS[graph]))
    cfg.DATASET.NAME = "synthetic"
    g = synthetic_graph(**{**GRAPHS[graph], **graph_kw}, seed=seed)
    csr = g["user", "movie"]
    pairs = csr.node_pair_ids
    perm = np.random.RandomState(seed).permutation(pairs.shape[1])
    n_test = pairs.shape[1] // 10
    it = DataIterator(g, "user", "movie",
                      test_node_pairs=pairs[:, perm[:n_test]],
                      valid_node_pairs=pairs[:, perm[n_test:2 * n_test]],
                      embed_P_mask=cfg.EMBED.MASK_PROP,
                      embed_p_zero=cfg.EMBED.P_ZERO,
                      embed_p_self=1.0 - cfg.EMBED.P_ZERO, seed=seed)
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link), num_edges=csr.nnz)
    return cfg, it, model_cfg


def model_row(name, cfg, it, model_cfg, fanout, device, batch=BATCH,
              recon=RECON, trainer=None):
    """The whole-model row of one cell: a ``SampledTrainer(backend=
    'pallas')`` (``trainer``, or one built here from seed 123) and its
    twin on ``'xla'`` (a shallow copy: the same parameters, samplers and
    caps), each timed on the same packed plan of one training batch."""
    import copy

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
    from stargcn_tpu_torch.train import sampled_loop as sl

    if trainer is None:
        s = TrainSettings.from_cfg(cfg)
        s.rating_batch_size, s.recon_batch_size = batch, recon
        gk.set_seed(SEED)
        trainer = SampledTrainer(model_cfg, it, s, fanout=fanout,
                                 backend="pallas", device=device)
    if trainer.backend != "pallas" or trainer.plan_device:
        raise ValueError("model_row times a host-planned 'pallas' trainer "
                         "against its 'xla' twin")
    twin = copy.copy(trainer)
    twin.backend = twin.eval_backend = "xla"
    rs = it.rating_sampler(batch_size=trainer.train_batch, segment="train")
    rec = (it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
           if trainer.s.use_dae else None)
    feed = trainer._feed(trainer._pack_batch(
        trainer._build_batch_safe(rs, rec)))
    row = {"cell": name, "caps": dict(trainer.caps),
           "d_max": max(trainer.caps.values()), "fanout": fanout,
           "batch": trainer.train_batch, "embed_units":
           model_cfg.embed_units, "agg_units": list(model_cfg.agg_units),
           "num_links": model_cfg.num_links,
           "nodes": [model_cfg.num_users, model_cfg.num_items]}

    @torch.no_grad()
    def forward(owner):
        return sl._eval_step(owner, feed)

    def step(owner):
        return sl._loss_update(owner, feed)

    try:
        got, want = forward(trainer), forward(twin)
        row["fwd_sq_err_rel_diff"] = float(
            ((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        # Each backend timed on the same feed; the update moves the shared
        # parameters, the same for both.
        for what, fn in (("fwd", forward), ("step", step)):
            for backend, owner in (("pallas", trainer), ("xla", twin)):
                row[f"{backend}_{what}_ms"], row[
                    f"{backend}_{what}_spread_ms"] = time_fn(
                    lambda: fn(owner), device)
    except torch.cuda.OutOfMemoryError as e:
        row["error"] = f"OutOfMemoryError: {e}"[:200]
        torch.cuda.empty_cache()
        return row
    for what in ("fwd", "step"):
        row[f"{what}_winner"] = winner(
            row[f"pallas_{what}_ms"], row[f"pallas_{what}_spread_ms"],
            row[f"xla_{what}_ms"], row[f"xla_{what}_spread_ms"])
        row[f"{what}_speedup"] = (row[f"xla_{what}_ms"]
                                  / row[f"pallas_{what}_ms"])
    return row


def summary(pool, model, device):
    """The summary line: where the kernels win each column."""
    def wins(rows, col, keys):
        return [{k: r[k] for k in keys + (f"{col}_speedup",)}
                for r in rows if r.get(f"{col}_winner") == "pallas"]

    out = {"summary": "ell_crossover", "device": str(device),
           "clock": ("cuda_events" if torch.device(device).type == "cuda"
                     else "host"),
           "pool_fwd_wins": wins(pool, "fwd", ("D", "K", "F")),
           "pool_fb_wins": wins(pool, "fb", ("D", "K", "F")),
           "model_fwd_wins": wins(model, "fwd", ("cell", "d_max", "fanout")),
           "model_step_wins": wins(model, "step",
                                   ("cell", "d_max", "fanout")),
           "errors": [r for r in pool + model if "error" in r]}
    if out["clock"] == "cuda_events":
        out["card"] = card_line(device)
    return out


def run(quick=False, device="cuda", log=print, cells=None):
    """The sweep: ``(pool rows, model rows, summary)``.  ``cells``: the
    names of the model rows to run alone (no pool rows)."""
    device = resolve_device(device)
    if cells is not None:
        unknown = set(cells) - {c[0] for c in CELLS}
        if unknown:
            raise ValueError(f"unknown cells {sorted(unknown)}")
        pool, todo = [], [c for c in CELLS if c[0] in cells]
    else:
        pool = pool_rows(QUICK_GRID if quick else GRID, device, log)
        todo = QUICK_CELLS if quick else CELLS
    rows, built = [], {}
    for name, graph, fanout, batch in sorted(todo, key=lambda c: c[1]):
        if graph not in built:
            built = {graph: build_cell(graph)}
        rows.append(model_row(name, *built[graph], fanout, device,
                              batch=batch))
        log(json.dumps(rows[-1]))
        torch.cuda.empty_cache()
    out = summary(pool, rows, device)
    log(json.dumps(out))
    return pool, rows, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="also write every line into this file")
    p.add_argument("--cells", default=None,
                   help="comma-separated model cells to run alone (no "
                        "pool rows), e.g. ml100k_k8,ml1m_k8")
    args = p.parse_args(argv)
    sink = open(args.out, "w") if args.out else None
    try:
        def log(line):
            print(line, flush=True)
            if sink is not None:
                sink.write(line + "\n")
        run(args.quick, args.device, log,
            args.cells.split(",") if args.cells else None)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
