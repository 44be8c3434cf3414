"""Rank processes for the mesh tests (``tests/test_torch_mesh*.py``).

Imports the port alone (no JAX), so that a spawned rank starts quickly.
``spawn`` starts ``world`` ranks with ``torch.multiprocessing`` (``spawn``),
joined over gloo through a rendezvous file under the test's temporary
directory (no port), each capped at two torch threads, and fails the test
when a rank raises or when the ranks outlive their timeout.  A rank writes
what it found with ``torch.save``; the test process compares.

The trainers follow the set-up of ``tests/test_parallel.py:23-46`` (a
64 x 64 synthetic graph of 800 edges, narrow widths, batch 64) on the CPU.
"""

import os

import numpy as np
import torch

from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data.synthetic import synthetic_graph
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.parallel import GraphShardings, make_mesh
from stargcn_tpu_torch.parallel import collectives as C
from stargcn_tpu_torch.parallel.mesh import start_ranks
from stargcn_tpu_torch.train import Trainer, TrainSettings
from stargcn_tpu_torch.utils import default_cfg

# The meshes of every backend's step test; bitdense adds one 2 x 2 mesh.
MESHES = ((1, 2), (2, 1))
PER_EDGE = {"GCN.DROPOUT": 0.5, "GCN.DROPOUT_PER_EDGE": True}
MESHES_2X2 = MESHES + ((2, 2),)


# ------------------------------- spawning -------------------------------

def start(fn, world, tmp_path, *args, timeout=240.0):
    """Start ``fn(rank, *args)`` in ``world`` spawned ranks over gloo, their
    rendezvous file under ``tmp_path``, and return at once
    (``parallel.mesh.start_ranks``; ``wait`` joins them)."""
    return start_ranks(fn, world, args, device="cpu", backend="gloo",
                       timeout=timeout, rendezvous_dir=tmp_path)


def spawn(fn, world, tmp_path, *args, timeout=240.0):
    """Run ``fn(rank, *args)`` in ``world`` spawned ranks over gloo; raise
    if a rank raises or the ranks are not done within ``timeout``
    seconds (the ranks are then killed)."""
    start(fn, world, tmp_path, *args, timeout=timeout).wait()


# ------------------------------- set-up ---------------------------------

def mesh_cfg(backend, defaults=default_cfg, **overrides):
    """``tests/test_parallel.py``'s configuration on ``backend``, from
    either package's ``default_cfg``; on ``bitdense`` the port takes its
    kernel wrappers (their plain versions on the CPU, row shards
    included)."""
    cfg = defaults()
    cfg.EMBED.UNITS = 8
    cfg.GCN.AGG.UNITS = [15]
    cfg.GCN.OUT.UNITS = [10]
    cfg.GCN.DROPOUT = 0.0
    cfg.GEN_RATING.MID_MAP = 8
    cfg.TRAIN.RATING_BATCH_SIZE = 64
    cfg.TRAIN.LR = 5e-3
    cfg.KERNEL.BACKEND = backend
    for dotted, value in overrides.items():
        node = cfg
        *path, leaf = dotted.split(".")
        for key in path:
            node = node[key]
        node[leaf] = value
    return cfg


def iterator(cls, synth, num_items=64):
    """``tests/test_parallel.py``'s graph and split, from either package's
    ``DataIterator`` and ``synthetic_graph`` (``num_items`` wider for a
    bit pack whose two layouts split differently)."""
    g = synth(num_users=64, num_items=num_items, num_edges=800, seed=3)
    pairs = g["user", "movie"].node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    return cls(g, "user", "movie", test_node_pairs=pairs[:, perm[:100]],
               valid_node_pairs=pairs[:, perm[100:180]], embed_P_mask=0.1,
               embed_p_zero=0.0, embed_p_self=1.0, seed=11)


def port_trainer(backend, mesh=None, save_dir=None, num_items=64,
                 **overrides):
    """The port's ``Trainer`` of that set-up on the CPU."""
    cfg = mesh_cfg(backend, **overrides)
    it = iterator(DataIterator, synthetic_graph, num_items)
    csr = it.all_graph["user", "movie"]
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link))
    assert model_cfg.backend == backend
    s = TrainSettings.from_cfg(cfg)
    s.hang_timeout_s = 0.0
    return Trainer(model_cfg, it, s, device="cpu", mesh=mesh,
                   save_dir=save_dir)


def whole_grads(trainer, grads):
    return {k: trainer._whole(k, g) for k, g in grads.items()}


def local_shapes(trainer):
    """Per parameter, this rank's shape; per bit layout, this rank's
    rows and whether they are split."""
    shapes = {k: tuple(p.shape) for k, p in trainer.model.named_parameters()}
    if trainer.model_cfg.backend == "bitdense":
        pack = trainer.variants.bit_pack("train")
        for t in ("user", "item"):
            for k in ("pf", "pb"):
                shapes[f"pack/{t}/{k}"] = tuple(pack[t][k].local.shape)
                shapes[f"split/{t}/{k}"] = pack[t][k].sharded
    return shapes


# ------------------------------ rank bodies ------------------------------

def step_ranks(rank, backends, meshes, ckpt_dir, batch, out_dir,
               num_items=64, overrides=None):
    """Per backend and per mesh of ``meshes``: restore the single-process
    trainer's initial checkpoint, ``loss_and_grads`` and one
    ``train_iteration`` on ``batch``; write the stats, the whole
    gradients and parameters, and this rank's shapes."""
    rb, cb = batch
    for backend in backends:
        for d, m in meshes:
            mesh = make_mesh(d, m, devices=range(d * m), device="cpu")
            if rank >= d * m:
                continue
            t = port_trainer(backend, mesh, num_items=num_items,
                             **(overrides or {}))
            t.restore_checkpoint(os.path.join(ckpt_dir, backend,
                                              "ckpt_init_0.pt"))
            stats0, grads = t.loss_and_grads(rb, cb)
            stats = t.train_iteration(rb, cb)
            torch.save({
                "stats": {k: v.detach().clone() for k, v in stats.items()},
                "grad_stats": {k: v.detach().clone()
                               for k, v in stats0.items()},
                "grads": whole_grads(t, grads),
                "params": t.whole_params(),
                "shapes": local_shapes(t),
                "coords": mesh.coords,
            }, os.path.join(out_dir, f"{backend}_{d}x{m}_r{rank}.pt"))


def collective_ranks(rank, out_dir):
    """The three conjugate pairs and the clip's global norm at axis size
    2, against the single-process functions on the same values (every
    rank draws every rank's values from one seed)."""
    mesh = make_mesh(1, 2, device="cpu")
    group = mesh.group("model")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(6, 4, generator=g)
    w = torch.randn(6, 4, generator=g)
    A = torch.randn(2, 3, 6, generator=g)      # rank r's partial operator
    found = {}
    # enter -> partial -> leave: y = sum_r A_r x, then a replicated loss.
    xm = x.clone().requires_grad_(True)
    y = C.leave(A[rank] @ C.enter(xm, group), group)
    (y * w[:3]).sum().backward()
    x1 = x.clone().requires_grad_(True)
    ((A[0] @ x1 + A[1] @ x1) * w[:3]).sum().backward()
    found["enter_leave"] = (y.detach(), (A[0] + A[1]) @ x,
                            xm.grad, x1.grad)
    # gather_rows: the whole table from each rank's 3 rows.
    rows = x[3 * rank:3 * rank + 3].clone().requires_grad_(True)
    full = C.gather_rows(rows, group)
    (full ** 2 * w).sum().backward()
    found["gather_rows"] = (full.detach(), x, rows.grad,
                            (2 * x * w)[3 * rank:3 * rank + 3])
    # The clip's global norm: a row-split table and a replicated weight.
    from stargcn_tpu_torch.train.loop import ClipAdam

    table, dense_w = torch.randn(6, 4, generator=g), torch.randn(3, 3,
                                                                 generator=g)
    opt = ClipAdam({"t": table[3 * rank:3 * rank + 3].clone(),
                    "w": dense_w.clone()}, 1e-2, 1.0,
                   sharded={"t": group})
    sq = opt.global_sq_norm({"t": table[3 * rank:3 * rank + 3],
                             "w": dense_w})
    found["global_sq_norm"] = (sq, (table ** 2).sum() + (dense_w ** 2).sum())
    # from_first: the first rank's bits on every rank.
    found["from_first"] = (C.from_first(x + rank, group), x)
    torch.save(found, os.path.join(out_dir, f"collectives_r{rank}.pt"))


def trainer_ranks(rank, ckpt_dir, batches, out_dir):
    """On 1 x 2 (dense: evaluation at the initial parameters, one step, a
    checkpoint round trip, the export) and on 2 x 1 (evaluation, then
    three steps with dropout, every rank's parameters kept)."""
    from stargcn_tpu_torch.serve import export_serving

    init = os.path.join(ckpt_dir, "dense", "ckpt_init_0.pt")
    mesh = make_mesh(1, 2, device="cpu")
    t = port_trainer("dense", mesh, save_dir=os.path.join(out_dir, "m12"))
    t.restore_checkpoint(init)
    found = {"valid_init": t.evaluate("valid")}
    t.train_iteration(*batches[0])
    path = t.save_checkpoint("mesh")
    found["params_saved"] = t.whole_params()
    found["shapes_saved"] = {k: tuple(p.shape)
                             for k, p in t.model.named_parameters()}
    t2 = port_trainer("dense", mesh)
    t2.restore_checkpoint(path)
    found["params_restored"] = t2.whole_params()
    found["local_restored"] = {k: p.detach().clone()
                               for k, p in t2.model.named_parameters()}
    found["local_saved"] = {k: p.detach().clone()
                            for k, p in t.model.named_parameters()}
    found["opt_count"] = t2.opt.count
    # Replicas that computed different gradients take the first one's.
    found["replica_grads"] = t._replica_grads(
        {k: torch.full_like(p, float(rank + 1))
         for k, p in t.model.named_parameters()})
    art = export_serving(t)
    found["export"] = (art.user_feats, art.item_feats)
    found["ckpt"] = path
    # Per-edge dropout on the edge shards: each rank's rows of the mask
    # the whole edge set draws.
    t = port_trainer("xla", mesh, **PER_EDGE)
    t.restore_checkpoint(init)
    t.seed_dropout(7)
    stats, grads = t.loss_and_grads(*batches[0])
    found["per_edge"] = (stats["loss"], whole_grads(t, grads))

    mesh = make_mesh(2, 1, device="cpu")
    t = port_trainer("dense", mesh)
    t.restore_checkpoint(init)
    found["valid_init_2x1"] = t.evaluate("valid")
    t = port_trainer("bitdense", mesh, **{"GCN.DROPOUT": 0.5})
    t.restore_checkpoint(os.path.join(ckpt_dir, "bitdense",
                                      "ckpt_init_0.pt"))
    for rb, cb in batches:
        t.train_iteration(rb, cb)
    found["dropout_params"] = t.whole_params()
    torch.save(found, os.path.join(out_dir, f"trainer_r{rank}.pt"))


def place_ranks(rank, out_dir):
    """This rank's placements on a 2 x 2 mesh: the row ranges of an edge
    array, an embedding table, a bit pack and a batch."""
    mesh = make_mesh(2, 2, device="cpu")
    sh = GraphShardings(mesh)
    found = {"coords": mesh.coords, "grid": mesh.grid}
    for name, n, place in (
            ("edges", 512, lambda a: sh.place(a, sh.edges)),
            ("embed", 64, lambda a: sh.place(a, sh.embed_rows)),
            ("bit", 1280, lambda a: sh.place(a, sh.bit_rows)),
            ("batch", 64, lambda a: sh.place_batch(a)[0]),
            ("replicated", 64, lambda a: sh.place_replicated(a)[0])):
        s = place(torch.arange(n))
        found[name] = (s.offset, s.offset + s.local.shape[0],
                       bool(torch.equal(s.whole(), torch.arange(n))))
    pack = {"user": {"pf": torch.zeros(1280, 16, dtype=torch.uint8),
                     "pb": torch.zeros(1000, 16, dtype=torch.uint8)},
            "row_interleave": 128}
    placed = sh.place_bit_pack(pack)
    found["pack_axes"] = (placed["user"]["pf"].axis,
                          placed["user"]["pb"].axis)
    torch.save(found, os.path.join(out_dir, f"place_r{rank}.pt"))
