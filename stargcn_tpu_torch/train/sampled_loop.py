"""Mini-batch training engine for the sampled two-phase mode.

The port of ``stargcn_tpu/train/sampled_loop.py``: the counterpart of
``Trainer`` for graphs too large for full-graph propagation, with the same
schedule: rating + reconstruction batches from the same ``DataIterator``
samplers, REMOVE_RATING batch-edge exclusion, interleaved valid/test
evaluation, patience-driven LR decay with early stopping, best/last
checkpoints, and ``MetricLogger`` CSVs.  Reached from the CLI when
``GRAPH_SAMPLER.NUM_NEIGHBORS > 0``.

Every step the host builds a plan (``StackedPlan.build``: fixed-shape
frontiers and ELL blocks under the frontier caps, by default through the
fused planner of the port's C++ extension, ``BlockSampler``'s ``'native'``
route), packs it with the
batch's noise and targets into one int32 and one float32 buffer (two
host-to-device copies), and the device runs ``sampled_forward``, its
backward, the global-norm clip and Adam.  With ``plan_device`` the host
packs only the batch (pair ids, noise, recon ids) and the plan is built on
the device (``graph/device_sampling.py``); a step whose frontiers overflow
the caps is rejected on the device, and ``fit`` grows the caps when it
next reads the statistics.  ``fit(prefetch=True)`` builds batches in a
producer thread one ahead of the step.  Evaluation samples neighborhoods
with the SAME fanout as training, on the eval graph, with the cold-start
eval noise, from host plans.

With ``MODEL.USE_FEA_PROJ`` the raw node features go to the device once
and each frontier's rows are projected inside the step; ``remat``
recomputes each level in the backward instead of keeping its messages.

On a device mesh (``SampledTrainer(mesh=parallel.make_mesh(d, m))``, one
process a rank, every rank calling every method alike) the embedding
tables are split by rows over 'model' (``GraphShardings.place_params``)
and each step's frontier rows over 'data' (``sampled_forward``'s
``row_sharding``; ``models/sampled.py`` says where each collective
goes).  Every rank trains on the first rank's batch and plan: the first
rank alone draws, plans and packs, and broadcasts the two packed buffers
with a small header (their lengths, the frontier caps, and the packed
spec whenever it changes) to the others, which plan nothing.  So cap
growth is the first rank's decision: the header carries its caps, and
every rank takes them with the feed of the step they were grown for.
With ``plan_device`` the broadcast feed is the batch (pair ids, noise,
recon ids) and every rank builds the plan on its device from the same
uniforms (sorts, searches and integer counts: the same plan on every
rank).  Replicas take their first replica's gradients and ``fit``
decides by the first rank's numbers, as ``Trainer`` on a mesh (on the
card ``index_add_`` adds with atomics); the first rank writes the files.

Not ported here: ``plan_split`` (the JAX package's workaround for its TPU
runtime's program-load limit: planning and update are one step here
anyway).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from stargcn_tpu_torch.graph import kernels as graph_kernels
from stargcn_tpu_torch.graph.device_sampling import (DeviceGraphTables,
                                                    DevicePlanner,
                                                    uniform_from)
from stargcn_tpu_torch.graph.sampling import BlockSampler, FrontierCapError
from stargcn_tpu_torch.models.sampled import (StackedPlan, pack_tree,
                                              recon_losses, sampled_forward,
                                              unpack_tree)
from stargcn_tpu_torch.models.stargcn import STARGCN, feature_dims
from stargcn_tpu_torch.parallel.collectives import broadcast_, from_first
from stargcn_tpu_torch.parallel.mesh import Mesh
from stargcn_tpu_torch.parallel.shardings import GraphShardings
from stargcn_tpu_torch.train.loop import (_STAT_NAMES, MeshTrainerBase,
                                          graph_features,
                                          make_metric_loggers,
                                          make_optimizer)
from stargcn_tpu_torch.train.prefetch import Prefetcher
from stargcn_tpu_torch.utils.device import resolve_device
from stargcn_tpu_torch.utils.model_info import model_info


def _round_up(n, m):
    return max(m, -(-n // m) * m)


# Where the ``pallas`` backend beat ``xla`` on the card, by more than the
# spread of the run's own timing windows, in every run that measured the
# cell: for each column (the whole training step; the whole sampled
# forward, as evaluation runs it) ``(smallest, largest)`` largest frontier
# cap and ``(smallest, largest)`` fanout.  Measured on NVIDIA H100 80GB
# HBM3, 700.00 W by ``python -m stargcn_tpu_torch.probes.ell_crossover_sweep``
# and its model rows (logs ``sweep20.txt``, ``sweep20b.txt``,
# ``rows20c.txt``, ``sweep20q.txt``, ``rows20d_1.txt`` to ``_3.txt``,
# ``p20a.txt``, ``final20.txt``; ``PERF.md`` section 6).  Neither the cap
# nor the fanout decides alone:
#
# * the ML-10M-sized cells (R = 10; batches 256 to 4096 move the largest
#   cap by 15% at most, so there the fanout decides): fanouts 16 and 32
#   (caps 96,256-111,616) won both columns in every run, forward
#   1.26-1.85x, step 1.17-2.12x; fanout 8 (caps 70,656-87,040) tied, the
#   forward within 2%, the step within 13%;
# * the cells at caps of 9,984 and below (R = 5; steps of 18-35 ms that
#   are launch-bound, their windows spreading by up to 7.6 ms): the
#   ML-1M-sized cell (caps 9,984 / 6,144) at fanout 8 won the forward in
#   seven runs of seven (1.17-1.49x) and the step in three of seven; every
#   other cell there (ML-1M at fanouts 16 and 32, ML-100k's caps 3,072 /
#   1,792 at fanouts 8 to 32) won neither column in every run.
#
# Caps and fanouts outside these windows were not measured to favour the
# kernels and take ``xla``, the JAX package's default.
PALLAS_WINDOWS = {
    "training": (((96_256, 111_616), (16, 32)),),
    "forward": (((9_984, 9_984), (8, 8)), ((96_256, 111_616), (16, 32))),
}


def resolve_sampled_backend(backend: str, caps: dict, fanout: int, *,
                            for_training: bool = True, device="cuda",
                            plan_device: bool = False) -> str:
    """'auto' -> a backend for the plan shapes, the step kind and the
    device; 'pallas' and 'xla' pass through.

    The table is this card's (``PALLAS_WINDOWS``): ``'pallas'`` where the
    tensors lie on the card and the largest frontier cap and the fanout
    fall in a window of the column (training, or forward only) where the
    whole step or the whole forward on ``'pallas'`` beat ``'xla'`` in every
    run (NVIDIA H100 80GB HBM3, 700.00 W; ``python -m
    stargcn_tpu_torch.probes.ell_crossover_sweep``, logs ``sweep20b.txt``,
    ``rows20c.txt``, ``rows20d_*.txt`` and the others named above
    ``PALLAS_WINDOWS``); else ``'xla'``.  ``auto`` on the CPU is ``'xla'``, and so is training with
    ``plan_device`` (``SampledTrainer`` refuses ``'pallas'`` there).  The
    JAX package's table (forward only inside caps of 32,768 and fanouts 16
    to 32, training ``xla`` at every shape) was measured on its TPU and
    does not hold here: at ML-10M's caps the kernels win from fanout 16 up
    in both columns and tie at fanout 8.
    """
    if backend != "auto":
        return backend
    if torch.device(device).type != "cuda" or (for_training and plan_device):
        return "xla"
    d_max = max(caps.values()) if caps else 1 << 30
    windows = PALLAS_WINDOWS["training" if for_training else "forward"]
    return "pallas" if any(
        lo <= d_max <= hi and k_lo <= fanout <= k_hi
        for (lo, hi), (k_lo, k_hi) in windows) else "xla"


class SampledTrainer(MeshTrainerBase):
    """Sampled-mode trainer with the ``Trainer`` schedule.

    Shares the full-graph model's parameters (``self.model`` is the
    ``STARGCN`` module, used as their container; checkpoints interchange
    with ``Trainer``); ``models/sampled.py`` executes the same math over
    sampled frontiers.

    Args:
      model_cfg: a ``STARGCNConfig`` (its full-graph ``backend`` is not
        read).
      data_iter, settings: as for ``Trainer``.
      fanout: neighbors sampled per node and level (> 0).
      frontier_caps: ``{'user': n, 'item': n}``; probed from a few plans
        (times ``cap_slack``) when not given.
      backend: ``'xla'`` | ``'pallas'`` | ``'auto'``
        (``resolve_sampled_backend``).
      planner: ``BlockSampler``'s route: ``'native'`` (the fused planner
        of the port's C++ extension, the JAX package's route once its
        extension is built), ``'vectorised'`` or ``'loop'``.
      device: where the parameters and the step live (default the card).
      plan_device: build the training plans on the device
        (``DevicePlanner``, fanout drawn with replacement); pairs with the
        ``xla`` backend.  ``plan_uniform(shape)`` gives its draws (by
        default from a generator seeded with the settings' seed).
      remat: recompute each level of the sampled forward in the backward
        (``sampled_forward(remat=True)``): less memory, the same loss and
        gradients.
      mesh: a ``parallel.Mesh`` (``parallel.make_mesh``) to train on, one
        process a rank (see the module docstring); on ranks other than
        the first, the batches given to ``train_iteration`` /
        ``train_chunk`` are not read (pass ``None``).
    """

    def __init__(self, model_cfg, data_iter, settings, *, fanout,
                 save_dir: Optional[str] = None, save_id: int = 0,
                 frontier_caps=None, name_user="user", name_item="movie",
                 backend: str = "xla", cap_slack: float = 1.6,
                 planner: str = "native", device="cuda", mesh=None,
                 plan_device: bool = False, remat: bool = False):
        if fanout <= 0:
            raise ValueError("SampledTrainer needs a positive fanout")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a stargcn_tpu_torch.parallel.Mesh "
                            f"(parallel.make_mesh), not {type(mesh)!r}")
        if model_cfg.use_dae and not model_cfg.use_embed:
            raise NotImplementedError(
                "sampled DAE reconstruction needs embedding targets "
                "(MODEL.USE_EMBED); feature-only input trains with "
                "MODEL.USE_DAE false and MODEL.NBLOCKS 1")
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.s = settings
        self.fanout = fanout
        self.save_dir = save_dir
        self.save_id = save_id
        self.backend = backend
        self.names = (name_user, name_item)
        self.device = resolve_device(device)
        self.remat = bool(remat)
        self.mesh = mesh
        self.shardings = None
        if mesh is not None:
            if mesh.rank not in mesh.grid:
                raise ValueError(f"rank {mesh.rank} lies outside the "
                                 f"{mesh.shape} mesh")
            if mesh.backend == "nccl" and self.device.type != "cuda":
                raise ValueError("an NCCL mesh trains on cuda tensors")
            self.shardings = GraphShardings(mesh)
        # The packed spec the ranks last agreed on (``_feed`` on a mesh).
        self._mesh_spec = None
        self._fea = graph_features(data_iter, model_cfg, self.device)

        it = data_iter
        train_ratings = it.train_ratings
        self.rating_mean = float(train_ratings.mean())
        self.rating_std = float(train_ratings.std())
        vals = it.possible_rating_values
        self.rating_min = float(vals.min())
        self.rating_max = float(vals.max())

        n_train = it.train_node_pairs.shape[1]
        self.train_batch = min(self.s.rating_batch_size, n_train)
        # Batch edges are removed only when the batch is a strict subset
        # of the training edges.
        self.do_remove = self.s.remove_rating and self.train_batch < n_train
        # Array sizes round up to a multiple of 16 (padded slots carry
        # valid=0 / id=-1 and are masked everywhere), as in the JAX
        # package, so packed buffers compare like for like.
        self.train_batch_pad = _round_up(self.train_batch, 16)

        # Fixed-size recon batches (pad with -1).
        self.recon_cap = {"user": 0, "item": 0}
        if self.s.use_dae:
            for t, key in (("user", name_user), ("item", name_item)):
                n_recon = int(np.ceil(
                    it.embed_P_mask[key]
                    * it.recon_train_candidates[key].size))
                self.recon_cap[t] = _round_up(
                    min(self.s.recon_batch_size, n_recon), 16)

        L = len(model_cfg.agg_units)
        self.samplers = {
            seg: BlockSampler(g, num_layers=L, fanout=fanout,
                              symm=model_cfg.agg_norm_symm,
                              name_user=name_user, name_item=name_item,
                              planner=planner)
            for seg, g in (("train", it.train_graph),
                           ("valid", it.val_graph),
                           ("test", it.test_graph))}
        if frontier_caps is not None:
            caps = dict(frontier_caps)
        elif self._plans:
            caps = self._probe_caps(cap_slack)
        else:
            caps = {"user": 0, "item": 0}
        caps = torch.tensor([caps["user"], caps["item"]], dtype=torch.int64)
        if mesh is not None:
            # Every rank takes the first rank's caps (it alone probes).
            caps = from_first(caps.to(self.device), mesh.group("all"))
        self._take_caps(caps)
        logging.info("sampled frontier caps: %s", self.caps)
        if self.backend == "auto":
            # evaluation is forward-only and resolves on its own column
            # of the table; resolve BOTH before the training default
            # overwrites self.backend.
            self.eval_backend = resolve_sampled_backend(
                "auto", self.caps, fanout, for_training=False,
                device=self.device)
            self.backend = resolve_sampled_backend(
                "auto", self.caps, fanout, device=self.device,
                plan_device=plan_device)
            logging.info("sampled backend resolved to %r (train) / %r "
                         "(eval) (caps %s, fanout %d)", self.backend,
                         self.eval_backend, self.caps, fanout)
        else:
            self.eval_backend = self.backend

        self.model = self._init_params()
        sharded = {}
        if self.shardings is not None:
            sharded = {k: sh.group for k, sh in
                       self.shardings.place_params(self.model).items()}
        # Dropout masks: one stream, on the model's device (on a mesh, the
        # same stream on every rank).
        self._dropout_gen = torch.Generator(device=self.device)
        self._dropout_gen.manual_seed(self.s.seed)
        self.opt = make_optimizer(self.s, self.model.named_parameters(),
                                  sharded)
        self.lr = self.s.lr

        # Device-planned mode: training plans are built inside the step;
        # evaluation keeps host plans (eval graphs, eval cadence).
        self.plan_device = bool(plan_device)
        self._stat_names = _STAT_NAMES
        if self.plan_device:
            if self.backend == "pallas":
                raise NotImplementedError(
                    "plan_device pairs with the xla sampled backend")
            self._dev_tables = DeviceGraphTables.build(
                it.train_graph, name_user, name_item, self.device)
            # The JAX package probes its REMOVE_RATING bound here from
            # three batches of the shared sampler stream.  The port's
            # exclusion is exact and needs no bound; it makes the same
            # draws so that its later batches stay the JAX package's.
            probe = it.rating_sampler(batch_size=self.train_batch,
                                      segment="train")
            for _ in range(3):
                next(probe)
            self._plan_gen = torch.Generator(device=self.device)
            self._plan_gen.manual_seed(self.s.seed)
            self.plan_uniform = uniform_from(self._plan_gen)
            self._stat_names = _STAT_NAMES + _PLAN_STAT_NAMES

    # ------------------------------ setup -----------------------------------

    @property
    def _plans(self) -> bool:
        """Whether this process draws and plans the batches: always on one
        process, the first rank on a mesh."""
        return self.mesh is None or self.mesh.leader

    def _take_caps(self, caps):
        """Adopt the caps ``(user, item)`` (a tensor or a sequence) and
        point every sampler at them."""
        caps = [int(c) for c in caps]
        self.caps = {"user": caps[0], "item": caps[1]}
        for smp in self.samplers.values():
            smp.frontier_caps = self.caps

    def _probe_caps(self, slack: float):
        """Derive frontier caps from a few probe plans (train batches +
        the widest eval batch per segment), padded by ``slack``."""
        it = self.data_iter
        caps = {"user": 0, "item": 0}

        def grow(plan):
            for chain in plan.chains:
                for f in chain.frontiers:
                    for t in ("user", "item"):
                        caps[t] = max(caps[t], int(f[t].size))

        rs = it.rating_sampler(batch_size=self.train_batch,
                               segment="train")
        recon = (it.recon_nodes_sampler(batch_size=self.s.recon_batch_size)
                 if self.s.use_dae else None)
        for _ in range(2):
            pairs, _ = next(rs)
            kw = {}
            if recon is not None:
                _, batch_ids, _ = next(recon)
                ru, ri = self._pad_recon(batch_ids)
                kw = dict(recon_user_ids=ru, recon_item_ids=ri)
            grow(StackedPlan.build(
                it.train_graph, self.model_cfg, pairs[0], pairs[1],
                fanout=self.fanout, sampler=self.samplers["train"], **kw))
        for seg in ("valid", "test"):
            pairs = (it.valid_node_pairs if seg == "valid"
                     else it.test_node_pairs)
            bs = min(self.train_batch, max(1, pairs.shape[1]))
            grow(StackedPlan.build(
                it.val_graph if seg == "valid" else it.test_graph,
                self.model_cfg, pairs[0, :bs], pairs[1, :bs],
                fanout=self.fanout, sampler=self.samplers[seg]))
        return {t: _round_up(int(v * slack), 256) for t, v in caps.items()}

    def _init_params(self):
        """The full-graph module, initialised from the settings' seed as
        ``Trainer`` initialises it (the parameters depend only on the node
        and link counts, not on the full-graph backend), on the device."""
        cfg = dataclasses.replace(self.model_cfg, backend="bitdense",
                                  dropout_per_edge=False)
        model = STARGCN(
            cfg, generator=torch.Generator().manual_seed(self.s.seed),
            feature_dims=feature_dims(self.data_iter))
        return model.to(self.device)

    @property
    def params(self):
        """The parameters by name (``named_parameters``)."""
        return dict(self.model.named_parameters())

    def seed_dropout(self, seed: int):
        """Restart the dropout stream from ``seed``."""
        self._dropout_gen.manual_seed(seed)

    # --------------------------- batch building ------------------------------

    def _pad_recon(self, batch_ids_dict):
        """Fixed-shape recon id arrays (pad with -1)."""
        nu, ni = self.names
        out = []
        for t, key in (("user", nu), ("item", ni)):
            cap = self.recon_cap[t]
            ids = np.asarray(batch_ids_dict.get(key, ()), np.int32)[:cap]
            arr = np.full(cap, -1, np.int32)
            arr[:ids.size] = ids
            out.append(arr)
        return out

    def _make_batch(self, rating_sampler, recon_sampler):
        """Host-only batch construction (it runs in ``fit``'s prefetch
        thread: no device op here): the next rating batch (padded), the
        noise arrays and recon ids of the next recon batch, and the plan
        over them.  Returns ``(plan, (bu, bi), gt, valid, noise_u,
        noise_i)``, or with ``plan_device`` the raw arrays by name."""
        pairs, gt = next(rating_sampler)
        n = gt.size
        B = self.train_batch_pad
        bu = np.zeros(B, np.int32)
        bi = np.zeros(B, np.int32)
        gt_pad = np.zeros(B, np.float32)
        valid = np.zeros(B, np.float32)
        bu[:n], bi[:n], gt_pad[:n], valid[:n] = (
            pairs[0], pairs[1], gt, 1.0)
        kw = {}
        if recon_sampler is not None:
            noise_dict, batch_ids, _ = next(recon_sampler)
            nu, ni = self.names
            noise_u = noise_dict[nu].astype(np.int32)
            noise_i = noise_dict[ni].astype(np.int32)
            ru, ri = self._pad_recon(batch_ids)
            kw = dict(recon_user_ids=ru, recon_item_ids=ri)
        else:
            noise_u = np.arange(self.model_cfg.num_users, dtype=np.int32)
            noise_i = np.arange(self.model_cfg.num_items, dtype=np.int32)
        if self.plan_device:
            none = np.zeros(0, np.int32)
            return {"bu": bu, "bi": bi, "gt": gt_pad, "valid": valid,
                    "noise_u": noise_u, "noise_i": noise_i,
                    "recon_u": kw.get("recon_user_ids", none),
                    "recon_i": kw.get("recon_item_ids", none)}
        exclude = (pairs[0], pairs[1]) if self.do_remove else None
        plan = StackedPlan.build(
            self.data_iter.train_graph, self.model_cfg, bu[:n], bi[:n],
            fanout=self.fanout, sampler=self.samplers["train"],
            exclude_pairs=exclude, **kw)
        return plan, (bu, bi), gt_pad, valid, noise_u, noise_i

    # ------------------------------ driving ----------------------------------

    def _pack_batch(self, batch):
        """``(int_buf, float_buf, spec)`` of one batch: the plan with the
        padded batch's positions, the noise arrays, targets and validity;
        or a ``plan_device`` batch's raw arrays."""
        if isinstance(batch, dict):
            return pack_tree(batch)
        plan, (bu, bi), gt, valid, noise_u, noise_i = batch
        ht = plan.as_host_tree()
        # Replace the plan's (unpadded, variable-length) pairs_pos with
        # the padded-batch positions so the packed spec stays constant.
        ht["pairs_pos"] = _pairs_positions(plan, bu, bi)
        return pack_tree({
            "plan": ht, "noise_u": noise_u, "noise_i": noise_i,
            "gt": gt, "valid": valid})

    def _feed(self, packed):
        """The packed batch on the device, unpacked: two copies.  On a
        mesh the first rank's ``packed`` reaches every rank (the others
        pass ``None``): a header ``[int length, float length, user cap,
        item cap, spec bytes]`` is broadcast, then the spec (pickled) when
        it differs from the one last sent, then the two buffers; every
        rank takes the first rank's caps."""
        if self.mesh is None:
            ibuf, fbuf, spec = packed
            return unpack_tree(torch.from_numpy(ibuf).to(self.device),
                               torch.from_numpy(fbuf).to(self.device), spec)
        group = self.mesh.group("all")
        head = torch.zeros(5, dtype=torch.int64, device=self.device)
        if self._plans:
            ibuf, fbuf, spec = packed
            blob = (b"" if spec == self._mesh_spec
                    else pickle.dumps(spec, protocol=4))
            head = torch.tensor([ibuf.size, fbuf.size, self.caps["user"],
                                 self.caps["item"], len(blob)],
                                dtype=torch.int64, device=self.device)
        head = broadcast_(head, group).tolist()
        if head[4]:
            raw = torch.zeros(head[4], dtype=torch.uint8, device=self.device)
            if self._plans:
                raw.copy_(torch.frombuffer(bytearray(blob), dtype=torch.uint8))
            self._mesh_spec = pickle.loads(
                broadcast_(raw, group).cpu().numpy().tobytes())
        self._take_caps(head[2:4])
        if self._plans:
            ib = torch.from_numpy(ibuf).to(self.device)
            fb = torch.from_numpy(fbuf).to(self.device)
        else:
            ib = torch.empty(head[0], dtype=torch.int32, device=self.device)
            fb = torch.empty(head[1], dtype=torch.float32, device=self.device)
        return unpack_tree(broadcast_(ib, group), broadcast_(fb, group),
                           self._mesh_spec)

    # ---------------------- frontier-cap recovery ----------------------

    def _grow_caps(self, needed: dict, slack: float = 1.3):
        """Grow the frontier caps past an observed overflow and point
        every sampler at the new caps.  The next step's tensors take the
        new shapes and the run continues — a rare large frontier must
        never be fatal mid-``fit``."""
        for t, n in needed.items():
            new = _round_up(int(n * slack), 256)
            if new > self.caps.get(t, 0):
                logging.warning(
                    "frontier cap for %r grew %d -> %d (overflow "
                    "recovery)", t, self.caps.get(t), new)
                self.caps[t] = new
        for s in self.samplers.values():
            s.frontier_caps = self.caps

    def _replan(self, batch):
        """Rebuild a batch's plan under the CURRENT caps (same pairs,
        noise and recon ids; the neighborhoods are re-sampled)."""
        plan, (bu, bi), gt, valid, noise_u, noise_i = batch
        n = int(valid.sum())
        exclude = (bu[:n], bi[:n]) if self.do_remove else None
        kw = {}
        if self.recon_cap.get("user", 0) or self.recon_cap.get("item", 0):
            kw = dict(recon_user_ids=plan.recon_ids["user"],
                      recon_item_ids=plan.recon_ids["item"])
        new_plan = StackedPlan.build(
            self.data_iter.train_graph, self.model_cfg, bu[:n], bi[:n],
            fanout=self.fanout, sampler=self.samplers["train"],
            exclude_pairs=exclude, **kw)
        return new_plan, (bu, bi), gt, valid, noise_u, noise_i

    def _build_batch_safe(self, rating_sampler, recon_sampler):
        """``_make_batch`` with frontier-cap overflow recovery."""
        while True:
            try:
                return self._make_batch(rating_sampler, recon_sampler)
            except FrontierCapError as e:
                self._grow_caps(e.needed)

    def train_iteration(self, batch):
        """One optimisation step on a ``_make_batch`` batch.  Returns a
        dict of device-side stats (``loss``, ``gnorm`` scalars;
        ``rating_loss``, ``recon_loss``, ``sq_err`` per block; with
        ``plan_device`` also ``overflow`` and the ``needed_*`` counts)."""
        feed = self._feed(self._pack_batch(batch) if self._plans else None)
        if self.plan_device:
            return self._device_update(*self._device_plan(feed), feed)
        return _loss_update(self, feed)

    def loss_and_grads(self, batch):
        """The training forward and backward of one batch, without the
        update: ``(stats, grads)`` with ``train_iteration``'s device-side
        stats but ``gnorm`` (and, with ``plan_device``, the plan's), and
        the gradient of the loss for every parameter, by name (on a mesh,
        this rank's rows of a split table).  One draw from the dropout
        stream."""
        feed = self._feed(self._pack_batch(batch) if self._plans else None)
        if not self.plan_device:
            return _loss_and_grads(self, feed)
        plan, pairs_pos, aux = self._device_plan(feed)
        return _loss_and_grads(self, dict(feed, plan=dict(
            plan, pairs_pos=pairs_pos)), identity=aux["identity"])

    def _device_plan(self, feed):
        """The device planning phase of a ``plan_device`` feed: ``(plan,
        pairs_pos, aux)`` of ``DevicePlanner.build``."""
        tab = self._dev_tables
        planner = DevicePlanner(self.model_cfg, self.caps, self.fanout,
                                symm=self.model_cfg.agg_norm_symm)
        return planner.build(
            tab, self.plan_uniform,
            tab.id2ind["user"].index_select(0, feed["bu"]),
            tab.id2ind["item"].index_select(0, feed["bi"]), feed["valid"],
            feed["recon_u"], feed["recon_i"], exclude=self.do_remove)

    def _device_update(self, plan, pairs_pos, aux, feed):
        """Loss and update over a device-built plan.  An overflowed step
        (a frontier cut at its cap) leaves the parameters and the
        optimiser state as they were, and its ``sq_err``, ``rating_loss``,
        ``recon_loss`` and ``gnorm`` read 0 so that ``fit``'s sums stay
        clean; the stats carry ``overflow`` and the ``needed_*`` counts."""
        feed = dict(feed, plan=dict(plan, pairs_pos=pairs_pos))
        stats, grads = _loss_and_grads(self, feed,
                                       identity=aux["identity"])
        keep = ~aux["overflow"]
        stats["gnorm"] = self.opt.step(grads, keep=keep)
        for k in ("sq_err", "rating_loss", "recon_loss", "gnorm"):
            stats[k] = stats[k] * keep.to(stats[k].dtype)
        for k in _PLAN_STAT_NAMES:
            stats[k] = aux[k]
        return stats

    def train_chunk(self, batches):
        """k optimisation steps in one call: a loop of ``train_iteration``
        with the same dropout stream as k single calls.  Batches planned
        under caps that have grown since are planned again first.  Returns
        stats stacked along a leading k axis."""
        if self.plan_device:
            steps = [self.train_iteration(b) for b in batches]
            return {k: torch.stack([st[k] for st in steps])
                    for k in self._stat_names}
        if not self._plans:
            steps = [_loss_update(self, self._feed(None)) for _ in batches]
            return {k: torch.stack([st[k] for st in steps])
                    for k in _STAT_NAMES}
        packed = [self._pack_batch(b) for b in batches]
        spec = packed[-1][2]
        if any(p[2] != spec for p in packed[:-1]):
            batches = [b if packed[i][2] == spec else self._replan(b)
                       for i, b in enumerate(batches)]
            packed = [self._pack_batch(b) for b in batches]
            if any(p[2] != spec for p in packed):
                raise ValueError(
                    "train_chunk needs a constant packed spec across "
                    "the chunk (fixed caps/batch)")
        steps = [_loss_update(self, self._feed(p)) for p in packed]
        return {k: torch.stack([st[k] for st in steps])
                for k in _STAT_NAMES}

    @torch.no_grad()
    def evaluate(self, segment: str = "valid"):
        """Per-block RMSE with fanout-sampled neighborhoods on the eval
        graph and cold-start eval noise; predictions are denormalised and
        clipped to the rating range.  On a mesh the first rank plans each
        batch, and every rank returns its RMSE."""
        it = self.data_iter
        pairs = (it.valid_node_pairs if segment == "valid"
                 else it.test_node_pairs)
        ratings = (it.valid_ratings if segment == "valid"
                   else it.test_ratings)
        graph = it.val_graph if segment == "valid" else it.test_graph
        sampler = self.samplers[segment]
        nu, ni = self.names
        noise_u = np.asarray(it.evaluate_embed_noise_dict[nu], np.int32)
        noise_i = np.asarray(it.evaluate_embed_noise_dict[ni], np.int32)
        B = self.train_batch_pad
        sq_sum = torch.zeros(self.model_cfg.nblocks, dtype=torch.float64,
                             device=self.device)
        cnt = 0
        for start in range(0, pairs.shape[1], B):
            end = min(start + B, pairs.shape[1])
            n = end - start
            bu = np.zeros(B, np.int32)
            bi = np.zeros(B, np.int32)
            gt = np.zeros(B, np.float32)
            valid = np.zeros(B, np.float32)
            bu[:n], bi[:n] = pairs[0, start:end], pairs[1, start:end]
            gt[:n], valid[:n] = ratings[start:end], 1.0
            packed = None
            while self._plans:
                try:
                    plan = StackedPlan.build(
                        graph, self.model_cfg, bu[:n], bi[:n],
                        fanout=self.fanout, sampler=sampler)
                    packed = self._pack_batch(
                        (plan, (bu, bi), gt, valid, noise_u, noise_i))
                    break
                except FrontierCapError as e:
                    self._grow_caps(e.needed)
            sq_sum += _eval_step(self, self._feed(packed))
            cnt += n
        if self.mesh is not None:
            # One number on every rank: fit's schedule decides by it.
            sq_sum = self._from_first(sq_sum, "all")
        return np.sqrt(sq_sum.cpu().numpy() / max(cnt, 1))

    # -------------------------------- fit ------------------------------------

    def fit(self, max_iter: Optional[int] = None, log=logging.info,
            prefetch: bool = False, prefetch_omp_threads: int = 2):
        """The training schedule of ``Trainer.fit`` over sampled
        mini-batches: steps, a train log line every ``log_interval``,
        validation every ``valid_interval`` with a test evaluation and the
        best checkpoint on improvement, LR decay after ``decay_patience``
        validations without one, early stopping at ``min_lr``, recovery
        from a non-finite loss (restore the best checkpoint, halve the
        LR), and the last checkpoint at the end.  With ``plan_device``,
        steps rejected on frontier-cap overflow grow the caps at the next
        log line.

        ``prefetch`` builds batches (draws and host plans) in a producer
        thread one to two batches ahead of the step; it stops when ``fit``
        returns or raises.  The host planner's neighbour stream is shared
        with evaluation, so with host plans a prefetched ``fit`` that
        validates draws other neighbourhoods than a serial one (the
        batches are the same), as in the JAX package.  The producer caps
        its own OpenMP teams at ``prefetch_omp_threads`` (``kernels.
        set_omp_threads``, a per-thread setting: the main thread's calls
        keep the full team), so that its planner teams leave cores to the
        thread that launches the card's work; ``python -m
        stargcn_tpu_torch.train --prefetch`` also makes OpenMP's idle
        threads sleep instead of spinning."""
        s = self.s
        it = self.data_iter
        max_iter = max_iter or s.max_iter
        rating_sampler = it.rating_sampler(batch_size=self.train_batch,
                                           segment="train")
        recon_sampler = (it.recon_nodes_sampler(
            batch_size=s.recon_batch_size) if s.use_dae else None)
        nb = self.model_cfg.nblocks
        if self.save_dir is not None:
            # net%d.txt architecture dump (reference gluon_net_info), of
            # the whole parameters.
            params = self.whole_params()
            if self._writes_files:
                model_info(params, os.path.join(
                    self.save_dir, f"net{self.save_id}.txt"))

        def next_batch():
            if not self._plans:
                return None
            return self._build_batch_safe(rating_sampler, recon_sampler)

        # Steps per train_chunk call, when the cadence allows.
        k = s.scan_steps if (s.scan_steps > 1
                             and s.log_interval % s.scan_steps == 0
                             and s.valid_interval % s.scan_steps == 0
                             and max_iter >= s.scan_steps) else 1
        with contextlib.ExitStack() as stack:
            if prefetch:
                next_batch = stack.enter_context(Prefetcher(
                    next_batch, -(-max_iter // k) * k,
                    setup=lambda: graph_kernels.set_omp_threads(
                        prefetch_omp_threads))).get
            best_iter, best_valid_rmse, best_test_rmse = self._fit_loop(
                max_iter, k, next_batch, log)
        self.save_checkpoint("last")
        log(f"Best Iter={best_iter}, "
            f"Best Valid RMSE={best_valid_rmse:.4f}, "
            + (", ".join(f"Best Test RMSE{i}={best_test_rmse[i]:.4f}"
                         for i in range(nb))
               if best_test_rmse is not None else "no test eval"))
        return {"best_iter": best_iter,
                "best_valid_rmse": float(best_valid_rmse),
                "best_test_rmse": (None if best_test_rmse is None
                                   else [float(x) for x in best_test_rmse])}

    def _fit_loop(self, max_iter, k, next_batch, log):
        """``fit``'s steps, logging, validation and schedule; returns
        ``(best_iter, best_valid_rmse, best_test_rmse)``."""
        s = self.s
        loggers = make_metric_loggers(
            self.save_dir if self._writes_files else None, self.save_id,
            self.model_cfg.nblocks)
        nb = self.model_cfg.nblocks
        names = self._stat_names
        best_valid_rmse = np.inf
        best_test_rmse = None
        best_iter = -1
        no_better = 0
        stop = False
        t_start = time.time()
        # Stats stay on the device between log intervals; each entry is
        # the stats of one call flattened in ``names`` order, one row per
        # step.
        pending = []
        pending_cnt = 0
        iter_idx = 0
        while iter_idx < max_iter:
            if k == 1:
                stats = self.train_iteration(next_batch())
            else:
                stats = self.train_chunk([next_batch() for _ in range(k)])
            iter_idx += k
            pending.append(torch.cat(
                [stats[name].reshape(k, -1).float() for name in names], 1))
            pending_cnt += self.train_batch * k

            logging_str = ""
            if iter_idx % s.log_interval == 0:
                fetched = torch.cat(pending).double()
                if self.mesh is not None:
                    # The schedule's decisions read the mesh's first rank.
                    fetched = self._from_first(fetched, "all")
                fetched = fetched.cpu().numpy()
                n_batches = fetched.shape[0]
                last_loss = float(fetched[-1, 0])
                gn = fetched[:, 1].sum()
                rl = fetched[:, 2:2 + nb].sum(axis=0)
                cl = fetched[:, 2 + nb:2 + 2 * nb].sum(axis=0)
                sq = fetched[:, 2 + 2 * nb:2 + 3 * nb].sum(axis=0)
                pending, n_pairs = [], pending_cnt
                pending_cnt = 0
                if self.plan_device:
                    self._grow_caps_after_overflow(
                        dict(zip(names[len(_STAT_NAMES):],
                                 fetched[:, 2 + 3 * nb:].T)), log)
                if not np.isfinite(last_loss):
                    log(f"Non-finite loss at iter {iter_idx}; "
                        "restoring best checkpoint and halving LR.")
                    ckpt = self._checkpoint_path("best")
                    if ckpt and os.path.exists(ckpt):
                        self.restore_checkpoint(ckpt)
                    self.set_lr(max(self.lr * 0.5, s.min_lr))
                    continue
                rmse = np.sqrt(sq / max(n_pairs, 1))
                row = {"iter": iter_idx, "loss": last_loss}
                for i in range(nb):
                    row[f"rmse{i}"] = rmse[i]
                    row[f"rating_loss{i}"] = rl[i] / n_batches
                    row[f"recon_loss{i}"] = cl[i] / n_batches
                loggers["train"].log(**row)
                dt = time.time() - t_start
                logging_str = (
                    f"Iter={iter_idx}, gnorm={gn / n_batches:.3f}, "
                    f"loss={last_loss:.3f}, "
                    + ", ".join(f"RMSE{i}={rmse[i]:.3f}"
                                for i in range(nb))
                    + f", {n_pairs / dt:.0f} pairs/s")
                t_start = time.time()

            if iter_idx % s.valid_interval == 0:
                valid_rmse = self.evaluate("valid")
                loggers["valid"].log(**{"iter": iter_idx, **{
                    f"rmse{i}": valid_rmse[i] for i in range(nb)}})
                logging_str += ", " + ", ".join(
                    f"Val RMSE{i}={valid_rmse[i]:.3f}"
                    for i in range(nb))
                if valid_rmse[-1] < best_valid_rmse:
                    best_valid_rmse = valid_rmse[-1]
                    no_better = 0
                    best_iter = iter_idx
                    best_test_rmse = self.evaluate("test")
                    loggers["test"].log(**{"iter": iter_idx, **{
                        f"rmse{i}": best_test_rmse[i]
                        for i in range(nb)}})
                    logging_str += ", " + ", ".join(
                        f"Test RMSE{i}={best_test_rmse[i]:.4f}"
                        for i in range(nb))
                    self.save_checkpoint("best")
                else:
                    no_better += 1
                    if (no_better > s.early_stopping_patience
                            and self.lr <= s.min_lr):
                        log("Early stopping threshold reached.")
                        stop = True
                    elif no_better > s.decay_patience:
                        new_lr = max(self.lr * s.lr_decay_factor,
                                     s.min_lr)
                        if new_lr < self.lr:
                            log(f"\tChange the LR to {new_lr:g}")
                            self.set_lr(new_lr)
                            no_better = 0
            if logging_str:
                log(logging_str)
            if stop:
                break
        for lg in loggers.values():
            lg.close()
        return best_iter, best_valid_rmse, best_test_rmse

    def _grow_caps_after_overflow(self, cols, log):
        """``plan_device``: grow the caps past the frontiers that steps
        rejected on overflow needed (``cols``: the fetched ``overflow`` and
        ``needed_*`` columns, one row per step)."""
        n_over = int(cols["overflow"].sum())
        if n_over:
            need = {t: int(cols[f"needed_{t}"].max())
                    for t in ("user", "item")}
            log(f"{n_over} step(s) skipped on frontier-cap overflow; "
                f"growing caps to cover {need}")
            self._grow_caps(need)

# ----------------------------- step functions --------------------------------

# The extra stats of a ``plan_device`` step.
_PLAN_STAT_NAMES = ("overflow", "needed_user", "needed_item",
                    "needed_exclude")


def _pairs_positions(plan, bu, bi):
    """Positions of the (padded) batch pairs in each block's top
    frontier, as host numpy arrays — they ship inside the packed feed
    (padded slots resolve to position 0 and are masked by ``valid``)."""
    out = []
    for chain in plan.chains:
        top = chain.frontiers[-1]

        def pos_of(ids, arr):
            size = int(max(arr.max(initial=0), ids.max(initial=0))) + 1
            pmap = np.zeros(size + 1, np.int32)
            ok = arr >= 0
            pmap[arr[ok]] = np.nonzero(ok)[0]
            return pmap[np.minimum(ids, size)].astype(np.int32)

        out.append({"user": pos_of(bu, top["user"]),
                    "item": pos_of(bi, top["item"])})
    return out


def _sampled_outputs(trainer, feed, *, train, identity=None):
    backend = trainer.backend if train else trainer.eval_backend
    return sampled_forward(
        trainer.model, trainer.model_cfg, feed["plan"], feed["noise_u"],
        feed["noise_i"], backend=backend, train=train,
        generator=trainer._dropout_gen,
        features=trainer._fea, row_sharding=trainer.mesh,
        identity_frontiers=identity, remat=trainer.remat)


def _loss_and_grads(trainer, feed, identity=None):
    """Loss, statistics and per-parameter gradients over an unpacked
    feed (``identity``: the device plan's identity frontiers)."""
    cfg, s = trainer.model_cfg, trainer.s
    mean, std = trainer.rating_mean, trainer.rating_std
    gt_ratings, pairs_valid = feed["gt"], feed["valid"]
    n_valid = pairs_valid.sum().clamp_min(1.0)

    out = _sampled_outputs(trainer, feed, train=True, identity=identity)
    target = (gt_ratings - mean) / std
    sq = (out["pred_ratings"] - target[None, :]) ** 2
    rating_loss = 0.5 * (sq * pairs_valid[None, :]).sum(dim=1) / n_valid
    loss = rating_loss.sum()
    recon_loss = torch.zeros(cfg.nblocks, device=trainer.device)
    if s.use_dae and out["pred_embed"]:
        recon_loss = recon_losses(out)
        loss = loss + s.recon_lambda * recon_loss.sum()

    names, params = zip(*trainer.model.named_parameters())
    grads = {k: (torch.zeros_like(p) if g is None else g)
             for k, p, g in zip(names, params, torch.autograd.grad(
                 loss, params, allow_unused=True))}
    if trainer.mesh is not None:
        grads = trainer._replica_grads(grads)
    with torch.no_grad():
        denorm = out["pred_ratings"] * std + mean
        sq_err = ((denorm - gt_ratings[None, :]) ** 2
                  * pairs_valid[None, :]).sum(dim=1)
    return {"loss": loss.detach(), "rating_loss": rating_loss.detach(),
            "recon_loss": recon_loss.detach(), "sq_err": sq_err}, grads


def _loss_update(trainer, feed):
    """Loss + clipped Adam update over an unpacked feed."""
    stats, grads = _loss_and_grads(trainer, feed)
    stats["gnorm"] = trainer.opt.step(grads)
    return stats


def _eval_step(trainer, feed):
    """Per-block sums of squared errors of the clipped, denormalised
    predictions over the valid pairs of one evaluation batch."""
    out = _sampled_outputs(trainer, feed, train=False)
    denorm = out["pred_ratings"] * trainer.rating_std + trainer.rating_mean
    clipped = denorm.clamp(trainer.rating_min, trainer.rating_max)
    sq = (clipped - feed["gt"][None, :]) ** 2
    return (sq * feed["valid"][None, :]).sum(dim=1)
