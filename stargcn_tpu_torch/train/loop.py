"""Full-graph training/evaluation engine for STAR-GCN (PyTorch).

The port of ``stargcn_tpu/train/loop.py`` on the full-graph backends
``bitdense``, ``ell``, ``dense`` and ``xla``:

* graph variants (train/valid/test) are edge masks over one static edge
  array (inductively the train and valid variants also lack the held-out
  nodes' edges, and at evaluation those nodes keep a zero embedding); their
  degrees, and the bit packs (``bitdense``), chunked-ELL packs (``ell``)
  or 0/1 dense adjacencies (``dense``), are built once (``GraphVariants``),
  the static operands on first use and shared between variants with
  identical masks;
* per-iteration batch-edge removal (``REMOVE_RATING``) is a host lookup of
  the batch pairs plus a batch-sized correction inside the model
  (``bitdense``, ``ell``, ``dense``), or the variant's mask with the
  batch's edges zeroed on the device by ``edge_mask_from_pairs``
  (``xla``);
* loss = sum over blocks of 0.5 * mean (pred - (r - mean) / std)^2 +
  RECON_LAMBDA * sum over blocks/types of mean-over-masked-nodes
  ||e_hat - e||^2;
* gradient global-norm clipping, Adam, and the patience-driven LR decay
  to MIN_LR with early stopping;
* batches come from the host samplers (with ``SCAN_STEPS`` > 1 a producer
  thread draws them and runs their pair lookup ahead of the step), or, with
  ``TRAIN.DEVICE_SAMPLER``, are drawn on the device from the train edges
  (``train_chunk_dev``), with no host array made or copied in a step.

With ``MODEL.USE_FEA_PROJ`` the raw node features go to the device once
(``graph_features``) and into every forward; with ``MODEL.COMPUTE_DTYPE``
bf16 the model computes in bf16 while the parameters, the optimiser state
and the loss stay float32.

A step is eager PyTorch: forward, ``backward`` (on ``bitdense`` through
``ops.bitdense.bit_pool_rated``, whose backward is the
``bit_reduce_matmul`` kernel on the card; on ``ell`` through
``ops.chunked_ell.ell_pool_rated``, whose backward pools over the
transpose packs; on ``dense`` and ``xla`` through cuBLAS products and
``index_add_``), clip, Adam.  ``index_add_``
and the gradient of a row gather use atomics on the card, so a step is not
bit-reproducible from run to run there, although both bit kernels are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from stargcn_tpu_torch.graph.device import BipartiteGraphData, EdgeSet
from stargcn_tpu_torch.models.stargcn import (STARGCN, STARGCNConfig,
                                              feature_dims)
from stargcn_tpu_torch.ops.agg import build_dense_adjacency
from stargcn_tpu_torch.ops.bitdense import (build_bit_pack,
                                           pack_row_interleave, resolve_impl)
from stargcn_tpu_torch.ops.chunked_ell import build_ell_pack
from stargcn_tpu_torch.train.prefetch import Prefetcher
from stargcn_tpu_torch.train.resilience import (ElasticPolicy, ElasticStep,
                                                HeartbeatMonitor)
from stargcn_tpu_torch.utils.device import resolve_device
from stargcn_tpu_torch.utils.logging import MetricLogger
from stargcn_tpu_torch.utils.model_info import model_info


def graph_features(data_iter, model_cfg, device):
    """``(user, item)``: the raw feature matrices of the data iterator's
    graph (the JAX package's ``user`` / ``movie``) as float32 tensors on
    ``device``, copied once; ``(None, None)`` unless the model projects
    features."""
    if not model_cfg.use_fea_proj:
        return None, None
    with torch.inference_mode(False):
        dev = data_iter.all_graph.device_features(device)
    return dev[data_iter.name_user], dev[data_iter.name_item]


def check_feature_only_dae(model_cfg, use_dae):
    """Refuse DAE reconstruction without embeddings: its target is the
    embedding table, which feature-only input (``USE_EMBED: false``) does
    not have.  The JAX package's trainers cannot train it either (its
    full-graph step indexes the empty target, its sampled trainer refuses
    it)."""
    if use_dae and not model_cfg.use_embed:
        raise NotImplementedError(
            "DAE reconstruction needs embedding targets (MODEL.USE_EMBED); "
            "feature-only input trains with MODEL.USE_DAE false and "
            "MODEL.NBLOCKS 1")


class _ByMask:
    """Static operands of a graph variant, built (and cached) on first
    use by ``build(mask)``, where ``mask`` is the variant's edge mask
    times the pad mask: the valid and test variants wait for the first
    evaluation, and identical masks share one build (transductively the
    valid graph is the train graph; inductively the three differ and
    nothing is shared).  A bit pack takes seconds of host time
    and about 2 GB of device memory at ML-10M scale; a bf16 dense
    adjacency 224 MB at ML-1M scale."""

    def __init__(self, pad, build):
        self._pad = pad
        self._build = build
        self._cache = {}           # mask-bytes digest -> operands
        self._by_variant = {}

    def get(self, variant, mask):
        if variant not in self._by_variant:
            m = np.ascontiguousarray(np.asarray(mask) * self._pad,
                                     np.float32)
            key = hashlib.sha1(m.tobytes()).hexdigest()
            if key not in self._cache:
                # Operands outlive the call that first asks for them, so
                # they are ordinary tensors even when that call runs under
                # ``torch.inference_mode()``.
                with torch.inference_mode(False):
                    self._cache[key] = self._build(m)
            self._by_variant[variant] = self._cache[key]
        return self._by_variant[variant]


class GraphVariants:
    """The static operands of the three graph variants of one rating
    graph, on ``device``: the padded edge arrays, and per variant
    (``'test'``, ``'valid'``, ``'train'``) its edge mask, degree vectors,
    and bit packs, chunked-ELL packs or dense adjacencies, each built on
    first use.
    ``Trainer`` and ``serve.ServingState`` read them from here."""

    def __init__(self, model_cfg, data_iter, device):
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.device = device
        it = data_iter
        self.all_csr = it.all_graph[it.name_user, it.name_item]
        self.graph_data = BipartiteGraphData.from_csr(self.all_csr, device)
        g = self.graph_data
        self._edges = tuple(t.cpu().numpy() for t in (
            g.edge_user, g.edge_item, g.edge_rating, g.edge_pad_mask))
        self._masks, self._degrees, self._device_masks = {}, {}, {}
        pad = self._edges[3]
        self._packs = _ByMask(pad, self._build_pack)
        self._ell_packs = _ByMask(pad, self._build_ell_pack)
        self._adjs = {dtype: _ByMask(pad, functools.partial(
            self._build_adj, dtype=dtype))
            for dtype in (torch.bfloat16, torch.float32)}

    def _build_pack(self, mask):
        cfg = self.model_cfg
        eu, ei, er, _ = self._edges
        # The pack layout follows the kernels the model resolves to: the
        # 16-bit route reads row-interleaved packs.
        ril = pack_row_interleave(resolve_impl(cfg.bit_impl))
        return build_bit_pack(eu, ei, er, mask, cfg.num_users, cfg.num_items,
                              cfg.num_links, self.device, row_interleave=ril)

    def _build_ell_pack(self, mask):
        cfg = self.model_cfg
        eu, ei, er, _ = self._edges
        return build_ell_pack(eu, ei, er, mask, cfg.num_users, cfg.num_items,
                              K=cfg.ell_k, device=self.device)

    def _build_adj(self, mask, dtype):
        g, cfg = self.graph_data, self.model_cfg
        # User orientation (dst = user); the item direction reads it
        # transposed.
        return build_dense_adjacency(
            g.edge_item, g.edge_user, g.edge_rating,
            torch.from_numpy(mask).to(self.device), cfg.num_links,
            cfg.num_users, cfg.num_items, dtype=dtype)

    def edge_mask(self, variant: str) -> np.ndarray:
        """Float mask over the padded edge arrays selecting the edges of
        the variant."""
        if variant not in self._masks:
            it = self.data_iter
            graph = {"test": it.test_graph, "valid": it.val_graph,
                     "train": it.train_graph}[variant]
            pairs = graph[it.name_user, it.name_item].node_pair_ids
            idx = self.all_csr.edge_indices_by_id(pairs)
            if not np.all(idx >= 0):
                raise ValueError(f"{variant} graph has an edge that the "
                                 "full graph lacks")
            m = np.zeros(self.graph_data.num_edges_padded, np.float32)
            m[idx] = 1.0
            self._masks[variant] = m
        return self._masks[variant]

    def degrees(self, variant: str):
        """``(deg_user, deg_item)`` float32 tensors of the variant."""
        if variant not in self._degrees:
            eu, ei, _, pad = self._edges
            mm = self.edge_mask(variant) * pad
            # Degrees are counts, exact in float32 however they are summed.
            du, di = (np.bincount(e, weights=mm, minlength=n).astype(
                np.float32) for e, n in ((eu, self.model_cfg.num_users),
                                         (ei, self.model_cfg.num_items)))
            with torch.inference_mode(False):
                self._degrees[variant] = (
                    torch.from_numpy(du).to(self.device),
                    torch.from_numpy(di).to(self.device))
        return self._degrees[variant]

    def bit_pack(self, variant: str):
        """The variant's bit packs on the device, built on first use."""
        return self._packs.get(variant, self.edge_mask(variant))

    def ell_pack(self, variant: str):
        """The variant's chunked-ELL packs on the device (both directions,
        ``ops.chunked_ell.build_ell_pack``), built on first use."""
        return self._ell_packs.get(variant, self.edge_mask(variant))

    def dense_adj(self, variant: str, dtype=torch.bfloat16):
        """The variant's ``(R, Nu, Ni)`` 0/1 adjacency on the device in
        ``dtype`` (bf16 or float32), built on first use."""
        return self._adjs[dtype].get(variant, self.edge_mask(variant))

    def device_mask(self, variant: str) -> torch.Tensor:
        """The variant's edge mask as a float32 tensor on the device."""
        if variant not in self._device_masks:
            with torch.inference_mode(False):
                self._device_masks[variant] = torch.from_numpy(
                    self.edge_mask(variant)).to(self.device)
        return self._device_masks[variant]

    def operands(self, variant: str, backend: str):
        """What ``STARGCN.forward`` aggregates through on ``backend``: the
        bit packs (``bitdense``), the chunked-ELL packs (``ell``), the bf16
        dense adjacency (``dense``) or the edge arrays under the variant's
        mask (``xla``)."""
        if backend == "bitdense":
            return self.bit_pack(variant)
        if backend == "ell":
            return self.ell_pack(variant)
        if backend == "dense":
            return self.dense_adj(variant)
        if backend == "xla":
            return EdgeSet(self.graph_data, self.device_mask(variant))
        raise ValueError(f"unknown backend: {backend!r}")


@dataclasses.dataclass
class TrainSettings:
    rating_batch_size: int = 10000
    recon_batch_size: int = 1_000_000
    max_iter: int = 1_000_000
    log_interval: int = 10
    valid_interval: int = 10
    lr: float = 1e-2
    wd: float = 0.0
    decay_patience: int = 100
    min_lr: float = 5e-4
    lr_decay_factor: float = 0.5
    early_stopping_patience: int = 150
    grad_clip: float = 10.0
    remove_rating: bool = True
    recon_lambda: float = 0.1
    use_dae: bool = True
    seed: int = 123
    # Steps taken per ``train_chunk`` call (must divide the log and valid
    # intervals to keep the logging cadence exact).
    scan_steps: int = 1
    max_nan_recoveries: int = 3
    device_sampler: bool = False
    # Failure detection (train/resilience.py): seconds without a step
    # before the heartbeat monitor dumps the stacks (0 = no monitor), and
    # the restarts a failed step gets.
    hang_timeout_s: float = 900.0
    max_restarts: int = 2

    @staticmethod
    def from_cfg(cfg):
        return TrainSettings(
            rating_batch_size=cfg.TRAIN.RATING_BATCH_SIZE,
            recon_batch_size=cfg.TRAIN.RECON_BATCH_SIZE,
            max_iter=cfg.TRAIN.MAX_ITER,
            log_interval=cfg.TRAIN.LOG_INTERVAL,
            valid_interval=cfg.TRAIN.VALID_INTERVAL,
            lr=cfg.TRAIN.LR, wd=cfg.TRAIN.WD,
            decay_patience=cfg.TRAIN.DECAY_PATIENCE,
            min_lr=cfg.TRAIN.MIN_LR,
            lr_decay_factor=cfg.TRAIN.LR_DECAY_FACTOR,
            early_stopping_patience=cfg.TRAIN.EARLY_STOPPING_PATIENCE,
            grad_clip=cfg.TRAIN.GRAD_CLIP,
            remove_rating=cfg.MODEL.REMOVE_RATING,
            recon_lambda=cfg.MODEL.RECON_LAMBDA,
            use_dae=cfg.MODEL.USE_DAE,
            seed=cfg.SEED,
            scan_steps=cfg.TRAIN.get("SCAN_STEPS", 1),
            max_nan_recoveries=cfg.TRAIN.get("MAX_NAN_RECOVERIES", 3),
            device_sampler=cfg.TRAIN.get("DEVICE_SAMPLER", False),
            hang_timeout_s=cfg.TRAIN.get("HANG_TIMEOUT_S", 900.0),
            max_restarts=cfg.TRAIN.get("MAX_RESTARTS", 2),
        )


class ClipAdam:
    """Global-norm clip + Adam (+ decoupled weight decay) with an
    adjustable learning rate: the chain ``clip_by_global_norm ->
    scale_by_adam -> add_decayed_weights -> scale(-lr)`` of the JAX
    package's ``make_optimizer``, written out.

    * clip: gradients unchanged if ``norm < max_norm``, else
      ``g / norm * max_norm`` (no epsilon on the norm);
    * Adam: b1 0.9, b2 0.999, bias-corrected moments,
      ``m_hat / (sqrt(v_hat) + 1e-8)``;
    * weight decay ``wd * p`` added to the Adam update when ``wd`` > 0;
    * ``p += -lr * update``.

    The moments are keyed by parameter name; ``lr`` may be changed between
    steps without touching them.

    ``step(grads, keep=...)`` takes a device bool: where it is false the
    step changes nothing (parameters, moments and the count of applied
    steps), as ``jnp.where(keep, new, old)`` does in the JAX package's
    device-planned step.  The count then lives on the device, so no step
    waits for the host; reading ``count`` fetches it.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, named_params, lr, grad_clip, wd=0.0):
        self.params = dict(named_params)
        self.lr = float(lr)
        self.grad_clip = float(grad_clip)
        self.wd = float(wd)
        self._count = 0
        self._count_dev = None     # float64 device scalar after a keep step
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @property
    def count(self):
        """Number of updates applied so far."""
        if self._count_dev is not None:
            self._count = int(self._count_dev.item())
            self._count_dev = None
        return self._count

    @torch.no_grad()
    def step(self, grads, keep=None):
        """Apply one update from ``grads`` (name -> tensor), or, where the
        device bool ``keep`` is false, none; returns the global gradient
        norm before clipping, as a device scalar."""
        gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                               for g in grads.values()))
        under = gnorm < self.grad_clip
        if keep is None:
            self._count = self.count + 1
            c1 = 1.0 - self.B1 ** self._count
            c2 = 1.0 - self.B2 ** self._count
        else:
            if self._count_dev is None:
                self._count_dev = torch.full((), float(self._count),
                                             dtype=torch.float64,
                                             device=gnorm.device)
            self._count_dev += keep
            c1 = 1.0 - self.B1 ** self._count_dev
            c2 = 1.0 - self.B2 ** self._count_dev
        for k, p in self.params.items():
            g = grads[k]
            g = torch.where(under, g, g / gnorm * self.grad_clip)
            if keep is None:
                mu = self.mu[k].mul_(self.B1).add_(g, alpha=1.0 - self.B1)
                nu = self.nu[k].mul_(self.B2).addcmul_(
                    g, g, value=1.0 - self.B2)
            else:
                mu = torch.mul(self.mu[k], self.B1).add_(
                    g, alpha=1.0 - self.B1)
                nu = torch.mul(self.nu[k], self.B2).addcmul_(
                    g, g, value=1.0 - self.B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            if self.wd:
                update = update + self.wd * p
            if keep is None:
                p.add_(update, alpha=-self.lr)
            else:
                new_p = torch.add(p, update, alpha=-self.lr)
                for old, new in ((self.mu[k], mu), (self.nu[k], nu),
                                 (p, new_p)):
                    old.copy_(torch.where(keep, new, old))
        return gnorm

    def state_dict(self):
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state):
        self._count = int(state["count"])
        self._count_dev = None
        for name in ("mu", "nu"):
            mine = getattr(self, name)
            if sorted(state[name]) != sorted(mine):
                raise ValueError("optimizer state does not fit the model")
            for k, v in state[name].items():
                mine[k].copy_(torch.as_tensor(v))


def make_optimizer(settings, named_params):
    """The trainer's optimiser over ``named_params`` (name -> parameter):
    global-norm clip + Adam (+ optional weight decay) with an adjustable
    learning rate."""
    s = settings
    return ClipAdam(named_params, lr=s.lr, grad_clip=s.grad_clip, wd=s.wd)


class _NullLogger:
    def log(self, **kw):
        pass

    def close(self):
        pass


def make_metric_loggers(save_dir, save_id, nblocks):
    """train/valid/test ``MetricLogger`` CSVs (``train_loss%d.csv``,
    ``valid_loss%d.csv``, ``test_loss%d.csv``); no-op loggers without a
    save_dir."""
    if save_dir is None:
        return {k: _NullLogger() for k in ("train", "valid", "test")}
    os.makedirs(save_dir, exist_ok=True)
    cols = ["iter", "loss"] + sum(
        [[f"rmse{i}", f"rating_loss{i}", f"recon_loss{i}"]
         for i in range(nblocks)], [])
    fmts = ["%d", "%.4f"] + ["%.4f"] * (3 * nblocks)
    rmse_cols = ["iter"] + [f"rmse{i}" for i in range(nblocks)]
    rmse_fmts = ["%d"] + ["%.4f"] * nblocks
    return {
        "train": MetricLogger(cols, fmts, os.path.join(
            save_dir, f"train_loss{save_id}.csv")),
        "valid": MetricLogger(rmse_cols, rmse_fmts, os.path.join(
            save_dir, f"valid_loss{save_id}.csv")),
        "test": MetricLogger(rmse_cols, rmse_fmts, os.path.join(
            save_dir, f"test_loss{save_id}.csv")),
    }


_STAT_NAMES = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


class Trainer:
    """Owns the model, its optimiser and the host-side schedule.

    Args:
      model_cfg: a ``STARGCNConfig`` on the ``bitdense``, ``ell``,
        ``dense`` or ``xla`` backend.
      data_iter: the ``DataIterator`` over the rating graph.
      settings: ``TrainSettings``.
      save_dir / save_id: where the CSVs and checkpoints go (none without
        a ``save_dir``).
      device: where the model and its operands live (default the card).
    """

    def __init__(self, model_cfg: STARGCNConfig, data_iter, settings,
                 save_dir: Optional[str] = None, save_id: int = 0,
                 device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the device mesh comes with the slice that ports "
                "parallel/mesh.py and parallel/shardings.py")
        check_feature_only_dae(model_cfg, settings.use_dae)
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.s = settings
        self.save_dir = save_dir
        self.save_id = save_id
        self.device = resolve_device(device)
        self.variants = GraphVariants(model_cfg, data_iter, self.device)
        self._features = graph_features(data_iter, model_cfg, self.device)
        self.graph_data = self.variants.graph_data
        all_csr = self.variants.all_csr

        train_ratings = data_iter.train_ratings
        self.rating_mean = float(train_ratings.mean())
        self.rating_std = float(train_ratings.std())
        vals = data_iter.possible_rating_values
        self.rating_min = float(vals.min())
        self.rating_max = float(vals.max())

        n_train = data_iter.train_node_pairs.shape[1]
        self.train_batch = min(self.s.rating_batch_size, n_train)
        # Batch edges are removed only when the batch is a strict subset
        # of the training edges.
        self.do_remove = self.s.remove_rating and self.train_batch < n_train
        self.train_batch_padded = self.train_batch

        # Host-side pair->edge lookup tables.
        keys = (all_csr.row_indices.astype(np.int64) * all_csr.shape[1]
                + all_csr.end_points)
        ratings = np.searchsorted(
            all_csr.multi_link, all_csr.values).astype(np.int32)
        order = np.argsort(keys, kind="stable")
        self._lookup_keys_np = keys[order]
        self._lookup_rating_np = ratings[order]
        # Dense direct-index map when the pair space is small enough
        # (746 MB at ML-10M): one fancy-indexed gather per step instead of
        # a binary search per pair.  Value = rating index + 1, 0 = no edge.
        self._lookup_dense_np = None
        pair_space = int(all_csr.shape[0]) * int(all_csr.shape[1])
        if 0 < pair_space <= 1_000_000_000 and len(all_csr.multi_link) < 127:
            dense = np.zeros(pair_space, np.int8)
            dense[keys] = (ratings + 1).astype(np.int8)
            self._lookup_dense_np = dense

        self.model = STARGCN(
            model_cfg,
            generator=torch.Generator().manual_seed(self.s.seed),
            feature_dims=feature_dims(data_iter))
        self.model.to(self.device)
        # Dropout masks: one stream, on the model's device.
        self._dropout_gen = torch.Generator(device=self.device)
        self._dropout_gen.manual_seed(self.s.seed)
        self.opt = make_optimizer(self.s, self.model.named_parameters())
        self.lr = self.s.lr
        noise = data_iter.evaluate_embed_noise_dict
        self._eval_noise = tuple(
            torch.from_numpy(noise[k]).to(self.device)
            for k in (data_iter.name_user, data_iter.name_item))
        # TRAIN.DEVICE_SAMPLER: the batch draws' stream, on the device, and
        # the recon sampler's selection and zeroing rates per type.
        self._sampler_gen = torch.Generator(device=self.device)
        self._sampler_gen.manual_seed(self.s.seed)
        self._dev_train_arrays = None
        names = (data_iter.name_user, data_iter.name_item)
        self._dev_pmask = tuple(
            float(data_iter.embed_P_mask.get(k, 0.0)) for k in names)
        self._dev_pzero = tuple(
            float(data_iter._embed_p_zero.get(k, 0.0)) for k in names)
        self.elastic = None        # the last fit's ElasticStep

    def set_lr(self, lr: float):
        """Change the learning rate; the Adam moments stay."""
        self.lr = lr
        self.opt.lr = float(lr)

    def features(self):
        """``(user, item)`` raw feature tensors on the device, or ``(None,
        None)`` without ``USE_FEA_PROJ``."""
        return self._features

    def _forward(self, *args, **kw):
        """The model's forward with the trainer's features."""
        fu, fi = self._features
        return self.model(*args, user_features=fu, item_features=fi, **kw)

    def _operands(self, variant: str):
        """The model's aggregation operands of a graph variant."""
        return self.variants.operands(variant, self.model_cfg.backend)

    def seed_dropout(self, seed: int):
        """Restart the dropout stream from ``seed``."""
        self._dropout_gen.manual_seed(seed)

    # --------------------------- public driving ------------------------------

    def host_edge_lookup(self, pu, pi, valid):
        """(hit, rating) for batch pairs — numpy, off the device path."""
        q = pu.astype(np.int64) * self.model_cfg.num_items + pi
        if self._lookup_dense_np is not None:
            v = self._lookup_dense_np[q].astype(np.int32)
            hit = ((v > 0) & (valid > 0)).astype(np.float32)
            return hit, np.maximum(v - 1, 0)
        pos = np.searchsorted(self._lookup_keys_np, q)
        pos = np.clip(pos, 0, max(self._lookup_keys_np.size - 1, 0))
        hit = ((self._lookup_keys_np[pos] == q) & (valid > 0)).astype(
            np.float32)
        rating = self._lookup_rating_np[pos]
        return hit, rating

    def _prep_host_arrays(self, rating_batch, recon_batch):
        """Bundle one step's inputs into 4 host arrays: ``ints`` (pairs and
        removed-edge rating), ``flts`` (ratings, validity, removal hit),
        the two noise arrays joined, the two recon masks joined."""
        (pairs, gt_ratings) = rating_batch
        noise_u, noise_i, recon_mask_u, recon_mask_i = recon_batch
        B = self.train_batch_padded
        n = gt_ratings.size
        ints = np.zeros((3, B), np.int32)
        flts = np.zeros((3, B), np.float32)
        ints[0, :n], ints[1, :n] = pairs[0], pairs[1]
        flts[0, :n], flts[1, :n] = gt_ratings, 1.0
        hit, rating = self.host_edge_lookup(ints[0], ints[1], flts[1])
        ints[2], flts[2] = rating, hit
        noise = np.concatenate([noise_u, noise_i]).astype(np.int32)
        rmask = np.concatenate([recon_mask_u, recon_mask_i]).astype(
            np.float32)
        return ints, flts, noise, rmask

    def _to_device(self, arrays):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _step(self, ints, flts, noise, rmask):
        """One optimisation step on step inputs on the device."""
        stats, grads = self._loss_and_grads(ints, flts, noise, rmask)
        stats["gnorm"] = self.opt.step(grads)
        return stats

    def train_iteration(self, rating_batch, recon_batch):
        """One optimisation step.  Returns a dict of device-side stats
        (``loss``, ``gnorm`` scalars; ``rating_loss``, ``recon_loss``,
        ``sq_err`` per block)."""
        return self._step(*self._to_device(
            self._prep_host_arrays(rating_batch, recon_batch)))

    def train_chunk(self, rating_batches, recon_batches):
        """k optimisation steps in one call: a loop of ``train_iteration``
        with the same dropout stream as k single calls.  Returns stats
        stacked along a leading k axis."""
        return self._train_prepped(
            [self._prep_host_arrays(rb, cb)
             for rb, cb in zip(rating_batches, recon_batches)])

    def _train_prepped(self, prepped):
        """``train_chunk`` over ``_prep_host_arrays`` outputs."""
        return _stack_stats([self._step(*self._to_device(a))
                             for a in prepped])

    # ---------------------- TRAIN.DEVICE_SAMPLER ----------------------

    def draw_device_batch(self):
        """One step's draws for ``train_step_dev``, from the trainer's
        sampler stream on the device: ``idx`` (the batch's train-edge
        indices, drawn with replacement) and, with ``use_dae``, per type
        the Bernoulli(P_mask) recon selection ``sel_*`` and the
        Bernoulli(p_zero) zeroing ``zero_*``."""
        g, dev = self._sampler_gen, self.device
        n_train = self.data_iter.train_node_pairs.shape[1]
        draws = {"idx": torch.randint(0, n_train, (self.train_batch_padded,),
                                      generator=g, device=dev)}
        if self.s.use_dae:
            for t, n, pm, pz in (
                    ("user", self.model_cfg.num_users, self._dev_pmask[0],
                     self._dev_pzero[0]),
                    ("item", self.model_cfg.num_items, self._dev_pmask[1],
                     self._dev_pzero[1])):
                draws[f"sel_{t}"] = torch.rand(n, generator=g,
                                               device=dev) < pm
                draws[f"zero_{t}"] = torch.rand(n, generator=g,
                                                device=dev) < pz
        return draws

    def device_train_arrays(self):
        """The train edges, their ratings and rating indices on the device
        (copied once, on first use)."""
        if self._dev_train_arrays is None:
            it = self.data_iter
            ratings = np.asarray(it.train_ratings)
            self._dev_train_arrays = self._to_device((
                np.asarray(it.train_node_pairs, np.int64),
                ratings.astype(np.float32),
                np.searchsorted(np.asarray(it.possible_rating_values),
                                ratings).astype(np.int64)))
        return self._dev_train_arrays

    def train_step_dev(self, draws):
        """One optimisation step on a batch drawn on the device
        (``draw_device_batch``): the same step as ``train_iteration``."""
        return self._step(*_device_sample_step_inputs(
            self, *self.device_train_arrays(), draws))

    def train_chunk_dev(self, k):
        """k optimisation steps with batches drawn on the device
        (TRAIN.DEVICE_SAMPLER): no host array is made or copied.  Returns
        stats stacked along a leading k axis."""
        return _stack_stats([self.train_step_dev(self.draw_device_batch())
                             for _ in range(k)])

    def prepare_recon_batch(self, embed_noise_dict, recon_ids_dict):
        """Noise arrays + float recon masks from the sampler output."""
        it = self.data_iter
        nu = embed_noise_dict[it.name_user]
        ni = embed_noise_dict[it.name_item]
        mu = np.zeros(self.model_cfg.num_users, np.float32)
        mi = np.zeros(self.model_cfg.num_items, np.float32)
        if it.name_user in recon_ids_dict:
            mu[recon_ids_dict[it.name_user]] = 1.0
        if it.name_item in recon_ids_dict:
            mi[recon_ids_dict[it.name_item]] = 1.0
        return nu, ni, mu, mi

    def loss_and_grads(self, rating_batch, recon_batch):
        """The training forward and backward of one batch, without the
        update: ``(stats, grads)`` with the device-side stats of
        ``train_iteration`` but ``gnorm``, and the gradient of ``loss``
        for every parameter, by name.  One draw from the dropout
        stream."""
        return self._loss_and_grads(*self._to_device(
            self._prep_host_arrays(rating_batch, recon_batch)))

    def _loss_and_grads(self, ints, flts, noise, rmask):
        """``loss_and_grads`` on the step inputs of ``_prep_host_arrays``
        as device tensors, host-fed or drawn on the device."""
        ints = ints.long()
        cfg, s = self.model_cfg, self.s
        mean, std = self.rating_mean, self.rating_std
        pairs_u, pairs_i, rem_rating = ints[0], ints[1], ints[2]
        gt_ratings, pairs_valid, rem_hit = flts[0], flts[1], flts[2]
        noise_u, noise_i = noise[:cfg.num_users], noise[cfg.num_users:]
        recon_masks = {"user": rmask[:cfg.num_users],
                       "item": rmask[cfg.num_users:]}
        removed_pairs = ((pairs_u, pairs_i, rem_hit, rem_rating)
                         if self.do_remove else None)
        operands = self._operands("train")
        if removed_pairs is not None and isinstance(operands, EdgeSet):
            # xla: the batch's edges leave the step's edge mask.
            operands = EdgeSet(operands.graph,
                               operands.graph.edge_mask_from_pairs(
                                   pairs_u, pairs_i, rem_hit, operands.mask))
        n_valid = pairs_valid.sum().clamp_min(1.0)

        out = self._forward(
            noise_u, noise_i, pairs_u, pairs_i,
            self.variants.degrees("train"), operands, removed_pairs,
            train=True, generator=self._dropout_gen)
        target = (gt_ratings - mean) / std
        # 0.5 * mean squared error per block; padded batch slots carry
        # zero weight.
        sq = (out["pred_ratings"] - target[None, :]) ** 2
        rating_loss = 0.5 * (sq * pairs_valid[None, :]).sum(dim=1) / n_valid
        loss = rating_loss.sum()
        recon_loss = torch.zeros(cfg.nblocks, device=self.device)
        if s.use_dae:
            rls = []
            for blk in out["pred_embed"]:
                block_loss = 0.0
                for key, m in recon_masks.items():
                    sq = ((blk[key] - out["gt_embed"][key]) ** 2).sum(dim=-1)
                    block_loss = block_loss + (sq * m).sum() \
                        / m.sum().clamp_min(1.0)
                rls.append(block_loss)
            recon_loss = torch.stack(rls)
            loss = loss + s.recon_lambda * recon_loss.sum()

        names, params = zip(*self.model.named_parameters())
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for k, p, g in zip(names, params, torch.autograd.grad(
                     loss, params, allow_unused=True))}
        with torch.no_grad():
            denorm = out["pred_ratings"] * std + mean
            sq_err = ((denorm - gt_ratings[None, :]) ** 2
                      * pairs_valid[None, :]).sum(dim=1)
        return {"loss": loss.detach(), "rating_loss": rating_loss.detach(),
                "recon_loss": recon_loss.detach(), "sq_err": sq_err}, grads

    def _eval_forward(self, segment, pu, pi):
        """Eval-mode ``pred_ratings`` ``(nblocks, B)``, denormalised and
        clipped to the rating range, on the segment's graph variant with
        the evaluation noise (unseen nodes -> zero embedding)."""
        seg_key = "valid" if segment == "valid" else "test"
        noise_u, noise_i = self._eval_noise
        out = self._forward(noise_u, noise_i, pu, pi,
                            self.variants.degrees(seg_key),
                            self._operands(seg_key), train=False)
        denorm = out["pred_ratings"] * self.rating_std + self.rating_mean
        return denorm.clamp(self.rating_min, self.rating_max)

    @torch.no_grad()
    def evaluate(self, segment: str = "valid"):
        """Per-block RMSE on the given segment: predictions are
        denormalised and clipped to the rating range."""
        it = self.data_iter
        n_seg = (it.valid_node_pairs if segment == "valid"
                 else it.test_node_pairs).shape[1]
        B = min(self.s.rating_batch_size, max(1, n_seg))
        sq_sum = torch.zeros(self.model_cfg.nblocks, dtype=torch.float64,
                             device=self.device)
        cnt = 0
        for pairs, ratings in it.rating_sampler(batch_size=B,
                                                segment=segment,
                                                sequential=True):
            n = ratings.size
            pu = torch.from_numpy(pairs[0].astype(np.int64)).to(self.device)
            pi = torch.from_numpy(pairs[1].astype(np.int64)).to(self.device)
            gt = torch.from_numpy(ratings.astype(np.float32)).to(self.device)
            clipped = self._eval_forward(segment, pu, pi)
            sq_sum += ((clipped - gt[None, :]) ** 2).sum(dim=1)
            cnt += n
        return np.sqrt(sq_sum.cpu().numpy() / max(cnt, 1))

    @torch.no_grad()
    def predict(self, pairs_user, pairs_item, segment: str = "test"):
        """Denormalised, range-clipped rating predictions (last block)
        for arbitrary (user, item) pairs, on the given graph variant with
        the evaluation noise masking."""
        pairs_user = np.asarray(pairs_user, np.int64)
        pairs_item = np.asarray(pairs_item, np.int64)
        n = pairs_user.size
        B = min(self.s.rating_batch_size, max(1, n))
        out = np.zeros(n, np.float32)
        for start in range(0, n, B):
            end = min(start + B, n)
            pu = torch.from_numpy(pairs_user[start:end]).to(self.device)
            pi = torch.from_numpy(pairs_item[start:end]).to(self.device)
            out[start:end] = self._eval_forward(segment, pu, pi)[-1] \
                .cpu().numpy()
        return out

    # ------------------------------- fit ------------------------------------

    def fit(self, max_iter: Optional[int] = None, log=logging.info):
        """The full training schedule: steps, a train log line every
        ``log_interval``, validation every ``valid_interval`` with a test
        evaluation and checkpoints on improvement, LR decay after
        ``decay_patience`` validations without one, early stopping at
        ``min_lr``, and recovery from a non-finite loss.

        With ``TRAIN.DEVICE_SAMPLER`` the batches are drawn on the device
        (``train_chunk_dev``).  Otherwise, with ``SCAN_STEPS`` > 1, a
        producer thread draws each chunk's batches and runs their host
        pair lookup (``_prep_host_arrays``) one to two chunks ahead of the
        step; it stops when ``fit`` returns or raises.

        Failure handling (``train/resilience.py``): every step call goes
        through an ``ElasticStep`` (``self.elastic``), which retries a step
        that raised after restoring ``ckpt_last`` (else ``ckpt_best``), at
        most ``TRAIN.MAX_RESTARTS`` times; with ``TRAIN.HANG_TIMEOUT_S`` >
        0 a ``HeartbeatMonitor`` thread dumps every thread's stack to the
        log and to ``crash_{save_id}.log`` when no step ends for that long.
        With a ``save_dir`` the parameter table goes to
        ``net{save_id}.txt``."""
        s = self.s
        it = self.data_iter
        max_iter = max_iter or s.max_iter
        rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                           segment="train")
        recon_sampler = (it.recon_nodes_sampler(
            batch_size=s.recon_batch_size) if s.use_dae else None)
        if self.save_dir is not None:
            # net%d.txt architecture dump (reference gluon_net_info).
            model_info(self.model.state_dict(), os.path.join(
                self.save_dir, f"net{self.save_id}.txt"))
        loggers = make_metric_loggers(self.save_dir, self.save_id,
                                      self.model_cfg.nblocks)
        nb = self.model_cfg.nblocks
        # Stall diagnosis and bounded restart of failed steps.
        monitor = None
        if s.hang_timeout_s and s.hang_timeout_s > 0:
            crash_file = (os.path.join(self.save_dir,
                                       f"crash_{self.save_id}.log")
                          if self.save_dir else None)
            monitor = HeartbeatMonitor(s.hang_timeout_s, log=log,
                                       crash_file=crash_file,
                                       device=self.device).start()
        self.elastic = ElasticStep(
            ElasticPolicy(max_restarts=s.max_restarts),
            on_restore=self._elastic_restore, log=log, device=self.device)
        # Steps per train_chunk call, when the cadence allows.
        k = s.scan_steps if (s.scan_steps > 1
                             and s.log_interval % s.scan_steps == 0
                             and s.valid_interval % s.scan_steps == 0
                             and max_iter >= s.scan_steps) else 1

        def next_batches():
            rb = next(rating_sampler)
            if s.use_dae:
                noise_dict, _, all_recon_ids = next(recon_sampler)
                cb = self.prepare_recon_batch(noise_dict, all_recon_ids)
            else:
                cb = (np.arange(self.model_cfg.num_users, dtype=np.int32),
                      np.arange(self.model_cfg.num_items, dtype=np.int32),
                      np.zeros(self.model_cfg.num_users, np.float32),
                      np.zeros(self.model_cfg.num_items, np.float32))
            return rb, cb

        def next_chunk():
            """k batches' host step inputs and pair counts."""
            chunk = [next_batches() for _ in range(k)]
            return ([self._prep_host_arrays(rb, cb) for rb, cb in chunk],
                    sum(rb[1].size for rb, _ in chunk))

        use_dev = s.device_sampler
        try:
            with contextlib.ExitStack() as stack:
                if k > 1 and not use_dev:
                    next_chunk = stack.enter_context(
                        Prefetcher(next_chunk, max_iter // k)).get
                result = self._fit_loop(
                    max_iter, k, use_dev, next_batches, next_chunk, loggers,
                    log, monitor)
        finally:
            if monitor is not None:
                monitor.stop()
        for lg in loggers.values():
            lg.close()
        self.save_checkpoint("last")
        best_iter, best_valid_rmse, best_test_rmse = result
        log(f"Best Iter={best_iter}, Best Valid RMSE={best_valid_rmse:.4f}, "
            + (", ".join(f"Best Test RMSE{i}={best_test_rmse[i]:.4f}"
                         for i in range(nb))
               if best_test_rmse is not None else "no test eval"))
        return {"best_iter": best_iter,
                "best_valid_rmse": float(best_valid_rmse),
                "best_test_rmse": (None if best_test_rmse is None
                                   else [float(x) for x in best_test_rmse])}

    def _fit_loop(self, max_iter, k, use_dev, next_batches, next_chunk,
                  loggers, log, monitor):
        """``fit``'s steps (each call through ``self.elastic``, a beat of
        ``monitor`` after each), logging, validation and schedule; returns
        ``(best_iter, best_valid_rmse, best_test_rmse)``."""
        s = self.s
        nb = self.model_cfg.nblocks
        nan_recoveries = 0
        best_valid_rmse = np.inf
        best_test_rmse = None
        best_iter = -1
        no_better = 0
        t_start = time.time()
        stop = False
        # Stats stay on the device between log intervals: one fetch per
        # interval instead of one per step.  Each entry is one call's
        # stats flattened in _STAT_NAMES order, one row per step.
        pending = []
        pending_cnt = 0
        iter_idx = 0
        # With chunking, max_iter rounds down to a multiple of k.
        effective_max = (max_iter // k) * k if k > 1 else max_iter
        while iter_idx < effective_max:
            if use_dev:
                stats = self.elastic.run(self.train_chunk_dev, k)
                pending_cnt += self.train_batch_padded * k
            elif k > 1:
                prepped, n_pairs = next_chunk()
                stats = self.elastic.run(self._train_prepped, prepped)
                pending_cnt += n_pairs
            else:
                rb, cb = next_batches()
                stats = _stack_stats([self.elastic.run(self.train_iteration,
                                                       rb, cb)])
                pending_cnt += rb[1].size
            if monitor is not None:
                monitor.beat()
            pending.append(torch.cat(
                [stats[name].reshape(k, -1) for name in _STAT_NAMES], 1))
            iter_idx += k

            logging_str = ""
            if iter_idx % s.log_interval == 0:
                fetched = torch.cat(pending).double().cpu().numpy()
                n_steps = fetched.shape[0]
                last_loss = float(fetched[-1, 0])
                gnorm_sum = fetched[:, 1].sum()
                rl_sum = fetched[:, 2:2 + nb].sum(axis=0)
                cl_sum = fetched[:, 2 + nb:2 + 2 * nb].sum(axis=0)
                sq_sum = fetched[:, 2 + 2 * nb:2 + 3 * nb].sum(axis=0)
                cnt = pending_cnt
                pending, pending_cnt = [], 0
                if not np.isfinite(last_loss):
                    # NaN watchdog: restore the best checkpoint if any,
                    # halve the LR, keep going — bounded: repeated
                    # divergence means the config is broken, not the run.
                    nan_recoveries += 1
                    if nan_recoveries > s.max_nan_recoveries:
                        log(f"Non-finite loss at iter {iter_idx}; "
                            f"{nan_recoveries - 1} recoveries already "
                            "spent — stopping.")
                        stop = True
                        break
                    log(f"Non-finite loss at iter {iter_idx}; "
                        "restoring best checkpoint and halving LR "
                        f"(recovery {nan_recoveries}/"
                        f"{s.max_nan_recoveries}).")
                    ckpt = self._checkpoint_path("best")
                    if ckpt and os.path.exists(ckpt):
                        self.restore_checkpoint(ckpt)
                    self.set_lr(max(self.lr * 0.5, s.min_lr))
                    continue
                rmse = np.sqrt(sq_sum / max(cnt, 1))
                row = {"iter": iter_idx, "loss": last_loss}
                for i in range(nb):
                    row[f"rmse{i}"] = rmse[i]
                    row[f"rating_loss{i}"] = rl_sum[i] / n_steps
                    row[f"recon_loss{i}"] = cl_sum[i] / n_steps
                loggers["train"].log(**row)
                dt = time.time() - t_start
                edges_per_step = (nb * len(self.model_cfg.agg_units) * 2
                                  * int(self.graph_data.num_edges_padded))
                logging_str = (
                    f"Iter={iter_idx}, gnorm={gnorm_sum / n_steps:.3f}, "
                    f"loss={last_loss:.3f}, "
                    + ", ".join(f"RMSE{i}={rmse[i]:.3f}" for i in range(nb))
                    + f", {cnt / dt:.0f} pairs/s"
                    + f", {n_steps * edges_per_step / dt / 1e6:.1f} "
                      "M edges/s")
                t_start = time.time()

            if iter_idx % s.valid_interval == 0:
                valid_rmse = self.evaluate("valid")
                loggers["valid"].log(**{"iter": iter_idx, **{
                    f"rmse{i}": valid_rmse[i] for i in range(nb)}})
                logging_str += ", " + ", ".join(
                    f"Val RMSE{i}={valid_rmse[i]:.3f}" for i in range(nb))
                if valid_rmse[-1] < best_valid_rmse:
                    best_valid_rmse = valid_rmse[-1]
                    no_better = 0
                    best_iter = iter_idx
                    best_test_rmse = self.evaluate("test")
                    loggers["test"].log(**{"iter": iter_idx, **{
                        f"rmse{i}": best_test_rmse[i] for i in range(nb)}})
                    logging_str += ", " + ", ".join(
                        f"Test RMSE{i}={best_test_rmse[i]:.4f}"
                        for i in range(nb))
                    self.save_checkpoint("best")
                    # Crash-safe resume point alongside best.
                    self.save_checkpoint("last")
                else:
                    no_better += 1
                    if (no_better > s.early_stopping_patience
                            and self.lr <= s.min_lr):
                        log("Early stopping threshold reached.")
                        stop = True
                    elif no_better > s.decay_patience:
                        new_lr = max(self.lr * s.lr_decay_factor, s.min_lr)
                        if new_lr < self.lr:
                            log(f"\tChange the LR to {new_lr:g}")
                            self.set_lr(new_lr)
                            no_better = 0
            if logging_str:
                log(logging_str)
            if stop:
                break
        return best_iter, best_valid_rmse, best_test_rmse

    # ---------------------------- checkpointing ------------------------------

    def _elastic_restore(self):
        """Reload the most recent checkpoint on disk after a failed step
        (``ElasticStep``'s ``on_restore``): ``ckpt_last``, else
        ``ckpt_best``; without a ``save_dir``, or before the first
        checkpoint, the parameters in memory go on as they are."""
        if self.save_dir is None:
            return
        for tag in ("last", "best"):
            path = self._checkpoint_path(tag)
            if os.path.exists(path):
                self.restore_checkpoint(path)
                return

    def _checkpoint_path(self, tag):
        if self.save_dir is None:
            return None
        return os.path.join(self.save_dir, f"ckpt_{tag}_{self.save_id}.pt")

    def save_checkpoint(self, tag: str = "last"):
        """Persist parameters + optimiser state + the learning rate."""
        path = self._checkpoint_path(tag)
        if path is None:
            return None
        from stargcn_tpu_torch.train.checkpoint import save_checkpoint
        os.makedirs(self.save_dir, exist_ok=True)
        save_checkpoint(path, self.model.state_dict(),
                        self.opt.state_dict(), {"lr": self.lr})
        return path

    def restore_checkpoint(self, path: str):
        from stargcn_tpu_torch.train.checkpoint import restore_checkpoint
        params, opt_state, extra = restore_checkpoint(
            path, self.model.state_dict(), self.opt.state_dict())
        self.model.load_state_dict(params)
        self.opt.load_state_dict(opt_state)
        if "lr" in extra:
            self.set_lr(float(extra["lr"]))


def _stack_stats(steps):
    """Per-step stats dicts stacked along a leading axis."""
    return {k: torch.stack([st[k] for st in steps]) for k in _STAT_NAMES}


def _device_sample_step_inputs(trainer, tp, tr, tri, draws):
    """One step's ``(ints, flts, noise, rmask)``, the layout of
    ``_prep_host_arrays``, made on the device from ``draws``
    (``Trainer.draw_device_batch``) over the train edges ``tp`` (2, n),
    their ratings ``tr`` and rating indices ``tri``: the step inputs of
    TRAIN.DEVICE_SAMPLER (JAX ``stargcn_tpu/train/loop.py:1077-1129``).

    Two deltas from the host samplers, both the JAX package's: the batch
    is drawn WITH replacement (the host slices one permutation per epoch),
    and each node is a recon target with probability P_mask on its own
    (the host draws an exact count).  A drawn pair is a train edge, so the
    REMOVE_RATING lookup is free: ``hit`` = 1 and the rating index is the
    drawn edge's."""
    idx = draws["idx"]
    B = idx.shape[0]
    dev = idx.device
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    hit = ones if trainer.do_remove else torch.zeros_like(ones)
    ints = torch.stack([tp[0].index_select(0, idx),
                        tp[1].index_select(0, idx), tri.index_select(0, idx)])
    flts = torch.stack([tr.index_select(0, idx), ones, hit])

    def one_type(t, n):
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        if not trainer.s.use_dae:
            return iota, torch.zeros(n, dtype=torch.float32, device=dev)
        sel = draws[f"sel_{t}"]
        noise = torch.where(sel & draws[f"zero_{t}"], -1, iota)
        return noise, sel.to(torch.float32)

    cfg = trainer.model_cfg
    nu, mu = one_type("user", cfg.num_users)
    ni, mi = one_type("item", cfg.num_items)
    return ints, flts, torch.cat([nu, ni]), torch.cat([mu, mi])
