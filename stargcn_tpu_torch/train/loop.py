"""Full-graph training/evaluation engine for STAR-GCN (PyTorch).

The port of ``stargcn_tpu/train/loop.py`` on the ``bitdense`` backend:

* graph variants (train/valid/test) are edge masks over one static edge
  array; their degrees and bit packs are built once (``GraphVariants``),
  packs on first use and shared between variants with identical masks;
* per-iteration batch-edge removal (``REMOVE_RATING``) is a host lookup of
  the batch pairs plus a batch-sized correction inside the model;
* loss = sum over blocks of 0.5 * mean (pred - (r - mean) / std)^2 +
  RECON_LAMBDA * sum over blocks/types of mean-over-masked-nodes
  ||e_hat - e||^2;
* gradient global-norm clipping, Adam, and the patience-driven LR decay
  to MIN_LR with early stopping.

A step is eager PyTorch: forward, ``backward`` (through
``ops.bitdense.bit_pool_rated``, whose backward is the
``bit_reduce_matmul`` kernel on the card), clip, Adam.  ``index_add_`` and
the gradient of a row gather use atomics on the card, so a step is not
bit-reproducible from run to run there, although both bit kernels are.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from stargcn_tpu_torch.graph.device import BipartiteGraphData
from stargcn_tpu_torch.models.stargcn import STARGCN, STARGCNConfig
from stargcn_tpu_torch.ops.bitdense import build_bit_pack
from stargcn_tpu_torch.utils.device import resolve_device
from stargcn_tpu_torch.utils.logging import MetricLogger


class _LazyBitPacks:
    """Per-variant bit-packed dense adjacencies (``ops/bitdense.py``),
    built (and cached) on first use: a pack takes seconds of host time and
    about 2 GB of device memory at ML-10M scale, so the valid/test
    variants wait for the first evaluation, and identical masks share one
    pack (transductively the valid graph is the train graph)."""

    def __init__(self, edges, model_cfg, device):
        self._edges = edges        # numpy (user, item, rating, pad mask)
        self._cfg = model_cfg
        self._device = device
        self._cache = {}           # mask-bytes digest -> pack
        self._by_variant = {}

    def get(self, variant, mask):
        if variant not in self._by_variant:
            eu, ei, er, pad = self._edges
            m = np.ascontiguousarray(np.asarray(mask) * pad, np.float32)
            key = hashlib.sha1(m.tobytes()).hexdigest()
            if key not in self._cache:
                cfg = self._cfg
                # Packs outlive the call that first asks for them, so they
                # are ordinary tensors even when that call runs under
                # ``torch.inference_mode()``.
                with torch.inference_mode(False):
                    self._cache[key] = build_bit_pack(
                        eu, ei, er, m, cfg.num_users, cfg.num_items,
                        cfg.num_links, self._device)
            self._by_variant[variant] = self._cache[key]
        return self._by_variant[variant]


class GraphVariants:
    """The static operands of the three graph variants of one rating
    graph, on ``device``: the padded edge arrays, and per variant
    (``'test'``, ``'valid'``, ``'train'``) its edge mask, degree vectors
    and bit packs.  ``Trainer`` and ``serve.ServingState`` read them from
    here."""

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
        self._masks, self._degrees = {}, {}
        self._packs = _LazyBitPacks(self._edges, model_cfg, device)

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
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, named_params, lr, grad_clip, wd=0.0):
        self.params = dict(named_params)
        self.lr = float(lr)
        self.grad_clip = float(grad_clip)
        self.wd = float(wd)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (name -> tensor); returns the
        global gradient norm before clipping, as a device scalar."""
        gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                               for g in grads.values()))
        under = gnorm < self.grad_clip
        self.count += 1
        c1 = 1.0 - self.B1 ** self.count
        c2 = 1.0 - self.B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            g = torch.where(under, g, g / gnorm * self.grad_clip)
            mu = self.mu[k].mul_(self.B1).add_(g, alpha=1.0 - self.B1)
            nu = self.nu[k].mul_(self.B2).addcmul_(g, g,
                                                   value=1.0 - self.B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            if self.wd:
                update = update + self.wd * p
            p.add_(update, alpha=-self.lr)
        return gnorm

    def state_dict(self):
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
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
      model_cfg: a ``STARGCNConfig`` on the ``bitdense`` backend.
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
        if settings.device_sampler:
            raise NotImplementedError(
                "TRAIN.DEVICE_SAMPLER (train_chunk_dev) comes with the "
                "slice that moves batch sampling onto the card")
        if data_iter.is_inductive:
            raise NotImplementedError(
                "inductive splits come with the port of data/movielens.py")
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.s = settings
        self.save_dir = save_dir
        self.save_id = save_id
        self.device = resolve_device(device)
        self.variants = GraphVariants(model_cfg, data_iter, self.device)
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
            generator=torch.Generator().manual_seed(self.s.seed))
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

    def set_lr(self, lr: float):
        """Change the learning rate; the Adam moments stay."""
        self.lr = lr
        self.opt.lr = float(lr)

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

    def train_iteration(self, rating_batch, recon_batch):
        """One optimisation step.  Returns a dict of device-side stats
        (``loss``, ``gnorm`` scalars; ``rating_loss``, ``recon_loss``,
        ``sq_err`` per block)."""
        stats, grads = self.loss_and_grads(rating_batch, recon_batch)
        stats["gnorm"] = self.opt.step(grads)
        return stats

    def train_chunk(self, rating_batches, recon_batches):
        """k optimisation steps in one call: a loop of ``train_iteration``
        with the same dropout stream as k single calls.  Returns stats
        stacked along a leading k axis."""
        steps = [self.train_iteration(rb, cb)
                 for rb, cb in zip(rating_batches, recon_batches)]
        return {k: torch.stack([st[k] for st in steps])
                for k in _STAT_NAMES}

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
        ints, flts, noise, rmask = (
            torch.from_numpy(a).to(self.device)
            for a in self._prep_host_arrays(rating_batch, recon_batch))
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
        n_valid = pairs_valid.sum().clamp_min(1.0)

        out = self.model(
            noise_u, noise_i, pairs_u, pairs_i,
            self.variants.degrees("train"), self.variants.bit_pack("train"),
            removed_pairs, train=True, generator=self._dropout_gen)
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
        out = self.model(noise_u, noise_i, pu, pi,
                         self.variants.degrees(seg_key),
                         self.variants.bit_pack(seg_key), train=False)
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
        ``min_lr``, and recovery from a non-finite loss."""
        s = self.s
        it = self.data_iter
        max_iter = max_iter or s.max_iter
        rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                           segment="train")
        recon_sampler = (it.recon_nodes_sampler(
            batch_size=s.recon_batch_size) if s.use_dae else None)
        loggers = make_metric_loggers(self.save_dir, self.save_id,
                                      self.model_cfg.nblocks)
        nan_recoveries = 0
        best_valid_rmse = np.inf
        best_test_rmse = None
        best_iter = -1
        no_better = 0
        nb = self.model_cfg.nblocks
        t_start = time.time()
        stop = False
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

        # Stats stay on the device between log intervals: one fetch per
        # interval instead of one per step.  Each entry is one step's
        # stats flattened in _STAT_NAMES order.
        pending = []
        pending_cnt = 0
        iter_idx = 0
        # With chunking, max_iter rounds down to a multiple of k.
        effective_max = (max_iter // k) * k if k > 1 else max_iter
        while iter_idx < effective_max:
            if k > 1:
                pulls = [next_batches() for _ in range(k)]
                stats = self.train_chunk([p[0] for p in pulls],
                                         [p[1] for p in pulls])
                pending.append(torch.cat(
                    [stats[name].reshape(k, -1) for name in _STAT_NAMES], 1))
                pending_cnt += sum(p[0][1].size for p in pulls)
            else:
                rb, cb = next_batches()
                stats = self.train_iteration(rb, cb)
                pending.append(torch.cat(
                    [stats[name].reshape(1, -1) for name in _STAT_NAMES], 1))
                pending_cnt += rb[1].size
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
        for lg in loggers.values():
            lg.close()
        self.save_checkpoint("last")
        log(f"Best Iter={best_iter}, Best Valid RMSE={best_valid_rmse:.4f}, "
            + (", ".join(f"Best Test RMSE{i}={best_test_rmse[i]:.4f}"
                         for i in range(nb))
               if best_test_rmse is not None else "no test eval"))
        return {"best_iter": best_iter,
                "best_valid_rmse": float(best_valid_rmse),
                "best_test_rmse": (None if best_test_rmse is None
                                   else [float(x) for x in best_test_rmse])}

    # ---------------------------- checkpointing ------------------------------

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
