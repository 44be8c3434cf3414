"""Serving: precomputed-embedding rating prediction + top-K recommendation.

The port of ``stargcn_tpu/serve.py``.  The rating head of the last block
is ``rating(u, i) = <user_proj(enc_u), item_proj(enc_i)>`` with a
parameter-free inner product, so the pair

    U = user_proj(enc(user states))   (Nu, mid)
    I = item_proj(enc(item states))   (Ni, mid)

is a complete scoring artifact: the encoder runs once at export, and a
query is one dot product (``predict``) or one ``(B, mid) x (mid, Ni)``
matmul plus top-k (``recommend``).

* :class:`ServingState` — what the export reads from a ``Trainer``, for
  parameters that come from elsewhere: the model, the graph variants'
  operands (``train.loop.GraphVariants``), the rating scalars.
* :func:`export_serving` — one eval-mode forward of a ``Trainer`` or a
  :class:`ServingState` -> :class:`ServingArtifact`.
* :class:`ServingArtifact` — ``U``, ``I``, the rating scalars and the
  rated edges in CSR form; ``save``/``load`` use the JAX package's
  ``.npz`` format, so artifacts move between the two packages.
* :class:`Predictor` — ``predict`` and ``recommend`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stargcn_tpu_torch.models.stargcn import STARGCN, feature_dims
from stargcn_tpu_torch.train.loop import GraphVariants, graph_features
from stargcn_tpu_torch.utils.device import resolve_device

NEG_INF = np.float32(-3.4e38)


@dataclasses.dataclass
class ServingArtifact:
    """Deployable scoring bundle (see module docstring)."""

    user_feats: np.ndarray  # (Nu, mid) f32
    item_feats: np.ndarray  # (Ni, mid) f32
    rating_mean: float
    rating_std: float
    rating_min: float
    rating_max: float
    # Known (already-rated) edges, CSR over users: items rated by user u
    # are ``rated_items[rated_indptr[u]:rated_indptr[u+1]]``.
    rated_indptr: Optional[np.ndarray] = None
    rated_items: Optional[np.ndarray] = None

    @property
    def num_users(self) -> int:
        return self.user_feats.shape[0]

    @property
    def num_items(self) -> int:
        return self.item_feats.shape[0]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            user_feats=self.user_feats, item_feats=self.item_feats,
            scalars=np.array([self.rating_mean, self.rating_std,
                              self.rating_min, self.rating_max],
                             np.float64),
            rated_indptr=(self.rated_indptr if self.rated_indptr is not None
                          else np.zeros(0, np.int64)),
            rated_items=(self.rated_items if self.rated_items is not None
                         else np.zeros(0, np.int32)))

    @classmethod
    def load(cls, path: str) -> "ServingArtifact":
        with np.load(path) as z:
            mean, std, lo, hi = z["scalars"]
            indptr = z["rated_indptr"]
            items = z["rated_items"]
            has_rated = indptr.size > 0
            return cls(user_feats=z["user_feats"], item_feats=z["item_feats"],
                       rating_mean=float(mean), rating_std=float(std),
                       rating_min=float(lo), rating_max=float(hi),
                       rated_indptr=indptr if has_rated else None,
                       rated_items=items if has_rated else None)


def _pairs_to_csr(pairs: np.ndarray, num_users: int):
    """(2, E) user/item id pairs -> (indptr, sorted col ids) over users."""
    u = np.asarray(pairs[0], np.int64)
    i = np.asarray(pairs[1], np.int32)
    order = np.argsort(u, kind="stable")
    u, i = u[order], i[order]
    indptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=num_users), out=indptr[1:])
    return indptr, i


class ServingState:
    """The model and the static per-variant operands the export reads —
    what ``export_serving`` takes from a ``Trainer``, without the
    optimiser and the training tables.

    Args:
      model_cfg: a ``STARGCNConfig`` on the ``bitdense``, ``ell``,
        ``dense`` or ``xla`` backend.
      data_iter: the ``DataIterator`` over the rating graph.
      device: where the model and its operands live (default the card).
      seed: seeds the ``torch.Generator`` that initialises the parameters
        when ``state_dict`` is not given.
      state_dict: parameters to load (e.g. ``convert.params_from_flax``
        of a JAX ``Trainer.params``, or a checkpoint's).
      variants: the ``GraphVariants`` of a ``Trainer`` over the same
        graph on the same device, to share its packs or adjacencies
        instead of building them again.
    """

    def __init__(self, model_cfg, data_iter, device="cuda", seed: int = 123,
                 state_dict=None, variants=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.data_iter = data_iter
        self.variants = variants if variants is not None else GraphVariants(
            model_cfg, data_iter, self.device)
        self.model = STARGCN(model_cfg,
                             generator=torch.Generator().manual_seed(seed),
                             feature_dims=feature_dims(data_iter))
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        self._features = graph_features(data_iter, model_cfg, self.device)

        train_ratings = data_iter.train_ratings
        self.rating_mean = float(train_ratings.mean())
        self.rating_std = float(train_ratings.std())
        vals = data_iter.possible_rating_values
        self.rating_min = float(vals.min())
        self.rating_max = float(vals.max())

    def features(self):
        """``(user, item)`` raw feature tensors on the device, or ``(None,
        None)`` without ``USE_FEA_PROJ``."""
        return self._features


def export_serving(state, segment: str = "test",
                   include_rated: bool = True) -> ServingArtifact:
    """Run the eval-mode encoder once and extract the scoring artifact:
    the segment's graph variant and the evaluation noise masking
    (nodes unseen in training -> zero embedding), with the graph's raw
    features where the model projects them.  ``state`` is a
    ``train.Trainer`` or a :class:`ServingState`."""
    it = state.data_iter
    dev = state.device
    seg = "valid" if segment == "valid" else "test"
    noise = it.evaluate_embed_noise_dict
    noise_u = torch.from_numpy(noise[it.name_user]).to(dev)
    noise_i = torch.from_numpy(noise[it.name_item]).to(dev)
    dummy = torch.zeros(1, dtype=torch.long, device=dev)
    fu, fi = state.features()
    with torch.no_grad():
        out = state.model(noise_u, noise_i, dummy, dummy,
                          state.variants.degrees(seg),
                          state.variants.operands(
                              seg, state.model_cfg.backend),
                          return_rating_feats=True, user_features=fu,
                          item_features=fi)
        feats = out["rating_feats"]
        cfg = state.model_cfg
        U = feats["user"][:cfg.num_users].float().cpu().numpy()
        I = feats["item"][:cfg.num_items].float().cpu().numpy()

    rated_indptr = rated_items = None
    if include_rated:
        rated_indptr, rated_items = _pairs_to_csr(
            state.variants.all_csr.node_pair_ids, state.model_cfg.num_users)

    return ServingArtifact(
        user_feats=U, item_feats=I,
        rating_mean=state.rating_mean, rating_std=state.rating_std,
        rating_min=state.rating_min, rating_max=state.rating_max,
        rated_indptr=rated_indptr, rated_items=rated_items)


class Predictor:
    """Query engine over a :class:`ServingArtifact`, on ``device``.

    Requests are processed in batches of ``batch_size`` pairs
    (``predict``) and ``recommend_batch`` users (``recommend``), which
    bounds the device memory a request takes.
    """

    def __init__(self, artifact: ServingArtifact, batch_size: int = 4096,
                 recommend_batch: int = 256, device="cuda"):
        self.art = artifact
        self.batch_size = int(batch_size)
        self.recommend_batch = int(recommend_batch)
        self.device = resolve_device(device)
        self._U = torch.from_numpy(
            np.ascontiguousarray(artifact.user_feats)).to(self.device)
        self._I = torch.from_numpy(
            np.ascontiguousarray(artifact.item_feats)).to(self.device)

    def _denorm(self, s):
        art = self.art
        return torch.clamp(s * art.rating_std + art.rating_mean,
                           art.rating_min, art.rating_max)

    def _ids(self, ids, n, what):
        ids = np.asarray(ids, np.int64).ravel()
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise IndexError(f"{what} id out of range [0, {n})")
        return ids

    @torch.inference_mode()
    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Denormalised, range-clipped ratings for arbitrary pairs."""
        uu = self._ids(user_ids, self.art.num_users, "user")
        ii = self._ids(item_ids, self.art.num_items, "item")
        if uu.shape != ii.shape:
            raise ValueError("predict takes as many user ids as item ids")
        out = np.empty(uu.size, np.float32)
        for s in range(0, uu.size, self.batch_size):
            e = min(s + self.batch_size, uu.size)
            pu = torch.from_numpy(uu[s:e]).to(self.device)
            pi = torch.from_numpy(ii[s:e]).to(self.device)
            score = (self._U[pu] * self._I[pi]).sum(dim=-1)
            out[s:e] = self._denorm(score).cpu().numpy()
        return out

    @torch.inference_mode()
    def recommend(self, user_ids, k: int = 10, exclude_rated: bool = True):
        """Top-``k`` items per user by predicted rating.

        Returns ``(item_ids, scores)`` of shape ``(len(user_ids), k)``.
        With ``exclude_rated`` (default), items the user already rated in
        the artifact's known graph are pushed to ``NEG_INF`` by one
        scatter-add over the padded per-user rated lists, so they are
        never recommended.
        """
        art = self.art
        uu = self._ids(user_ids, art.num_users, "user")
        do_excl = exclude_rated and art.rated_indptr is not None
        n = uu.size
        out_idx = np.empty((n, k), np.int32)
        out_val = np.empty((n, k), np.float32)
        for s in range(0, n, self.recommend_batch):
            batch = uu[s:s + self.recommend_batch]
            pu = torch.from_numpy(batch).to(self.device)
            scores = self._U[pu] @ self._I.T                 # (B, Ni)
            if do_excl:
                lo = art.rated_indptr[batch]
                deg = art.rated_indptr[batch + 1] - lo
                pad = max(int(deg.max(initial=0)), 1)
                col = np.arange(pad)
                valid = col[None, :] < deg[:, None]
                pos = np.where(valid, lo[:, None] + col[None, :], 0)
                rated = np.where(valid, art.rated_items[pos], 0)
                scores.scatter_add_(
                    1, torch.from_numpy(rated.astype(np.int64)).to(
                        self.device),
                    torch.from_numpy(valid.astype(np.float32)
                                     * NEG_INF).to(self.device))
            vals, idx = torch.topk(scores, k, dim=1)
            out_idx[s:s + batch.size] = idx.cpu().numpy()
            out_val[s:s + batch.size] = self._denorm(vals).cpu().numpy()
        return out_idx, out_val
