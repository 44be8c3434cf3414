"""Sampled-candidate ranking evaluation: HR@K / NDCG@K.

The port of ``stargcn_tpu/ranking.py``.  Each held-out positive edge is
ranked against ``num_negatives`` true non-edges drawn for the same user;
hit-rate@K and NDCG@K are averaged over the positives.  With the serving
artifact (``serve.py``) this makes a trained STAR-GCN an evaluable top-K
recommender.

Scoring one batch is one gather plus one batched inner product,
``U[u] (B, m)`` against ``I[cand] (B, 1+N, m)``, then a rank count; the
sweep walks the batches in Python with the two sums kept on the device and
read once at the end, so the gather slab never exceeds one batch.

Protocol (the reference's, so numbers are comparable run to run):

* negatives are drawn per user uniformly over that user's non-edges in
  the evaluation graph, WITH replacement across the ``num_negatives``
  draws (never a true edge);
* the positive's rank counts strictly greater negative scores only: ties
  go to the positive;
* ``HR@K = mean(rank < K)``; ``NDCG@K = mean(1/log2(rank+2))`` over hits,
  0 otherwise, averaged over RANKABLE positives (a user who rated every
  item has no negatives; such positives leave the numerator and the
  divisor).

Two routes draw the negatives:

* ``negatives="host"`` draws them with
  ``NegEdgeGenerator.sample_cols_for_rows`` (numpy) and copies the
  candidate stack to the device once.  Its candidates, and so its HR and
  NDCG, equal the reference's for the same ``rng``, up to the float32
  rounding of the scores and of the NDCG sum.
* ``negatives="device"`` (the default) draws them on the device by
  rank-space inversion, ``_draw_device_negatives``: fed the same uniforms,
  its candidates equal the reference's array for array.  Its own uniforms
  come from a counter-based hash of (seed, global positive index, slot),
  ``_uniforms``, so they are invariant to the batch size, as the
  reference's ``fold_in(key, index)`` draws are; they are not the
  reference's threefry draws, so this route's candidates agree with the
  reference only in distribution (uniform over each row's non-edges).
"""

from __future__ import annotations

import numpy as np
import torch

from stargcn_tpu_torch.data.iterators import NegEdgeGenerator
from stargcn_tpu_torch.utils.device import resolve_device

_MASK32 = 0xFFFFFFFF


def _batch_ranks(U, I, uu, cand, k):
    """Rank of column 0 of ``cand`` among all candidates, per row.

    ``uu (B,)`` user row indices; ``cand (B, 1+N)`` item column indices
    with the positive in column 0.  Returns ``(hit, ndcg)`` per row,
    float32.
    """
    u = U.index_select(0, uu)                                  # (B, m)
    c = I.index_select(0, cand.reshape(-1)).reshape(
        *cand.shape, I.shape[1])                                # (B, 1+N, m)
    scores = torch.einsum("bm,bnm->bn", u, c)
    rank = (scores[:, 1:] > scores[:, :1]).sum(dim=1)
    hit = rank < k
    ndcg = torch.where(hit, 1.0 / torch.log2(rank.float() + 2.0),
                       torch.zeros((), device=rank.device))
    return hit.float(), ndcg


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant ``c``, without an int64 product above 2**48."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _hash32(x):
    """A 32-bit integer mixer (Wellons' ``lowbias32``) on int64 tensors
    holding values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniforms(seed: int, index, num_neg: int):
    """``(B, num_neg)`` float32 uniforms in ``[0, 1)`` for the positives at
    global positions ``index`` (int64, ``(B,)``): a counter-based hash of
    (seed, index, slot), so a positive's draws do not depend on the batch
    it falls in.  The top 24 bits of each hash make the float, exactly."""
    key = int(_hash32(torch.tensor([seed & _MASK32]))[0])
    slot = torch.arange(num_neg, dtype=torch.int64, device=index.device)
    row = _hash32((index & _MASK32) ^ key)
    h = _hash32(row[:, None] ^ _hash32((slot + 0x9E3779B9) & _MASK32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _draw_device_negatives(indptr, cols_sorted, free, uu, u01,
                           bisect_iters: int):
    """``(B, N)`` uniform non-neighbour columns of the rows ``uu`` from the
    uniforms ``u01 (B, N)``, by rank-space inversion (the reference's
    ``_rank_sweep_devneg`` body): the rank ``kd = min(int(u01 * free[u]),
    max(free[u] - 1, 0))`` in float32, then the k-th missing column is
    ``kd + i*`` with ``i* = #{j : p[j] - j <= kd}`` over the row's sorted
    CSR window, found by a ``bisect_iters``-deep vectorised binary search.
    Indices are int64 throughout."""
    E = cols_sorted.shape[0]
    fr = free.index_select(0, uu)
    kd = torch.minimum((u01 * fr[:, None].to(torch.float32)).to(torch.int64),
                       (fr[:, None] - 1).clamp_min(0))
    s = indptr.index_select(0, uu)
    deg = indptr.index_select(0, uu + 1) - s
    lo = torch.zeros_like(kd)
    hi = deg[:, None].expand_as(kd).clone()
    s = s[:, None]
    for _ in range(bisect_iters):
        act = lo < hi
        mid = (lo + hi) >> 1
        v = cols_sorted[torch.clamp(s + mid, max=E - 1)]
        up = act & (v - mid <= kd)
        lo = torch.where(up, mid + 1, lo)
        hi = torch.where(act & ~up, mid, hi)
    return kd + lo


def _gen_device_tables(neg_gen, device):
    """``(indptr, sorted_cols, free, max_deg)``: the generator's row-space
    tables on ``device`` as int64 tensors, cached on the generator (they
    are immutable for its lifetime)."""
    device = torch.device(device)
    cache = getattr(neg_gen, "_device_tables", None)
    if cache is None:
        cache = neg_gen._device_tables = {}
    if str(device) not in cache:
        br = neg_gen._by_row
        cache[str(device)] = (
            torch.from_numpy(np.asarray(br.indptr, np.int64)).to(device),
            torch.from_numpy(np.asarray(br.sorted_cols, np.int64)).to(device),
            torch.from_numpy(np.asarray(br.free, np.int64)).to(device),
            int(np.diff(br.indptr).max(initial=0)))
    return cache[str(device)]


def _device_feats(artifact, device):
    """``(U, I)`` float32 feature tables of ``artifact`` on ``device``,
    cached on the artifact object (a fresh artifact copies them anew)."""
    cached = getattr(artifact, "_torch_device_feats", None)
    if cached is None or cached[0] != str(device):
        cached = (str(device),
                  torch.from_numpy(np.ascontiguousarray(
                      artifact.user_feats, np.float32)).to(device),
                  torch.from_numpy(np.ascontiguousarray(
                      artifact.item_feats, np.float32)).to(device))
        try:
            artifact._torch_device_feats = cached
        except (AttributeError, TypeError):  # frozen/slots artifact
            pass
    return cached[1], cached[2]


def bisect_iters(max_deg: int) -> int:
    """Iterations that collapse a width-``max_deg`` bisect interval."""
    return int(np.floor(np.log2(max(max_deg, 1)))) + 1


@torch.no_grad()
def rank_eval(artifact, user_inds, item_inds, neg_gen: NegEdgeGenerator,
              *, num_negatives: int = 100, k: int = 10,
              batch_size: int = 4096, rng=None, negatives: str = "device",
              device="cuda"):
    """HR@K / NDCG@K of ``artifact`` over held-out positives.

    Parameters
    ----------
    artifact : ServingArtifact (or anything with ``user_feats`` /
        ``item_feats`` arrays).
    user_inds, item_inds : int arrays of equal length: held-out positive
        edges in row / column index space.
    neg_gen : NegEdgeGenerator over the evaluation graph: negatives are
        non-edges of that graph, so pass the all-edges graph.
    num_negatives : candidates ranked against each positive.
    rng : np.random.RandomState seeding the draws (default: a fixed seed).
    negatives : 'device' (default) or 'host' (see the module docstring).
    device : where the sweep runs (default the card).

    Returns a dict: ``hr``, ``ndcg``, ``k``, ``num_negatives``,
    ``num_positives``, ``num_rankable``.
    """
    rng = rng or np.random.RandomState(12345)
    dev = resolve_device(device)
    uu = np.ascontiguousarray(np.asarray(user_inds, np.int64))
    ii = np.ascontiguousarray(np.asarray(item_inds, np.int64))
    if uu.shape != ii.shape or uu.ndim != 1:
        raise ValueError("rank_eval takes 1-D user and item index arrays "
                         "of one length")
    P = uu.size
    if P == 0:
        raise ValueError(
            "rank_eval got zero positives (empty eval segment, or "
            "max_positives filtered everything)")
    U, I = _device_feats(artifact, dev)
    B = int(batch_size)
    nb = -(-P // B)
    pad = nb * B - P
    # A user who rated EVERY item has no drawable negatives (free == 0):
    # its positives leave the metric and the divisor.
    rankable = np.asarray(neg_gen._by_row.free, np.int64)[uu] > 0
    P_eff = int(rankable.sum())
    if P_eff == 0:
        raise ValueError(
            "rank_eval: every positive's user has zero non-edges "
            "(free == 0) — nothing is rankable")
    uu_d = torch.from_numpy(np.pad(uu, (0, pad))).to(dev)
    valid = torch.from_numpy(np.pad(rankable.astype(np.float32),
                                    (0, pad))).to(dev)
    hr_sum = torch.zeros((), dtype=torch.float32, device=dev)
    ndcg_sum = torch.zeros((), dtype=torch.float32, device=dev)
    if negatives == "device":
        indptr, cols_sorted, free, max_deg = _gen_device_tables(neg_gen, dev)
        iters = bisect_iters(max_deg)
        seed = int(rng.randint(0, 2 ** 31 - 1))
        ii_d = torch.from_numpy(np.pad(ii, (0, pad))).to(dev)
        for b in range(nb):
            sl = slice(b * B, (b + 1) * B)
            uu_b = uu_d[sl]
            index = torch.arange(b * B, (b + 1) * B, dtype=torch.int64,
                                 device=dev)
            neg = _draw_device_negatives(
                indptr, cols_sorted, free, uu_b,
                _uniforms(seed, index, num_negatives), iters)
            cand = torch.cat([ii_d[sl, None], neg], dim=1)
            hit, ndcg = _batch_ranks(U, I, uu_b, cand, k)
            hr_sum += (hit * valid[sl]).sum()
            ndcg_sum += (ndcg * valid[sl]).sum()
    elif negatives == "host":
        # (P, N) negatives: N independent per-user draws; ``rng`` pins them
        # whatever the generator's own stream has done before.
        neg = neg_gen.sample_cols_for_rows(
            np.repeat(uu, num_negatives), rng=rng).reshape(P, num_negatives)
        cand = np.concatenate([ii[:, None], neg], axis=1).astype(np.int32)
        cand_d = torch.from_numpy(np.pad(cand, ((0, pad), (0, 0)))).to(dev)
        for b in range(nb):
            sl = slice(b * B, (b + 1) * B)
            hit, ndcg = _batch_ranks(U, I, uu_d[sl], cand_d[sl].long(), k)
            hr_sum += (hit * valid[sl]).sum()
            ndcg_sum += (ndcg * valid[sl]).sum()
    else:
        raise ValueError(f"negatives must be 'device' or 'host', got "
                         f"{negatives!r}")
    sums = torch.stack([hr_sum, ndcg_sum]).cpu().numpy()
    return {"hr": float(sums[0]) / P_eff, "ndcg": float(sums[1]) / P_eff,
            "k": k, "num_negatives": num_negatives, "num_positives": P,
            "num_rankable": P_eff}


def rank_eval_from_iterator(artifact, data_iter, *, segment: str = "test",
                            num_negatives: int = 100, k: int = 10,
                            batch_size: int = 4096, rng=None,
                            max_positives: int | None = None,
                            negatives: str = "device", device="cuda"):
    """``rank_eval`` over a segment of a ``DataIterator``: the
    ``NegEdgeGenerator`` is built over the ALL-edges graph (a negative is
    never a train/valid/test edge), the segment's node-pair ids become
    index space, and ``max_positives`` subsamples the positives with
    ``rng`` (default ``RandomState(12345)``)."""
    if segment not in ("test", "valid"):
        raise ValueError(f"segment must be 'test' or 'valid', got "
                         f"{segment!r}")
    rng = rng or np.random.RandomState(12345)
    csr = data_iter.all_graph[data_iter.name_user, data_iter.name_item]
    pairs = (data_iter.test_node_pairs if segment == "test"
             else data_iter.valid_node_pairs)
    uu = np.asarray(csr.row_id_to_ind(pairs[0]), np.int64)
    ii = np.asarray(csr.col_id_to_ind(pairs[1]), np.int64)
    if max_positives is not None and uu.size > max_positives:
        sel = rng.choice(uu.size, max_positives, replace=False)
        uu, ii = uu[sel], ii[sel]
    gen = NegEdgeGenerator(rng, csr)
    out = rank_eval(artifact, uu, ii, gen, num_negatives=num_negatives,
                    k=k, batch_size=batch_size, rng=rng,
                    negatives=negatives, device=device)
    out["segment"] = segment
    return out
