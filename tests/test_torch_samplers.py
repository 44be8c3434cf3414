"""The port's rating and reconstruction samplers against the JAX package's:
one ``RandomState(seed)`` consumed in the same order, so the same seed gives
**equal** batches, noise arrays and recon ids."""

import numpy as np
import pytest

from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn

RATINGS_10 = tuple(np.arange(0.5, 5.01, 0.5))


def _pair(p_zero=0.0, p_mask=0.1, seed=123):
    kw = dict(num_users=50, num_items=35, num_edges=600,
              rating_values=RATINGS_10, seed=7)
    out = []
    for cls, syn in ((DataIterator, tsyn), (JDataIterator, jsyn)):
        g = syn.synthetic_graph(**kw)
        pairs = g["user", "movie"].node_pair_ids
        perm = np.random.RandomState(0).permutation(pairs.shape[1])
        n = pairs.shape[1] // 10
        out.append(cls(g, "user", "movie",
                       test_node_pairs=pairs[:, perm[:n]],
                       valid_node_pairs=pairs[:, perm[n:2 * n]],
                       embed_P_mask=p_mask, embed_p_zero=p_zero,
                       embed_p_self=1.0 - p_zero, seed=seed))
    return out


def _same_batch(a, b):
    (pa, ra), (pb, rb) = a, b
    assert pa.dtype == pb.dtype and ra.dtype == rb.dtype
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("batch_size", [64, 100, 10_000])
def test_train_rating_batches_equal(batch_size):
    """Epoch-shuffled slices, over more than one epoch; a batch as large
    as the training set is the whole set every time."""
    t, j = _pair()
    ts = t.rating_sampler(batch_size, segment="train")
    js = j.rating_sampler(batch_size, segment="train")
    for _ in range(12):
        _same_batch(next(ts), next(js))


@pytest.mark.parametrize("segment", ["valid", "test"])
def test_sequential_batches_equal(segment):
    t, j = _pair()
    got = list(t.rating_sampler(25, segment=segment))
    want = list(j.rating_sampler(25, segment=segment))
    assert len(got) == len(want) == 3          # 60 pairs: 25 + 25 + 10
    for a, b in zip(got, want):
        _same_batch(a, b)
    assert got[-1][1].size == 10
    with pytest.raises(NotImplementedError):
        next(t.rating_sampler(25, segment="nope"))


@pytest.mark.parametrize("p_zero", [0.0, 0.4, 1.0])
def test_recon_sampler_equal(p_zero):
    """Noise arrays, batch ids and the epoch's ids, across several epochs
    (a recon batch smaller than the targets of one type)."""
    t, j = _pair(p_zero=p_zero, p_mask=0.3)
    ts = t.recon_nodes_sampler(batch_size=4)
    js = j.recon_nodes_sampler(batch_size=4)
    for _ in range(9):
        (tn, tb, ta), (jn, jb, ja) = next(ts), next(js)
        assert sorted(tn) == sorted(jn) == ["movie", "user"]
        for key in tn:
            assert tn[key].dtype == jn[key].dtype == np.int32
            np.testing.assert_array_equal(tn[key], jn[key])
        for got, want in ((tb, jb), (ta, ja)):
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])
    noise = tn["user"]
    assert set(np.unique(noise[noise != -1])) <= set(range(50))
    assert np.all(noise[noise != -1] == np.flatnonzero(noise != -1))
    with pytest.raises(NotImplementedError):
        next(t.recon_nodes_sampler(4, segment="valid"))


def test_interleaved_samplers_share_one_stream():
    """``fit`` draws a rating batch, then a recon batch, from one
    generator: interleaved draws stay equal too."""
    t, j = _pair(p_zero=0.5)
    tr, jr = (x.rating_sampler(64, segment="train") for x in (t, j))
    tc, jc = (x.recon_nodes_sampler(1_000_000) for x in (t, j))
    for _ in range(15):
        _same_batch(next(tr), next(jr))
        (tn, _, ta), (jn, _, ja) = next(tc), next(jc)
        for key in tn:
            np.testing.assert_array_equal(tn[key], jn[key])
            np.testing.assert_array_equal(ta[key], ja[key])


def test_sampler_properties_match():
    t, j = _pair(p_zero=0.25, p_mask=0.2)
    assert t.is_inductive is False and j.is_inductive is False
    assert t.embed_P_mask == j.embed_P_mask == {"user": 0.2, "movie": 0.2}
    assert t._embed_p_zero == j._embed_p_zero
    for key in ("user", "movie"):
        np.testing.assert_array_equal(t.recon_train_candidates[key],
                                      j.recon_train_candidates[key])
    with pytest.raises(ValueError):
        DataIterator(t.all_graph, "user", "movie",
                     test_node_pairs=t.test_node_pairs,
                     valid_node_pairs=t.valid_node_pairs,
                     embed_p_zero=0.5, embed_p_self=0.2)
