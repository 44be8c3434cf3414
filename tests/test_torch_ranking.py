"""The port's ranking evaluation (``stargcn_tpu_torch/ranking.py``) against
the JAX package's ``stargcn_tpu/ranking.py``, on the CPU.

* host negatives: the same artifact arrays, positives and ``RandomState``
  give the JAX package's HR and NDCG within 1e-6 (float32 scores; the NDCG
  sum in float32);
* device negatives fed the JAX package's own ``fold_in`` uniforms give its
  candidates array for array (captured from inside its jitted sweep);
* the device route with the port's own uniforms is held in distribution:
  every candidate a non-edge, every non-edge of a row drawn, the metric
  invariant to the batch size;
* the protocol pins of ``tests/test_ranking.py``: a perfect artifact scores
  1, an anti-perfect one 0, positives of a user with no non-edge leave the
  metric, and the errors;
* ``python -m stargcn_tpu_torch.predict --rank_eval`` through ``main``.

Every test builds a fresh artifact (the device feature tables are cached on
the artifact object)."""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import ROOT
from stargcn_tpu import ranking as jranking
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import NegEdgeGenerator as JNegEdgeGenerator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu_torch import predict as tpredict
from stargcn_tpu_torch import ranking
from stargcn_tpu_torch.data import DataIterator, NegEdgeGenerator
from stargcn_tpu_torch.data import synthetic as tsyn


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


class _Art:
    """A fresh scoring artifact: the two feature tables."""

    def __init__(self, U, I):
        self.user_feats = np.asarray(U, np.float32)
        self.item_feats = np.asarray(I, np.float32)


def _graphs(seed=7, nu=40, ni=30, ne=420):
    kw = dict(num_users=nu, num_items=ni, num_edges=ne, seed=seed)
    return (jsyn.synthetic_graph(**kw)["user", "movie"],
            tsyn.synthetic_graph(**kw)["user", "movie"])


def _positives(jcsr):
    pi = jcsr.node_pair_indices
    return np.asarray(pi[0], np.int64), np.asarray(pi[1], np.int64)


def _random_art(jcsr, m=6, seed=3):
    r = np.random.RandomState(seed)
    return _Art(r.randn(jcsr.shape[0], m), r.randn(jcsr.shape[1], m))


def _port(art, uu, ii, tcsr, seed, **kw):
    return ranking.rank_eval(art, uu, ii, NegEdgeGenerator(
        np.random.RandomState(0), tcsr), rng=np.random.RandomState(seed),
        device="cpu", **kw)


@pytest.mark.parametrize("batch_size,k", [(16, 5), (4096, 10), (7, 1)])
def test_host_route_matches_jax(batch_size, k):
    jcsr, tcsr = _graphs()
    uu, ii = _positives(jcsr)
    kw = dict(num_negatives=20, k=k, batch_size=batch_size,
              negatives="host")
    want = jranking.rank_eval(
        _random_art(jcsr), uu, ii,
        JNegEdgeGenerator(np.random.RandomState(0), jcsr),
        rng=np.random.RandomState(11), **kw)
    got = _port(_random_art(jcsr), uu, ii, tcsr, 11, **kw)
    assert 0.0 < got["hr"] < 1.0
    for key in ("hr", "ndcg"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    for key in ("k", "num_negatives", "num_positives", "num_rankable"):
        assert got[key] == want[key], key


def _jax_device_candidates(art, uu, ii, jgen, num_neg, batch_size, seed):
    """The candidates the JAX package's jitted device sweep scores, batch
    by batch: its ``_batch_ranks`` is replaced, for one fresh trace, by one
    that hands ``cand`` to the host."""
    seen = []

    def recording(U, I, uu_b, cand_b, k):
        jax.debug.callback(lambda c: seen.append(np.asarray(c)), cand_b,
                           ordered=True)
        z = jnp.zeros(uu_b.shape[0], jnp.float32)
        return z, z

    jax.clear_caches()
    try:
        with mock.patch.object(jranking, "_batch_ranks", recording):
            jranking.rank_eval(art, uu, ii, jgen, num_negatives=num_neg,
                               k=3, batch_size=batch_size,
                               rng=np.random.RandomState(seed),
                               negatives="device")
            jax.effects_barrier()
    finally:
        jax.clear_caches()
    return np.concatenate(seen)


@pytest.mark.parametrize("batch_size", [16, 50])
def test_device_draw_fed_jax_uniforms_matches_jax(batch_size):
    """``_draw_device_negatives`` fed the JAX package's
    ``uniform(fold_in(key, i), (N,))`` draws gives the candidates of its
    ``_rank_sweep_devneg``, array for array (padded tail rows included)."""
    jcsr, tcsr = _graphs(seed=4)
    uu, ii = _positives(jcsr)
    N, seed = 12, 5
    want = _jax_device_candidates(
        _random_art(jcsr), uu, ii,
        JNegEdgeGenerator(np.random.RandomState(0), jcsr), N, batch_size,
        seed)
    P = uu.size
    nb = -(-P // batch_size)
    pad = nb * batch_size - P
    uu_p = np.pad(uu, (0, pad))
    assert want.shape == (nb * batch_size, N + 1)

    key = jax.random.PRNGKey(np.random.RandomState(seed).randint(
        0, 2 ** 31 - 1))
    idx = jnp.arange(nb * batch_size, dtype=jnp.int32)
    u01 = np.array(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(key, i), (N,)))(idx))
    gen = NegEdgeGenerator(np.random.RandomState(0), tcsr)
    indptr, cols, free, max_deg = ranking._gen_device_tables(gen, "cpu")
    got = ranking._draw_device_negatives(
        indptr, cols, free, torch.from_numpy(uu_p), torch.from_numpy(u01),
        ranking.bisect_iters(max_deg))
    np.testing.assert_array_equal(got.numpy(), want[:, 1:])
    np.testing.assert_array_equal(want[:P, 0], ii)


def _perfect(jcsr, sign):
    """U[u] = sign x one-hot of u's positives, I = identity: every
    positive scores ``sign``, every non-edge 0."""
    nu, ni = jcsr.shape
    uu, ii = _positives(jcsr)
    uu, ii = uu[:40], ii[:40]
    U = np.zeros((nu, ni), np.float32)
    U[uu, ii] = sign
    return _Art(U, np.eye(ni, dtype=np.float32)), uu, ii


@pytest.mark.parametrize("negatives", ["host", "device"])
def test_perfect_and_anti_perfect_artifacts(negatives):
    jcsr, tcsr = _graphs(seed=9)
    art, uu, ii = _perfect(jcsr, 1.0)
    out = _port(art, uu, ii, tcsr, 1, num_negatives=12, k=5,
                batch_size=16, negatives=negatives)
    assert out["hr"] == 1.0 and out["ndcg"] == 1.0
    assert out["num_positives"] == 40
    art, uu, ii = _perfect(jcsr, -1.0)
    out = _port(art, uu, ii, tcsr, 1, num_negatives=10, k=10,
                batch_size=8, negatives=negatives)
    assert out["hr"] == 0.0 and out["ndcg"] == 0.0


def test_device_route_batch_size_invariance():
    """Each positive's draws depend on its global index, not its batch:
    the device route gives one HR at every batch size."""
    jcsr, tcsr = _graphs(seed=2)
    uu, ii = _positives(jcsr)
    outs = [_port(_random_art(jcsr), uu, ii, tcsr, 11, num_negatives=20,
                  k=5, batch_size=bs) for bs in (3, 17, 4096)]
    assert 0.0 < outs[0]["hr"] < 1.0
    for o in outs[1:]:
        assert o["hr"] == outs[0]["hr"]
        assert o["ndcg"] == pytest.approx(outs[0]["ndcg"], abs=1e-6)


def test_device_negatives_are_uniform_non_edges():
    """The port's own uniforms through the device draw: no candidate is an
    edge, each row's draws cover all of its non-edges, and none falls
    outside ``[0, num_items)``; a chi-square of one row's counts stays
    within its 99.9% bound."""
    jcsr, tcsr = _graphs(seed=13, nu=8, ni=7, ne=30)
    gen = NegEdgeGenerator(np.random.RandomState(0), tcsr)
    indptr, cols, free, max_deg = ranking._gen_device_tables(gen, "cpu")
    dense = np.zeros(tcsr.shape, bool)
    dense[tcsr.row_indices, tcsr.end_points] = True
    rows = torch.arange(tcsr.shape[0]).repeat_interleave(50)
    index = torch.arange(rows.numel())
    got = ranking._draw_device_negatives(
        indptr, cols, free, rows, ranking._uniforms(77, index, 40),
        ranking.bisect_iters(max_deg)).numpy()
    r = np.repeat(rows.numpy()[:, None], 40, axis=1)
    assert got.min() >= 0 and got.max() < tcsr.shape[1]
    assert not dense[r, got].any()
    for row in range(tcsr.shape[0]):
        drawn = got[r == row]
        np.testing.assert_array_equal(np.unique(drawn),
                                      np.where(~dense[row])[0])
        counts = np.bincount(drawn, minlength=tcsr.shape[1])[~dense[row]]
        expect = drawn.size / counts.size
        chi2 = ((counts - expect) ** 2 / expect).sum()
        assert chi2 < 24.3, (row, counts)     # chi2(6 dof) at 99.9%


def test_saturated_users_leave_the_metric():
    """A user who rated every item has no negatives: its positives leave
    the numerator and the divisor, as in the JAX package."""
    g_kw = dict(num_users=12, num_items=6, num_edges=30, seed=1)
    jg, tg = jsyn.synthetic_graph(**g_kw), tsyn.synthetic_graph(**g_kw)
    jcsr = jg["user", "movie"]
    uu, ii = _positives(jcsr)
    # The first positive's user reads as saturated in both generators:
    # the metric reads only its free count.
    tgen = NegEdgeGenerator(np.random.RandomState(0), tg["user", "movie"])
    jgen = JNegEdgeGenerator(np.random.RandomState(0), jcsr)
    for gen in (tgen, jgen):
        gen._by_row.free = gen._by_row.free.copy()
        gen._by_row.free[uu[0]] = 0
    r = np.random.RandomState(4)
    U, I = r.randn(12, 5), r.randn(6, 5)
    got = ranking.rank_eval(_Art(U, I), uu, ii, tgen, num_negatives=5, k=2,
                            rng=np.random.RandomState(3), negatives="host",
                            device="cpu")
    want = jranking.rank_eval(_Art(U, I), uu, ii, jgen, num_negatives=5,
                              k=2, rng=np.random.RandomState(3),
                              negatives="host")
    n_sat = int((uu == uu[0]).sum())
    assert got["num_rankable"] == want["num_rankable"] == uu.size - n_sat
    assert got["hr"] == pytest.approx(want["hr"], abs=1e-6)
    assert got["ndcg"] == pytest.approx(want["ndcg"], abs=1e-6)


def test_errors():
    jcsr, tcsr = _graphs()
    gen = NegEdgeGenerator(np.random.RandomState(0), tcsr)
    art = _random_art(jcsr)
    with pytest.raises(ValueError, match="zero positives"):
        ranking.rank_eval(art, [], [], gen, device="cpu")
    gen._by_row.free = np.zeros_like(gen._by_row.free)
    with pytest.raises(ValueError, match="nothing is rankable"):
        ranking.rank_eval(art, [0, 1], [0, 1], gen, device="cpu")
    gen = NegEdgeGenerator(np.random.RandomState(0), tcsr)
    with pytest.raises(ValueError, match="negatives must be"):
        ranking.rank_eval(art, [0], [0], gen, negatives="both",
                          device="cpu")
    with pytest.raises(ValueError, match="segment must be"):
        ranking.rank_eval_from_iterator(art, None, segment="train",
                                        device="cpu")


def _iterators():
    kw = dict(num_users=30, num_items=22, num_edges=260, seed=21)
    out = []
    for syn, cls in ((jsyn, JDataIterator), (tsyn, DataIterator)):
        g = syn.synthetic_graph(**kw)
        pairs = g["user", "movie"].node_pair_ids
        perm = np.random.RandomState(0).permutation(pairs.shape[1])
        out.append(cls(g, "user", "movie",
                       test_node_pairs=pairs[:, perm[:50]],
                       valid_node_pairs=pairs[:, perm[50:90]],
                       embed_P_mask=0.1, embed_p_zero=1.0, embed_p_self=0.0,
                       seed=2))
    return out


@pytest.mark.parametrize("segment,max_positives", [("test", None),
                                                   ("valid", 25)])
def test_rank_eval_from_iterator_matches_jax(segment, max_positives):
    jit_, tit = _iterators()
    r = np.random.RandomState(5)
    U, I = r.randn(30, 4), r.randn(22, 4)
    kw = dict(segment=segment, num_negatives=8, k=3, batch_size=16,
              max_positives=max_positives, negatives="host")
    want = jranking.rank_eval_from_iterator(_Art(U, I), jit_, **kw)
    got = ranking.rank_eval_from_iterator(_Art(U, I), tit, device="cpu",
                                          **kw)
    assert got["segment"] == segment
    assert got["num_positives"] == want["num_positives"] == (
        max_positives or 50)
    for key in ("hr", "ndcg"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    dev = ranking.rank_eval_from_iterator(
        _Art(U, I), tit, device="cpu", **{**kw, "negatives": "device"})
    assert 0.0 <= dev["ndcg"] <= dev["hr"] <= 1.0


def test_predict_cli_rank_eval(capsys, tmp_path):
    cfg = f"{ROOT}/configs/transductive_ml_100k.yml"
    tpredict.main(["--cfg", cfg, "--dataset", "synthetic", "--device",
                   "cpu", "--rank_eval", "--rank_k", "5",
                   "--rank_negatives", "20", "--rank_max_positives", "300",
                   "--save_artifact", str(tmp_path / "art.npz")])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rank = [x for x in lines if x["mode"] == "rank_eval"]
    assert len(rank) == 1
    out = rank[0]
    assert out["k"] == 5 and out["num_negatives"] == 20
    assert out["num_positives"] == 300 and out["segment"] == "test"
    assert 0.0 <= out["ndcg"] <= out["hr"] <= 1.0
    with pytest.raises(SystemExit):
        tpredict.main(["--artifact", str(tmp_path / "art.npz"), "--device",
                       "cpu", "--rank_eval"])
    assert "needs the dataset" in capsys.readouterr().err
