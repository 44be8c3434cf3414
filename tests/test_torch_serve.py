"""The port's serving slice as a whole against the JAX package's: export,
``predict``, ``recommend`` and the ``.npz`` artifact, on the same graph and
parameters.

Tolerance 2e-4 on ``U``/``I`` and ratings (float32, see
``test_torch_model.py``); the recommended item ids must be equal."""

import numpy as np
import pytest
import torch

from _torch_slice import build_pair
from stargcn_tpu import serve as jserve
from stargcn_tpu_torch import serve as tserve

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def slice_pair():
    trainer, state = build_pair("sum")
    return (trainer, state, jserve.export_serving(trainer, segment="test"),
            tserve.export_serving(state, segment="test"))


def test_export_matches_jax(slice_pair):
    _, _, jart, tart = slice_pair
    assert tart.user_feats.shape == jart.user_feats.shape == (40, 8)
    assert tart.item_feats.shape == jart.item_feats.shape == (30, 8)
    assert tart.user_feats.dtype == np.float32
    np.testing.assert_allclose(tart.user_feats, jart.user_feats, **TOL)
    np.testing.assert_allclose(tart.item_feats, jart.item_feats, **TOL)
    for name in ("rating_mean", "rating_std", "rating_min", "rating_max"):
        assert getattr(tart, name) == getattr(jart, name), name
    np.testing.assert_array_equal(tart.rated_indptr, jart.rated_indptr)
    np.testing.assert_array_equal(tart.rated_items, jart.rated_items)
    assert tart.rated_items.dtype == jart.rated_items.dtype


def test_export_valid_segment_matches_jax(slice_pair):
    trainer, state, _, _ = slice_pair
    jart = jserve.export_serving(trainer, segment="valid")
    tart = tserve.export_serving(state, segment="valid")
    np.testing.assert_allclose(tart.user_feats, jart.user_feats, **TOL)
    np.testing.assert_allclose(tart.item_feats, jart.item_feats, **TOL)


def test_predict_matches_jax(slice_pair):
    trainer, _, jart, tart = slice_pair
    rng = np.random.RandomState(7)
    uu = rng.randint(0, 40, 100)
    ii = rng.randint(0, 30, 100)
    got = tserve.Predictor(tart, batch_size=32, device="cpu").predict(uu, ii)
    want = jserve.Predictor(jart, batch_size=32).predict(uu, ii)
    assert got.shape == (100,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # and the JAX trainer's own eval path on the same segment
    np.testing.assert_allclose(
        got, trainer.predict(uu.astype(np.int32), ii.astype(np.int32),
                             segment="test"), **TOL)


def _untied(art, k):
    """Each user's best ``k + 1`` unrated items differ in score by more
    than 1e-5 of the largest score (the two packages agree to ~1e-6), so
    top-k has one answer."""
    scores = art.user_feats @ art.item_feats.T
    for u in range(art.num_users):
        scores[u, art.rated_items[art.rated_indptr[u]:
                                  art.rated_indptr[u + 1]]] = -np.inf
    top = -np.sort(-scores, axis=1)[:, :k + 1]
    return -np.diff(top, axis=1).min() > 1e-5 * np.abs(top).max()


def test_recommend_matches_jax_and_excludes_rated(slice_pair):
    _, _, jart, tart = slice_pair
    assert _untied(jart, 10)
    users = np.arange(40)
    t_idx, t_val = tserve.Predictor(tart, recommend_batch=16,
                                    device="cpu").recommend(users, k=10)
    j_idx, j_val = jserve.Predictor(jart, recommend_batch=16).recommend(
        users, k=10)
    assert t_idx.shape == (40, 10) and t_idx.dtype == np.int32
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_val, j_val, **TOL)
    for r, u in enumerate(users):
        rated = set(tart.rated_items[tart.rated_indptr[u]:
                                     tart.rated_indptr[u + 1]].tolist())
        assert not rated & set(t_idx[r].tolist()), u
    assert np.all(np.diff(t_val, axis=1) <= 0)
    # Without exclusion the top item is the plain argmax.
    idx, _ = tserve.Predictor(tart, device="cpu").recommend(
        users, k=1, exclude_rated=False)
    np.testing.assert_array_equal(
        idx[:, 0], np.argmax(tart.user_feats @ tart.item_feats.T, axis=1))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_artifact_moves_between_packages(slice_pair, tmp_path, writer):
    _, _, jart, tart = slice_pair
    path = str(tmp_path / "art.npz")
    (jart if writer == "jax" else tart).save(path)
    src = jart if writer == "jax" else tart
    for cls in (jserve.ServingArtifact, tserve.ServingArtifact):
        back = cls.load(path)
        np.testing.assert_array_equal(back.user_feats, src.user_feats)
        np.testing.assert_array_equal(back.item_feats, src.item_feats)
        np.testing.assert_array_equal(back.rated_indptr, src.rated_indptr)
        np.testing.assert_array_equal(back.rated_items, src.rated_items)
        assert (back.rating_mean, back.rating_std, back.rating_min,
                back.rating_max) == (src.rating_mean, src.rating_std,
                                     src.rating_min, src.rating_max)


def test_predictor_checks_ids(slice_pair):
    _, _, _, tart = slice_pair
    pred = tserve.Predictor(tart, device="cpu")
    with pytest.raises(IndexError):
        pred.predict([40], [0])
    with pytest.raises(ValueError):
        pred.predict([0, 1], [0])


def test_entry_points_refuse_missing_card(slice_pair):
    """The default device is the card; without one the entry points raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, state, _, tart = slice_pair
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.Predictor(tart)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.ServingState(state.model_cfg, state.data_iter)


def test_predict_cli_round_trip(slice_pair, tmp_path, capsys):
    """``python -m stargcn_tpu_torch.predict`` on an artifact the JAX
    package wrote, and the flags left to later slices."""
    import json

    from stargcn_tpu_torch import predict

    _, _, jart, _ = slice_pair
    path = str(tmp_path / "art.npz")
    jart.save(path)
    predict.main(["--artifact", path, "--device", "cpu", "--pairs",
                  "1:2,3:4", "--users", "5", "--topk", "3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["mode"] == "predict" and len(lines[0]["ratings"]) == 2
    want = jserve.Predictor(jart).recommend(np.array([5]), k=3)[0][0]
    assert lines[1]["items"] == want.tolist()
    for flag in ("--resume=x.msgpack", "--rank_eval"):
        with pytest.raises(SystemExit):
            predict.main(["--artifact", path, "--device", "cpu", flag])
        assert "not ported yet" in capsys.readouterr().err
