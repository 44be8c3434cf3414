"""Inductive splits in the port against the JAX package: ``DataIterator``'s
graph hierarchy and samplers, ``NegEdgeGenerator``'s draws, the first
training step of ``Trainer`` and ``SampledTrainer``, evaluation and the
serving export with the held-out nodes masked; then every shipped
inductive config fitting 10 steps full-graph and sampled, and the train and
predict CLIs on an ml-100k archive under ``--data_root``.

The step tests read an ml-100k-format fixture through both packages'
``build_dataset`` (so the split is ``LoadData``'s: held-out nodes keep
part of their edges) at narrow widths, as ``tests/test_torch_dense_xla.py``
does.  Tolerances are that file's: a step's loss 1e-4 relative; every
gradient within 1e-4 of its parameter's largest entry on float32
adjacencies and ``xla``, and within 4e-3 on the bf16 adjacency, where
both packages round the same operands to bf16 from float32 inputs that
differ in their last bits; evaluation, predictions and exported features
2e-4.  Downloads are switched off in every test: each archive is written
first.
"""

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (ROOT, build_inductive_sampled_trainers,
                          build_inductive_trainers, host_batches,
                          reference_on_cpu, sampled_batches, seed_planners,
                          set_keys, write_ml100k_fixture)
from experiments import common as jcommon
from stargcn_tpu import serve as jserve
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import NegEdgeGenerator as JNegEdgeGenerator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.train.loop import _train_step as j_train_step
from stargcn_tpu.train.sampled_loop import _sampled_train_step
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch import convert, predict
from stargcn_tpu_torch import serve as tserve
from stargcn_tpu_torch.data import DataIterator, NegEdgeGenerator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.train import (SampledTrainer, Trainer, TrainSettings,
                                     sampled_loop)
from stargcn_tpu_torch.utils import cfg_from_file

INDUCTIVE = sorted(glob.glob(os.path.join(ROOT, "configs",
                                          "inductive_*.yml")))
ITEM_CFG, USER_CFG = ("inductive_ml_100k_item_10.yml",
                      "inductive_ml_1m_user_50.yml")
# The narrow widths of tests/test_torch_dense_xla.py (20 agg units: divisible
# by 5 levels for 'stack').
NARROW = {"EMBED.UNITS": 8, "GCN.AGG.UNITS": [20], "GCN.OUT.UNITS": [6],
          "GEN_RATING.MID_MAP": 8}
GRAD_TOL = {"dense": 4e-3, "dense-f32": 1e-4, "xla": 1e-4}
GRAPH_FIELDS = ("ind_ptr", "end_points", "values", "row_ids", "col_ids")


@pytest.fixture(autouse=True)
def _offline_two_threads(monkeypatch):
    """No download in any test; two intra-op threads (several worker
    processes share the host)."""
    monkeypatch.setenv("STARGCN_AUTO_DOWNLOAD", "0")
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_ml100k_fixture(str(tmp_path_factory.mktemp("movielens")))


def e2e_split(cls, graph, key, seed=0):
    """The split of ``tests/test_configs_e2e.py``: a fifth of the key
    type's nodes are test nodes and a fifth valid nodes, each with all its
    edges held out."""
    pairs = graph["user", "movie"].node_pair_ids
    n_nodes = graph.node_ids[key].size
    axis = 1 if key == "movie" else 0
    ids = np.random.RandomState(seed).permutation(n_nodes).astype(np.int32)
    n_test = max(2, n_nodes // 5)
    test_ids, valid_ids = ids[:n_test], ids[n_test:2 * n_test]
    other = "user" if key == "movie" else "movie"
    return cls(
        graph, "user", "movie", is_inductive=True,
        test_node_pairs=pairs[:, np.isin(pairs[axis], test_ids)],
        valid_node_pairs=pairs[:, np.isin(pairs[axis], valid_ids)],
        inductive_key=key, inductive_train_ids=ids[2 * n_test:],
        inductive_valid_ids=valid_ids, embed_P_mask=0.4,
        embed_p_zero={key: 1.0, other: 0.0},
        embed_p_self={key: 0.0, other: 1.0}, seed=5)


def _iterators(source, key, data_root):
    """Both packages' inductive ``DataIterator`` over one split."""
    if source == "e2e":
        kw = dict(num_users=40, num_items=30, num_edges=600, seed=9)
        return (e2e_split(JDataIterator, jsyn.synthetic_graph(**kw), key),
                e2e_split(DataIterator, tsyn.synthetic_graph(**kw), key))
    path = os.path.join(ROOT, "configs",
                        ITEM_CFG if key == "movie" else USER_CFG)
    overrides = {"DATASET.NAME": "ml-100k"}
    return tuple(build(set_keys(load(path), overrides), data_root)[1]
                 for build, load in ((jcommon.build_dataset, j_cfg_from_file),
                                     (predict.build_dataset, cfg_from_file)))


@pytest.mark.parametrize("source", ["e2e", "LoadData"])
@pytest.mark.parametrize("key", ["movie", "user"])
def test_data_iterator_matches_jax(source, key, data_root):
    """Each variant's arrays, the ratings, the noise dicts and the first
    draws of both samplers."""
    j, t = _iterators(source, key, data_root)
    assert t.is_inductive and j.is_inductive
    for name in ("test_graph", "val_graph", "train_graph"):
        for pair in (("user", "movie"), ("movie", "user")):
            a, b = getattr(t, name)[pair], getattr(j, name)[pair]
            for field in GRAPH_FIELDS:
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field),
                                              err_msg=f"{name} {field}")
            np.testing.assert_array_equal(a.node_pair_ids, b.node_pair_ids)
        for k in ("user", "movie"):
            np.testing.assert_array_equal(getattr(t, name).node_ids[k],
                                          getattr(j, name).node_ids[k])
    # the held-out type shrinks in the train graph, the other does not
    other = "user" if key == "movie" else "movie"
    n_all = t.all_graph.node_ids[key].size
    assert t.train_graph.node_ids[key].size < t.val_graph.node_ids[
        key].size < n_all
    assert t.train_graph.node_ids[other].size == t.all_graph.node_ids[
        other].size
    for name in ("train_node_pairs", "train_ratings", "valid_node_pairs",
                 "valid_ratings", "test_node_pairs", "test_ratings",
                 "possible_rating_values"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    for k in ("user", "movie"):
        np.testing.assert_array_equal(t.evaluate_embed_noise_dict[k],
                                      j.evaluate_embed_noise_dict[k])
        np.testing.assert_array_equal(t.recon_train_candidates[k],
                                      j.recon_train_candidates[k])
    noise = t.evaluate_embed_noise_dict[key]
    unseen = np.setdiff1d(np.arange(n_all), t.train_graph.node_ids[key])
    assert unseen.size and (noise[unseen] == -1).all()
    tr, jr = t.rating_sampler(16), j.rating_sampler(16)
    tc, jc = t.recon_nodes_sampler(8), j.recon_nodes_sampler(8)
    for _ in range(6):
        for a, b in zip(next(tr), next(jr)):
            np.testing.assert_array_equal(a, b)
        (tn, tb, ta), (jn, jb, ja) = next(tc), next(jc)
        for k in tn:
            np.testing.assert_array_equal(tn[k], jn[k])
        assert (tn[key][unseen] == -1).all()
        for got, want in ((tb, jb), (ta, ja)):
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    for segment in ("valid", "test"):
        for a, b in zip(t.rating_sampler(7, segment), j.rating_sampler(
                7, segment)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("key", ["movie", "user"])
def test_neg_edge_generator_matches_jax(key):
    """The same draws from the same generator, on the inductive train
    graph (a subset of one node type, columns not sorted)."""
    kw = dict(num_users=40, num_items=30, num_edges=600, seed=9)
    j = e2e_split(JDataIterator, jsyn.synthetic_graph(**kw), key)
    t = e2e_split(DataIterator, tsyn.synthetic_graph(**kw), key)
    jcsr = j.train_graph["user", "movie"]
    tcsr = t.train_graph["user", "movie"]
    jg = JNegEdgeGenerator(np.random.RandomState(3), jcsr)
    tg = NegEdgeGenerator(np.random.RandomState(3), tcsr)
    pos = tcsr.node_pair_ids[:, ::4]
    for _ in range(2):
        for kind, ratio in (("all", 1.0), ("same_node", 1.0), ("all", 2.5)):
            got = tg.gen(pos, neg_sample_type=kind, neg_ratio=ratio)
            want = jg.gen(pos, neg_sample_type=kind, neg_ratio=ratio)
            np.testing.assert_array_equal(got, want)
            # negatives are non-edges of the train graph
            assert (tcsr.edge_indices_by_id(got) < 0).all()
        rows = np.arange(tcsr.shape[0]) % tcsr.shape[0]
        np.testing.assert_array_equal(tg.sample_cols_for_rows(rows),
                                      jg.sample_cols_for_rows(rows))
        cols = np.arange(tcsr.shape[1])
        np.testing.assert_array_equal(tg.sample_rows_for_cols(cols),
                                      jg.sample_rows_for_cols(cols))
    with pytest.raises(NotImplementedError):
        tg.gen(pos, neg_sample_type="other")


def _jax_loss_and_grads(jtrainer, rb, cb):
    """The JAX trainer's training loss and its gradient for one batch:
    the loss of its own step function, differentiated."""
    host = (jnp.asarray(a) for a in jtrainer._prep_host_arrays(rb, cb))
    args = (jtrainer.graph_data, jtrainer.edge_masks["train"],
            jtrainer._train_dense_adj(), jtrainer._train_variant_degrees(),
            jtrainer._ell_pack("train"), *host, jax.random.PRNGKey(0))

    def loss(params):
        return j_train_step(jtrainer, params, jtrainer.opt_state,
                            *args)[2]["loss"]

    value, grads = jax.value_and_grad(loss)(jtrainer.params)
    return float(value), convert.params_from_flax(jax.device_get(grads))


def _grads_close(tgrads, wgrads, tol):
    assert sorted(tgrads) == sorted(wgrads)
    for k, wg in wgrads.items():
        wg = wg.numpy()
        assert np.abs(wg).max() > 0, k
        np.testing.assert_allclose(tgrads[k].numpy(), wg, rtol=0,
                                   atol=tol * np.abs(wg).max(), err_msg=k)


@pytest.mark.parametrize("route", ["dense", "dense-f32"])
@pytest.mark.parametrize("cfg_name", [ITEM_CFG, USER_CFG])
def test_first_step_matches_jax(cfg_name, route, data_root):
    """The first step's loss and every gradient, with the batch's edges
    removed; then (on float32 adjacencies) evaluation, prediction on
    held-out nodes and the serving export, on the same parameters."""
    jtrainer, ttrainer = build_inductive_trainers(cfg_name, data_root,
                                                  route, **NARROW)
    it = ttrainer.data_iter
    assert ttrainer.model_cfg.backend == "dense" and ttrainer.do_remove
    assert it.is_inductive
    (rb, cb), = host_batches(jtrainer, 1)
    want_loss, wgrads = _jax_loss_and_grads(jtrainer, rb, cb)
    stats, tgrads = ttrainer.loss_and_grads(rb, cb)
    np.testing.assert_allclose(float(stats["loss"]), want_loss, rtol=1e-4)
    _grads_close(tgrads, wgrads, GRAD_TOL[route])
    if route == "dense":
        return
    for segment in ("valid", "test"):
        np.testing.assert_allclose(ttrainer.evaluate(segment),
                                   jtrainer.evaluate(segment), rtol=2e-4)
    # cold start: the held-out test nodes' pairs, masked as evaluation
    # masks them, in the trainer and in its serving export
    pairs = it.test_node_pairs
    got = ttrainer.predict(pairs[0], pairs[1], segment="test")
    np.testing.assert_allclose(
        got, jtrainer.predict(pairs[0], pairs[1], segment="test"),
        rtol=2e-4, atol=2e-4)
    art = tserve.export_serving(ttrainer, segment="test")
    jart = jserve.export_serving(jtrainer, segment="test")
    np.testing.assert_allclose(art.user_feats, jart.user_feats, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(art.item_feats, jart.item_feats, rtol=2e-4,
                               atol=2e-4)
    served = tserve.Predictor(art, device="cpu").predict(pairs[0], pairs[1])
    np.testing.assert_allclose(served, got, rtol=1e-5, atol=1e-5)
    key = it.name_item if "item" in cfg_name else it.name_user
    held_out = np.unique(pairs[0 if key == it.name_user else 1])
    assert (it.evaluate_embed_noise_dict[key][held_out] == -1).all()


@pytest.mark.parametrize("cfg_name", [ITEM_CFG, USER_CFG])
def test_sampled_first_step_matches_jax(cfg_name, data_root):
    """``SampledTrainer`` on the inductive split: the same plans from the
    same seeds, the first step's loss and every gradient (float32), and
    evaluation on the valid and test graphs."""
    with reference_on_cpu():
        jtrainer, ttrainer = build_inductive_sampled_trainers(
            cfg_name, data_root, **NARROW)
        assert ttrainer.caps == jtrainer.caps and ttrainer.do_remove
        batch, = sampled_batches(jtrainer, 1)
        ibuf, fbuf, spec = jtrainer._pack_batch(batch)

        def loss(params):
            return _sampled_train_step(
                jtrainer, params, jtrainer.opt_state, jnp.asarray(ibuf),
                jnp.asarray(fbuf), spec, jax.random.PRNGKey(0))[2]["loss"]

        want_loss, jgrads = jax.value_and_grad(loss)(jtrainer.params)
        stats, tgrads = sampled_loop._loss_and_grads(
            ttrainer, ttrainer._feed(ttrainer._pack_batch(batch)))
        np.testing.assert_allclose(float(stats["loss"]), float(want_loss),
                                   rtol=1e-4)
        _grads_close(tgrads, convert.params_from_flax(
            jax.device_get(jgrads)), 1e-4)
        for segment in ("valid", "test"):
            seed_planners(14)
            got = ttrainer.evaluate(segment)
            seed_planners(14)
            np.testing.assert_allclose(got, jtrainer.evaluate(segment),
                                       rtol=2e-4)


def test_planner_refuses_a_held_out_node(data_root):
    """The train graph has no row for a held-out node: the planner
    raises instead of sampling another node's neighborhood."""
    cfg = set_keys(cfg_from_file(os.path.join(ROOT, "configs", ITEM_CFG)),
                   {"DATASET.NAME": "ml-100k", **NARROW})
    _, it, model_cfg = predict.build_dataset(cfg, data_root)
    s = SampledTrainer(model_cfg, it, TrainSettings.from_cfg(cfg), fanout=4,
                       device="cpu")
    held_out = np.setdiff1d(np.arange(it.all_graph.node_ids["movie"].size),
                            it.train_graph.node_ids["movie"])
    sampler = s.samplers["train"]
    with pytest.raises(ValueError, match="not in this graph"):
        sampler.sample(np.array([0], np.int32), held_out[:1])
    with pytest.raises(ValueError, match="not in this graph"):
        sampler.removal_args(np.array([0], np.int32), held_out[:1])
    # the valid graph holds the valid nodes
    valid_ids = it.valid_node_pairs[1]
    s.samplers["valid"].sample(np.array([0], np.int32), valid_ids[:3])


def _tiny_inductive(cfg):
    key = "movie" if cfg.DATASET.INDUCTIVE_KEY == "item" else "user"
    g = tsyn.synthetic_graph(num_users=40, num_items=30, num_edges=600,
                             seed=9)
    it = e2e_split(DataIterator, g, key)
    other = "user" if key == "movie" else "movie"
    it._embed_P_mask = {key: cfg.EMBED.MASK_PROP,
                        other: cfg.EMBED.MASK_PROP}
    it._embed_p_zero = {key: cfg.EMBED.P_ZERO, other: 0.0}
    it._embed_p_self = {key: 1.0 - cfg.EMBED.P_ZERO, other: 1.0}
    return g, it


@pytest.mark.parametrize("cfg_path", INDUCTIVE, ids=os.path.basename)
def test_inductive_config_fits(cfg_path):
    """Every inductive config trains, validates and checkpoints 10 steps
    full-graph (``auto`` resolves to ``dense``) and sampled (fanout 4) on
    the 40 x 30 graph, split as ``tests/test_configs_e2e.py`` splits it."""
    cfg = cfg_from_file(cfg_path)
    cfg.TRAIN.RATING_BATCH_SIZE = 64
    cfg.TRAIN.SCAN_STEPS = 1
    g, it = _tiny_inductive(cfg)
    csr = g["user", "movie"]
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link), num_edges=csr.nnz)
    assert model_cfg.backend == "dense"
    trainer = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                      device="cpu")
    result = trainer.fit(max_iter=10, log=lambda *_: None)
    assert result["best_iter"] == 10
    assert np.isfinite(result["best_valid_rmse"])
    assert np.isfinite(result["best_test_rmse"]).all()
    settings = TrainSettings.from_cfg(cfg)
    settings.recon_batch_size = min(settings.recon_batch_size, 16)
    sampled = SampledTrainer(model_cfg, it, settings, fanout=4,
                             device="cpu")
    s_result = sampled.fit(max_iter=10, log=lambda *_: None)
    assert np.isfinite(s_result["best_valid_rmse"])


def test_train_and_predict_cli_on_an_archive(tmp_path, data_root, capsys):
    """``python -m stargcn_tpu_torch.train --data_root`` on the ml-100k
    archive with an inductive config, then the predict CLI serving its
    checkpoint on the same split."""
    import yaml

    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "ind.yml"
    with open(os.path.join(ROOT, "configs", USER_CFG)) as f:
        cfg = yaml.safe_load(f)
    cfg["DATASET"]["NAME"] = "ml-100k"
    cfg["DATASET"]["IS_INDUCTIVE"] = False       # --inductive sets it
    cfg["EMBED"]["UNITS"] = 8
    cfg["GCN"]["AGG"]["UNITS"] = [20]
    cfg["GCN"]["OUT"]["UNITS"] = [6]
    cfg["GEN_RATING"]["MID_MAP"] = 8
    cfg["TRAIN"].update(RATING_BATCH_SIZE=256, LOG_INTERVAL=5,
                        VALID_INTERVAL=10)
    cfg_path.write_text(yaml.safe_dump(cfg))
    save_dir = tmp_path / "runs"
    common = ["--cfg", str(cfg_path), "--data_root", data_root,
              "--device", "cpu"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main(common + [
            "--inductive", "--save_dir", str(save_dir), "--max_iter", "10",
            "--silent"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 10
    assert np.isfinite(result["best_valid_rmse"])
    with open(save_dir / "cfg0.yml") as f:
        assert yaml.safe_load(f)["DATASET"]["IS_INDUCTIVE"] is True
    capsys.readouterr()
    cfg["DATASET"]["IS_INDUCTIVE"] = True
    cfg_path.write_text(yaml.safe_dump(cfg))
    predict.main(common + ["--resume", str(save_dir / "ckpt_best_0.pt"),
                           "--pairs", "1:2,3:4", "--users", "1",
                           "--topk", "3"])
    out = [yaml.safe_load(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0]["mode"] == "predict" and len(out[0]["ratings"]) == 2
    assert np.isfinite(out[0]["ratings"]).all()
    assert len(out[1]["items"]) == 3
