"""The port's trainer with ``KERNEL.BIT_IMPL: pallas16`` (row-interleaved
packs, the ``bit_*_matmul16`` wrappers) against the JAX package's trainer
and against the port's ``pallas`` trainer, on the CPU with dropout 0 and
the same host-fed batches.  The JAX side runs ``bit_impl="xla"`` on
natural packs, as ``tests/test_torch_model_train.py`` holds it: the
16-bit route is the same function on another pack layout.

Tolerances: one step's statistics and each parameter's gradient 1e-4
(relative, and of the gradient's largest entry); after two steps 1e-3 of
each parameter tensor's largest entry; between the port's two routes, which
sum the same terms over rows in another order, 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import build_trainers, host_batches, small_ml10m_cfg
from stargcn_tpu.train import loop as jloop
from stargcn_tpu_torch import convert
from stargcn_tpu_torch import serve as tserve
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.ops import bitdense as tbd
from stargcn_tpu_torch.train import Trainer as TTrainer
from stargcn_tpu_torch.train import TrainSettings as TTrainSettings
from stargcn_tpu_torch.utils import cfg_from_file

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


def _pallas16_trainer(ttrainer, save_dir=None):
    """The port's trainer from the same small config with
    ``KERNEL.BIT_IMPL: pallas16``, on ``ttrainer``'s data and parameters."""
    tcfg = small_ml10m_cfg(cfg_from_file, "sum", **{
        "GCN.DROPOUT": 0.0, "KERNEL.BIT_IMPL": "pallas16"})
    c = ttrainer.model_cfg
    mcfg = build_model_config(tcfg, c.num_users, c.num_items, c.num_links)
    assert mcfg.bit_impl == "pallas16"
    t16 = TTrainer(mcfg, ttrainer.data_iter, TTrainSettings.from_cfg(tcfg),
                   device="cpu", save_dir=save_dir)
    t16.model.load_state_dict(ttrainer.model.state_dict())
    return t16


def _counting(monkeypatch):
    """Count calls of the four bit wrappers (on the CPU they run their
    plain versions and count no launch)."""
    calls = dict.fromkeys(("bit_expand_matmul", "bit_reduce_matmul",
                           "bit_expand_matmul16", "bit_reduce_matmul16"), 0)
    for name in calls:
        real = getattr(tbd, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tbd, name, wrapped)
    return calls


class _CaptureGrads:
    """Stands in for the JAX trainer's optimizer inside ``_train_step``:
    keeps the gradients, updates nothing."""

    def update(self, grads, state, params=None):
        self.grads = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), state


def _jax_stats_and_grads(jt, batch):
    ints, flts, noise, rmask = jt._place_step_inputs(
        *jt._prep_host_arrays(*batch))
    cap = _CaptureGrads()
    real, jt.opt = jt.opt, cap
    try:
        _, _, stats = jloop._train_step(
            jt, jt.params, jt.opt_state, jt.graph_data,
            jt.edge_masks["train"], jt._train_dense_adj(),
            jt._train_variant_degrees(), jt._ell_pack("train"), ints, flts,
            noise, rmask, jax.random.PRNGKey(0))
    finally:
        jt.opt = real
    return (jax.device_get(stats),
            convert.params_from_flax(jax.device_get(cap.grads)))


def test_pallas16_trainer_builds_interleaved_packs():
    _, ttrainer = build_trainers("sum")
    t16 = _pallas16_trainer(ttrainer)
    nat, p16 = ttrainer.variants, t16.variants
    R = t16.model_cfg.num_links
    for variant in ("train", "test"):
        a, b = nat.bit_pack(variant), p16.bit_pack(variant)
        assert (a["row_interleave"], b["row_interleave"]) == (0, 128)
        for t in ("user", "item"):
            P = b[t]["pf"]
            d8 = P.shape[0] // R
            phys = tbd.natural_to_physical(torch.arange(d8), 128)
            assert torch.equal(P.view(R, d8, -1)[:, phys].reshape(P.shape),
                               a[t]["pf"])
    assert p16.bit_pack("valid") is p16.bit_pack("train")


def test_pallas16_step_gradients_match_jax(monkeypatch):
    jtrainer, ttrainer = build_trainers("sum")
    t16 = _pallas16_trainer(ttrainer)
    batch = host_batches(jtrainer, 1)[0]
    want_stats, want = _jax_stats_and_grads(jtrainer, batch)
    calls = _counting(monkeypatch)
    stats, got = t16.loss_and_grads(*batch)
    # 4 aggregation layers forward, 4 backward, all on the 16-bit route.
    assert calls == {"bit_expand_matmul": 0, "bit_reduce_matmul": 0,
                     "bit_expand_matmul16": 4, "bit_reduce_matmul16": 4}
    for name in ("loss", "rating_loss", "recon_loss", "sq_err"):
        np.testing.assert_allclose(stats[name].numpy(), want_stats[name],
                                   rtol=1e-4, atol=0, err_msg=name)
    assert sorted(got) == sorted(want)
    for k, wg in want.items():
        wg = wg.numpy()
        assert np.abs(wg).max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max(), err_msg=k)
    # ... and the port's pallas route on the same batch, to 1e-5.
    stats_n, nat = ttrainer.loss_and_grads(*batch)
    np.testing.assert_allclose(stats["loss"].numpy(),
                               stats_n["loss"].numpy(), rtol=1e-5)
    for k, g in nat.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()),
                                   err_msg=k)


def test_pallas16_steps_match_jax():
    jtrainer, ttrainer = build_trainers("sum")
    t16 = _pallas16_trainer(ttrainer)
    for rb, cb in host_batches(jtrainer, 2):
        want = jax.device_get(jtrainer.train_iteration(rb, cb))
        got = t16.train_iteration(rb, cb)
        for name in STATS:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=1e-4, atol=0, err_msg=name)
    want = convert.params_from_flax(jax.device_get(jtrainer.params))
    for k, p in t16.model.state_dict().items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    assert t16.opt.count == 2


def test_checkpoints_interchange_with_pallas(tmp_path):
    """A ``pallas16`` trainer's checkpoint loads into a ``pallas`` trainer
    and back: the parameters and the optimizer state are the layout's
    no more than the artifact is."""
    _, a = build_trainers("sum")
    t16 = _pallas16_trainer(a, save_dir=str(tmp_path / "p16"))
    batches = host_batches(a, 4)
    t16.train_iteration(*batches[0])
    t16.train_iteration(*batches[1])
    path = t16.save_checkpoint("last")

    _, b = build_trainers("sum", save_dir=str(tmp_path))
    b.restore_checkpoint(path)
    assert b.opt.count == 2
    for (k, p), q in zip(t16.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k
    got, want = (t.train_iteration(*batches[2]) for t in (b, t16))
    for name in STATS:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, err_msg=name)

    back = b.save_checkpoint("last")
    t16b = _pallas16_trainer(a)
    t16b.restore_checkpoint(back)
    assert t16b.opt.count == 3
    for (k, p), q in zip(b.model.state_dict().items(),
                         t16b.model.state_dict().values()):
        assert torch.equal(p, q), k
    assert torch.isfinite(t16b.train_iteration(*batches[3])["loss"])


def test_pallas16_fit_matches_pallas(tmp_path):
    """A short ``fit`` of both routes, with the schedule and tolerance of
    ``tests/test_torch_trainer.py``'s fit against the JAX package."""
    _, a = build_trainers("sum", save_dir=str(tmp_path / "pallas"))
    t16 = _pallas16_trainer(a, save_dir=str(tmp_path / "p16"))
    kw = dict(max_iter=8, log=lambda *_: None)
    for t in (a, t16):
        t.s.log_interval, t.s.valid_interval, t.s.scan_steps = 2, 4, 2
    want, got = a.fit(**kw), t16.fit(**kw)
    assert got["best_iter"] == want["best_iter"]
    np.testing.assert_allclose(got["best_valid_rmse"],
                               want["best_valid_rmse"], rtol=1e-3)
    np.testing.assert_allclose(got["best_test_rmse"],
                               want["best_test_rmse"], rtol=1e-3)
    assert (tmp_path / "p16" / "ckpt_best_0.pt").exists()


def test_pallas16_export_and_queries_match_pallas(tmp_path, monkeypatch):
    """``export_serving`` through a ``pallas16`` ``Trainer`` and a
    ``pallas16`` ``ServingState``: the export's four aggregations run on the
    16-bit route and give the ``pallas`` export; the ``.npz`` artifact does
    not depend on the layout."""
    _, ttrainer = build_trainers("sum")
    t16 = _pallas16_trainer(ttrainer)
    want = tserve.export_serving(ttrainer, segment="test")
    calls = _counting(monkeypatch)
    got = tserve.export_serving(t16, segment="test")
    assert calls["bit_expand_matmul16"] == 4 and calls["bit_reduce_matmul16"] \
        == calls["bit_expand_matmul"] == calls["bit_reduce_matmul"] == 0
    state = tserve.ServingState(
        t16.model_cfg, t16.data_iter, device="cpu",
        state_dict=ttrainer.model.state_dict())
    from_state = tserve.export_serving(state, segment="test")
    for art in (got, from_state):
        for k in ("user_feats", "item_feats"):
            np.testing.assert_allclose(getattr(art, k), getattr(want, k),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(art.rated_items, want.rated_items)
    path = str(tmp_path / "p16.npz")
    got.save(path)
    loaded = tserve.ServingArtifact.load(path)
    np.testing.assert_array_equal(loaded.user_feats, got.user_feats)
    users = np.array([0, 3, 7])
    items = np.array([1, 2, 5])
    served = tserve.Predictor(loaded, device="cpu")
    np.testing.assert_allclose(
        served.predict(users, items),
        tserve.Predictor(want, device="cpu").predict(users, items), rtol=1e-5)
    top = served.recommend(users, k=3)
    assert np.asarray(top[0]).shape == (3, 3)


def test_train_cli_runs_a_pallas16_yaml(tmp_path, monkeypatch):
    """``python -m stargcn_tpu_torch.train`` with a YAML that sets
    ``KERNEL.BIT_IMPL: pallas16`` trains on the 16-bit route only, and
    ``python -m stargcn_tpu_torch.predict`` serves its checkpoint."""
    import json
    import logging

    import yaml

    from stargcn_tpu_torch import predict
    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "small16.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "KERNEL": {"BIT_IMPL": "pallas16"},
        "TRAIN": {"RATING_BATCH_SIZE": 2000, "LOG_INTERVAL": 5,
                  "VALID_INTERVAL": 10}}))
    save_dir = tmp_path / "runs"
    calls = _counting(monkeypatch)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    common = ["--cfg", str(cfg_path), "--backend", "bitdense", "--device",
              "cpu"]
    try:
        result = train_cli.main(common + ["--save_dir", str(save_dir),
                                          "--max_iter", "10", "--silent"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 10 and np.isfinite(result["best_valid_rmse"])
    assert calls["bit_expand_matmul"] == calls["bit_reduce_matmul"] == 0
    assert calls["bit_reduce_matmul16"] == 40
    assert calls["bit_expand_matmul16"] >= 40 + 4
    assert "BIT_IMPL: pallas16" in (save_dir / "cfg0.yml").read_text()

    import sys
    from io import StringIO

    out = StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    predict.main(common + ["--resume", str(save_dir / "ckpt_best_0.pt"),
                           "--users", "1", "--topk", "3", "--pairs", "1:2"])
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0]["mode"] == "predict" and len(lines[1]["items"]) == 3
    assert calls["bit_expand_matmul"] == 0


def test_pallas16_is_refused_without_its_packs():
    """The layout and the route always agree: a model config that names
    ``pallas16`` refuses natural packs."""
    _, ttrainer = build_trainers("sum")
    cfg = dataclasses.replace(ttrainer.model_cfg, bit_impl="pallas16")
    from stargcn_tpu_torch.models.stargcn import _build_bit_static_operands

    with pytest.raises(ValueError, match="row_interleave"):
        _build_bit_static_operands(cfg, ttrainer.variants.bit_pack("train"),
                                   *ttrainer.variants.degrees("train"))
