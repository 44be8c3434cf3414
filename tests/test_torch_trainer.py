"""The port's trainer against the JAX package's, on the CPU with dropout 0
and the same host-fed batches (the two packages draw different dropout
masks from the same seed).

Tolerances: one step's statistics 1e-4 relative (float32, other summation
orders through four aggregation layers and their backward); after five
steps 1e-3 of each parameter tensor's largest entry and 1e-3 on the loss:
Adam divides by the root of the second moment, which amplifies rounding
where a gradient is near zero.
"""

import csv
import os

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_slice import build_trainers, host_batches
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.train.loop import ClipAdam

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


def _params_close(jtrainer, ttrainer, rel):
    want = convert.params_from_flax(jax.device_get(jtrainer.params))
    got = ttrainer.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def five_steps():
    """Both trainers after five steps on the same batches, with each
    step's statistics."""
    jtrainer, ttrainer = build_trainers("sum")
    batches = host_batches(jtrainer, 5)
    jstats, tstats = [], []
    for rb, cb in batches:
        jstats.append(jax.device_get(jtrainer.train_iteration(rb, cb)))
        tstats.append({k: v.numpy() for k, v in
                       ttrainer.train_iteration(rb, cb).items()})
    return jtrainer, ttrainer, jstats, tstats


def test_first_step_stats_match_jax(five_steps):
    _, ttrainer, jstats, tstats = five_steps
    assert ttrainer.do_remove
    for name in STATS:
        np.testing.assert_allclose(tstats[0][name], jstats[0][name],
                                   rtol=1e-4, atol=0, err_msg=name)
    assert tstats[0]["rating_loss"].shape == (2,)


def test_five_steps_match_jax(five_steps):
    jtrainer, ttrainer, jstats, tstats = five_steps
    np.testing.assert_allclose([s["loss"] for s in tstats],
                               [s["loss"] for s in jstats], rtol=1e-3)
    _params_close(jtrainer, ttrainer, 1e-3)
    assert ttrainer.opt.count == 5


@pytest.mark.parametrize("accum,overrides", [
    ("stack", {}),
    ("sum", {"MODEL.REMOVE_RATING": False}),
    ("sum", {"GCN.AGG.ORDINAL_SHARING": True, "TRAIN.WD": 0.01}),
])
def test_step_variants_match_jax(accum, overrides):
    jtrainer, ttrainer = build_trainers(accum, **overrides)
    for rb, cb in host_batches(jtrainer, 2):
        want = jax.device_get(jtrainer.train_iteration(rb, cb))
        got = ttrainer.train_iteration(rb, cb)
        for name in STATS:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=1e-4, atol=0, err_msg=name)
    _params_close(jtrainer, ttrainer, 1e-3)


def test_train_chunk_equals_single_steps():
    """k steps in one ``train_chunk`` are k ``train_iteration``s, dropout
    stream included (dropout is on here)."""
    _, a = build_trainers("sum", **{"GCN.DROPOUT": 0.3})
    _, b = build_trainers("sum", **{"GCN.DROPOUT": 0.3})
    batches = host_batches(a, 3)
    singles = [a.train_iteration(rb, cb) for rb, cb in batches]
    chunk = b.train_chunk([x[0] for x in batches], [x[1] for x in batches])
    for name in STATS:
        assert torch.equal(chunk[name],
                           torch.stack([s[name] for s in singles])), name
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k
    # Dropout did act: another stream gives another loss.
    _, c = build_trainers("sum", **{"GCN.DROPOUT": 0.3})
    c.seed_dropout(7)
    assert not torch.equal(c.train_iteration(*batches[0])["loss"],
                           singles[0]["loss"])


@pytest.mark.parametrize("segment", ["valid", "test"])
def test_evaluate_and_predict_match_jax(five_steps, segment):
    jtrainer, ttrainer, _, _ = five_steps
    np.testing.assert_allclose(ttrainer.evaluate(segment),
                               jtrainer.evaluate(segment), rtol=2e-4)
    rng = np.random.RandomState(3)
    uu = rng.randint(0, 40, 50).astype(np.int32)
    ii = rng.randint(0, 30, 50).astype(np.int32)
    np.testing.assert_allclose(ttrainer.predict(uu, ii, segment=segment),
                               jtrainer.predict(uu, ii, segment=segment),
                               rtol=2e-4, atol=2e-4)


def _optax_chain(lr, clip, wd):
    parts = [optax.clip_by_global_norm(clip), optax.scale_by_adam()]
    if wd:
        parts.append(optax.add_decayed_weights(wd))
    parts.append(optax.scale(-lr))
    return optax.chain(*parts)


@pytest.mark.parametrize("scale,wd", [
    (0.1, 0.0),      # norm under the threshold: gradients unchanged
    (1.0, 0.0),      # norm exactly at the threshold
    (25.0, 0.0),     # over: scaled to the threshold
    (25.0, 0.05),    # with decoupled weight decay
])
def test_clip_adam_matches_optax_chain(scale, wd):
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    clip = 2.0
    opt = _optax_chain(0.01, clip, wd)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = ClipAdam(tp, lr=0.01, grad_clip=clip, wd=wd)
    for step in range(3):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                           for v in g.values()))
        g = {k: (v * (scale * clip / norm)).astype(np.float32)
             for k, v in g.items()}
        upd, jstate = opt.update({k: jax.numpy.asarray(v)
                                  for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = topt.step({k: torch.tensor(v) for k, v in g.items()})
        np.testing.assert_allclose(float(gnorm), scale * clip, rtol=1e-5)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} step {step}")


def test_set_lr_keeps_moments(five_steps):
    _, ttrainer, _, _ = five_steps
    mu = {k: v.clone() for k, v in ttrainer.opt.mu.items()}
    count = ttrainer.opt.count
    ttrainer.set_lr(0.0005)
    assert ttrainer.lr == ttrainer.opt.lr == 0.0005
    assert ttrainer.opt.count == count
    for k, v in mu.items():
        assert torch.equal(ttrainer.opt.mu[k], v), k
    ttrainer.set_lr(ttrainer.s.lr)


def _adam_state(jtrainer):
    inner = jtrainer.opt_state.inner_state
    adam = next(s for s in inner if hasattr(s, "mu"))
    return (int(adam.count), jax.device_get(adam.mu), jax.device_get(adam.nu))


def test_optimizer_state_carried_from_optax():
    """Start the port's trainer mid-run from the JAX trainer's parameters
    and Adam state: the next step is the same."""
    jtrainer, ttrainer = build_trainers("sum")
    batches = host_batches(jtrainer, 4)
    for rb, cb in batches[:3]:
        jtrainer.train_iteration(rb, cb)
    count, mu, nu = _adam_state(jtrainer)
    assert count == 3
    ttrainer.model.load_state_dict(
        convert.params_from_flax(jax.device_get(jtrainer.params)))
    state = convert.optimizer_state_from_optax(count, mu, nu)
    ttrainer.opt.load_state_dict(state)
    want = jax.device_get(jtrainer.train_iteration(*batches[3]))
    got = ttrainer.train_iteration(*batches[3])
    for name in STATS:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4,
                                   err_msg=name)
    _params_close(jtrainer, ttrainer, 1e-3)
    # and back: numpy trees in the flax layout
    c2, mu2, _ = convert.optimizer_state_to_optax(state)
    assert c2 == 3
    np.testing.assert_array_equal(
        mu2["rating_user_proj_b0"]["kernel"],
        np.asarray(mu["rating_user_proj_b0"]["kernel"]))


def test_checkpoint_round_trip(tmp_path):
    _, a = build_trainers("sum", save_dir=str(tmp_path))
    batches = host_batches(a, 3)
    a.train_iteration(*batches[0])
    a.train_iteration(*batches[1])
    a.set_lr(0.001)
    path = a.save_checkpoint("last")
    assert path.endswith("ckpt_last_0.pt") and os.path.exists(path)
    assert os.path.exists(path + ".meta.json")
    assert not os.path.exists(path + ".tmp")
    want = a.train_iteration(*batches[2])

    _, b = build_trainers("sum")
    b.restore_checkpoint(path)
    assert b.lr == b.opt.lr == 0.001 and b.opt.count == 2
    got = b.train_iteration(*batches[2])
    for name in STATS:
        assert torch.equal(got[name], want[name]), name
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k
    # a checkpoint of another model is refused
    _, c = build_trainers("stack")
    with pytest.raises((ValueError, RuntimeError)):
        c.restore_checkpoint(path)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_fit_writes_what_the_jax_fit_writes(tmp_path):
    """A short ``fit`` in both packages from the same parameters, sampler
    seed and schedule: the same CSV files with the same columns and
    iterations, values to the tolerance of the module docstring, and the
    same summary dict."""
    over = {"TRAIN.LOG_INTERVAL": 2, "TRAIN.VALID_INTERVAL": 4,
            "TRAIN.SCAN_STEPS": 2}
    jtrainer, ttrainer = build_trainers("sum", save_dir=str(tmp_path),
                                        **over)
    jres = jtrainer.fit(max_iter=8, log=lambda *_: None)
    lines = []
    tres = ttrainer.fit(max_iter=8, log=lines.append)
    assert sorted(tres) == sorted(jres)
    assert tres["best_iter"] == jres["best_iter"]
    np.testing.assert_allclose(tres["best_valid_rmse"],
                               jres["best_valid_rmse"], rtol=1e-3)
    np.testing.assert_allclose(tres["best_test_rmse"],
                               jres["best_test_rmse"], rtol=1e-3)
    for name in ("train_loss0.csv", "valid_loss0.csv", "test_loss0.csv"):
        jrows = _read_csv(tmp_path / "jax" / name)
        trows = _read_csv(tmp_path / "torch" / name)
        assert trows[0] == jrows[0], name
        assert [r[0] for r in trows] == [r[0] for r in jrows], name
        np.testing.assert_allclose(
            np.array(trows[1:], float), np.array(jrows[1:], float),
            rtol=2e-3, atol=2e-4, err_msg=name)
    for tag in ("best", "last"):
        assert (tmp_path / "torch" / f"ckpt_{tag}_0.pt").exists()
    assert any(s.startswith("Iter=4,") and "Val RMSE1=" in s for s in lines)
    assert lines[-1].startswith("Best Iter=")


def _scripted_evaluate(trainer, valid):
    """Replace ``evaluate`` by a script of valid RMSEs (test: constant)."""
    seq = iter(valid)

    def evaluate(segment="valid"):
        v = next(seq) if segment == "valid" else 1.0
        return np.array([v, v])

    trainer.evaluate = evaluate


def test_fit_schedule_decays_then_stops():
    """``DECAY_PATIENCE`` validations without improvement halve the LR (the
    counter restarts), down to ``MIN_LR``; then
    ``EARLY_STOPPING_PATIENCE`` more stop the run."""
    over = {"TRAIN.LOG_INTERVAL": 1, "TRAIN.VALID_INTERVAL": 1,
            "TRAIN.SCAN_STEPS": 1, "TRAIN.DECAY_PATIENCE": 1,
            "TRAIN.EARLY_STOPPING_PATIENCE": 2, "TRAIN.LR": 0.004,
            "TRAIN.MIN_LR": 0.001, "TRAIN.LR_DECAY_FACTOR": 0.5}
    _, t = build_trainers("sum", **over)
    _scripted_evaluate(t, [1.0] + [2.0] * 50)
    lines = []
    res = t.fit(max_iter=40, log=lines.append)
    changes = [s for s in lines if "Change the LR" in s]
    assert changes == ["\tChange the LR to 0.002", "\tChange the LR to 0.001"]
    assert t.lr == 0.001
    assert "Early stopping threshold reached." in lines
    assert res["best_iter"] == 1 and res["best_valid_rmse"] == 1.0
    # improvement at 1; worse at 2, 3 (decay), 4, 5 (decay), 6, 7, 8 (stop)
    assert t.opt.count == 8


def test_fit_nan_watchdog_restores_and_halves(tmp_path):
    """A non-finite loss at a log interval restores the best checkpoint,
    halves the LR and goes on; after ``MAX_NAN_RECOVERIES`` it stops."""
    over = {"TRAIN.LOG_INTERVAL": 1, "TRAIN.VALID_INTERVAL": 1,
            "TRAIN.SCAN_STEPS": 1, "TRAIN.LR": 0.004, "TRAIN.MIN_LR": 0.0005,
            "TRAIN.MAX_NAN_RECOVERIES": 2}
    _, t = build_trainers("sum", save_dir=str(tmp_path), **over)
    _scripted_evaluate(t, [1.0] * 50)
    real_step = t.train_iteration
    calls = {"n": 0, "finite_at_entry": []}

    def step(rb, cb):
        calls["n"] += 1
        calls["finite_at_entry"].append(
            bool(torch.isfinite(t.model.embed_user.weight).all()))
        stats = real_step(rb, cb)
        if calls["n"] >= 2:
            with torch.no_grad():
                t.model.embed_user.weight.fill_(float("nan"))
            stats["loss"] = torch.tensor(float("nan"))
        return stats

    t.train_iteration = step
    lines = []
    t.fit(max_iter=10, log=lines.append)
    assert sum("restoring best checkpoint" in s for s in lines) == 2
    assert any("2 recoveries already spent" in s for s in lines)
    assert calls["n"] == 4
    # each recovery restores the checkpoint's rate (0.004) and halves it,
    # as the JAX ``fit`` does
    assert t.lr == 0.002
    # every step after a recovery started from the restored parameters,
    # not the poisoned ones
    assert calls["finite_at_entry"] == [True] * 4


def test_trainer_refuses_what_is_not_ported():
    jtrainer, ttrainer = build_trainers("sum")
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(ttrainer.model_cfg, ttrainer.data_iter, ttrainer.s,
                device="cpu", mesh=object())
    s = TrainSettings(device_sampler=True)
    with pytest.raises(NotImplementedError, match="DEVICE_SAMPLER"):
        Trainer(ttrainer.model_cfg, ttrainer.data_iter, s, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(ttrainer.model_cfg, ttrainer.data_iter, ttrainer.s)


def test_train_and_predict_cli(tmp_path, capsys):
    """``python -m stargcn_tpu_torch.train`` on a small config writes the
    run's files and a ``result:`` line, and ``python -m
    stargcn_tpu_torch.predict --resume`` serves from its checkpoint."""
    import json
    import logging

    import yaml

    from stargcn_tpu_torch import predict
    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "small.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 2000, "LOG_INTERVAL": 5,
                  "VALID_INTERVAL": 10, "SCAN_STEPS": 5}}))
    save_dir = tmp_path / "runs"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    common = ["--cfg", str(cfg_path), "--backend", "bitdense", "--device",
              "cpu"]
    try:
        result = train_cli.main(common + ["--save_dir", str(save_dir),
                                          "--max_iter", "20", "--silent"])
        # a second run resumes from the first one's checkpoint
        again = train_cli.main(common + [
            "--save_dir", str(save_dir), "--max_iter", "10", "--silent",
            "--resume", str(save_dir / "ckpt_last_0.pt")])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] in (10, 20)
    assert np.isfinite(result["best_valid_rmse"])
    for name in ("cfg0.yml", "log0.log", "train_loss0.csv",
                 "valid_loss0.csv", "test_loss0.csv", "ckpt_best_0.pt",
                 "ckpt_last_0.pt", "cfg1.yml", "log1.log",
                 "train_loss1.csv"):
        assert (save_dir / name).exists(), name
    log_text = (save_dir / "log0.log").read_text()
    assert "result: {" in log_text and "Iter=20," in log_text
    rows = _read_csv(save_dir / "train_loss0.csv")
    assert rows[0][:3] == ["iter", "loss", "rmse0"]
    assert [r[0] for r in rows[1:]] == ["5", "10", "15", "20"]
    assert [r[0] for r in _read_csv(save_dir / "valid_loss0.csv")[1:]] == [
        "10", "20"]
    assert again["best_valid_rmse"] < 1.5 * result["best_valid_rmse"]

    capsys.readouterr()
    predict.main(common + ["--resume", str(save_dir / "ckpt_best_0.pt"),
                           "--users", "1,2", "--topk", "5", "--pairs",
                           "1:2"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0]["mode"] == "predict" and len(out[0]["ratings"]) == 1
    assert [o["user"] for o in out[1:]] == [1, 2]
    assert all(len(o["items"]) == 5 for o in out[1:])
    # the served parameters are the checkpoint's, not the seed's
    ckpt = torch.load(save_dir / "ckpt_best_0.pt", weights_only=True)
    assert set(ckpt) == {"params", "opt_state"}
    assert ckpt["opt_state"]["count"] == result["best_iter"]
