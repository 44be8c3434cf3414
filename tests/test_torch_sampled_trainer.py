"""The port's ``SampledTrainer`` against the JAX package's, on the CPU with
dropout 0, the loop planner (equal plans from equal seeds) and the same
batches.

Tolerances: one step's statistics 1e-4 relative (float32, other summation
orders through four aggregation layers and their backward); after five
steps 1e-3 of each parameter tensor's largest entry and 1e-3 on the loss:
Adam divides by the root of the second moment, which amplifies rounding
where a gradient is near zero.
"""

import csv
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from _torch_slice import (build_sampled_trainers, reference_on_cpu,
                          sampled_batches, sampled_cfgs, sampled_graphs,
                          sampled_iterator, seed_planners)
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.train import (SampledTrainer, Trainer, TrainSettings,
                                     resolve_sampled_backend, sampled_loop)

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


@pytest.fixture(autouse=True)
def numpy_reference():
    with reference_on_cpu():
        yield


def _params_close(jtrainer, ttrainer, rel):
    want = convert.params_from_flax(jax.device_get(jtrainer.params))
    got = ttrainer.model.state_dict()
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_five_steps_match_jax(backend):
    with reference_on_cpu():
        jtrainer, ttrainer = build_sampled_trainers(backend)
        assert ttrainer.do_remove and ttrainer.caps == jtrainer.caps
        assert ttrainer.recon_cap == jtrainer.recon_cap
        assert ttrainer.train_batch_pad == jtrainer.train_batch_pad == 32
        # the same plans, batches and noise go to both trainers
        batches = sampled_batches(jtrainer, 5)
        jstats, tstats = [], []
        for b in batches:
            jstats.append(jax.device_get(jtrainer.train_iteration(b)))
            tstats.append({k: v.numpy() for k, v in
                           ttrainer.train_iteration(b).items()})
    for name in STATS:
        np.testing.assert_allclose(tstats[0][name], jstats[0][name],
                                   rtol=1e-4, atol=0, err_msg=name)
    assert tstats[0]["rating_loss"].shape == (2,)
    np.testing.assert_allclose([s["loss"] for s in tstats],
                               [s["loss"] for s in jstats], rtol=1e-3)
    _params_close(jtrainer, ttrainer, 1e-3)
    assert ttrainer.opt.count == 5


def test_own_batches_equal_the_reference():
    """From equal seeds both trainers draw the same batches and build the
    same plans: the packed feeds are equal."""
    jtrainer, ttrainer = build_sampled_trainers("xla")
    seed_planners(13)
    jb = sampled_batches(jtrainer, 3)
    seed_planners(13)
    tb = sampled_batches(ttrainer, 3)
    for a, b in zip(jb, tb):
        ja, jf, jspec = jtrainer._pack_batch(a)
        ta, tf, tspec = ttrainer._pack_batch(b)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tf, jf)
        assert tspec[1] == jspec[1]
    for segment in ("valid", "test"):
        seed_planners(14)
        np.testing.assert_allclose(ttrainer.evaluate(segment),
                                   jtrainer.evaluate(segment), rtol=2e-4)


def test_train_chunk_equals_single_steps():
    """k steps in one ``train_chunk`` are k ``train_iteration``s, dropout
    stream included (dropout is on here)."""
    model = {"gcn_dropout": 0.3}
    _, a = build_sampled_trainers("pallas", model=model)
    _, b = build_sampled_trainers("pallas", model=model)
    batches = sampled_batches(a, 3)
    singles = [a.train_iteration(x) for x in batches]
    chunk = b.train_chunk(batches)
    for name in STATS:
        assert torch.equal(chunk[name],
                           torch.stack([s[name] for s in singles])), name
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k
    _, c = build_sampled_trainers("pallas", model=model)
    c.seed_dropout(7)
    assert not torch.equal(c.train_iteration(batches[0])["loss"],
                           singles[0]["loss"])
    # the step without the update
    _, d = build_sampled_trainers("pallas", model=model)
    stats, grads = sampled_loop._loss_and_grads(
        d, d._feed(d._pack_batch(batches[0])))
    assert torch.equal(stats["loss"], singles[0]["loss"])
    assert sorted(grads) == sorted(d.params) and d.opt.count == 0


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_fit_writes_what_the_jax_fit_writes(tmp_path):
    """A short ``fit`` in both packages from the same parameters, seeds and
    schedule: the same CSV files with the same columns and iterations,
    values to the tolerance of the module docstring, the same summary, and
    the checkpoints."""
    jtrainer, ttrainer = build_sampled_trainers(
        "xla", save_dir=str(tmp_path), log_interval=2, valid_interval=4,
        scan_steps=2)
    seed_planners(17)
    jres = jtrainer.fit(max_iter=8, log=lambda *_: None)
    seed_planners(17)
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
    assert any(s.startswith("Iter=4,") and "Val RMSE1=" in s for s in lines)
    assert lines[-1].startswith("Best Iter=")
    assert ttrainer.opt.count == 8

    # the checkpoints interchange with the full-graph Trainer
    best = tmp_path / "torch" / "ckpt_best_0.pt"
    last = tmp_path / "torch" / "ckpt_last_0.pt"
    assert best.exists() and last.exists()
    _, other = build_sampled_trainers("xla")
    other.restore_checkpoint(str(last))
    assert other.opt.count == 8 and other.lr == ttrainer.lr
    _, tg = sampled_graphs()
    full = Trainer(sampled_cfgs()[1], sampled_iterator(DataIterator, tg),
                   TrainSettings(rating_batch_size=24, seed=3), device="cpu")
    full.restore_checkpoint(str(last))
    assert full.opt.count == 8
    for (k, p), q in zip(ttrainer.model.state_dict().items(),
                         full.model.state_dict().values()):
        assert torch.equal(p, q), k
    # and back: a Trainer's checkpoint loads into the SampledTrainer
    full.save_dir = str(tmp_path / "full")
    other.restore_checkpoint(full.save_checkpoint("last"))


def test_seeded_parameters_equal_the_full_graph_trainers():
    _, tg = sampled_graphs()
    it = sampled_iterator(DataIterator, tg)
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8, seed=3)
    sampled = SampledTrainer(sampled_cfgs()[1], it, s, fanout=4,
                             device="cpu")
    full = Trainer(sampled_cfgs()[1], it, s, device="cpu")
    for (k, p), (k2, q) in zip(sampled.model.state_dict().items(),
                               full.model.state_dict().items()):
        assert k == k2 and torch.equal(p, q), k


def test_cap_overflow_recovery():
    """Caps that are too small grow on the way, in batch building, in a
    chunk whose earlier batches were planned under the old caps, and in
    evaluation; nothing raises."""
    _, tg = sampled_graphs()
    it = sampled_iterator(DataIterator, tg)
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8, seed=3)
    t = SampledTrainer(sampled_cfgs()[1], it, s, fanout=4, device="cpu",
                       frontier_caps={"user": 8, "item": 8})
    rs = it.rating_sampler(batch_size=24, segment="train")
    recon = it.recon_nodes_sampler(batch_size=8)
    first = t._build_batch_safe(rs, recon)
    grown = dict(t.caps)
    assert grown["user"] > 8 and grown["item"] > 8
    assert all(s.frontier_caps is t.caps for s in t.samplers.values())
    t._grow_caps({"user": 1000})
    assert t.caps["user"] == 1536 and t.caps["item"] == grown["item"]
    second = t._build_batch_safe(rs, recon)
    stats = t.train_chunk([first, second])      # first is planned again
    assert stats["loss"].shape == (2,) and torch.isfinite(stats["loss"]).all()
    t._grow_caps({"user": 10})                  # never shrinks
    assert t.caps["user"] == 1536
    t2 = SampledTrainer(sampled_cfgs()[1], it, s, fanout=4, device="cpu",
                        frontier_caps={"user": 8, "item": 8})
    assert np.isfinite(t2.evaluate("valid")).all() and t2.caps["user"] > 8


def test_fit_nan_recovery(tmp_path):
    """A non-finite loss at a log interval restores the best checkpoint
    and halves the LR, and the run goes on."""
    _, t = build_sampled_trainers("xla", save_dir=str(tmp_path),
                                  log_interval=1, valid_interval=1, lr=0.004,
                                  min_lr=0.0005)
    real = t.train_iteration
    calls = {"n": 0, "finite_at_entry": []}

    def step(batch):
        calls["n"] += 1
        calls["finite_at_entry"].append(
            bool(torch.isfinite(t.model.embed_user.weight).all()))
        stats = real(batch)
        if calls["n"] == 3:
            with torch.no_grad():
                t.model.embed_user.weight.fill_(float("nan"))
            stats["loss"] = torch.tensor(float("nan"))
        return stats

    t.train_iteration = step
    lines = []
    t.fit(max_iter=5, log=lines.append)
    assert sum("restoring best checkpoint" in s for s in lines) == 1
    assert calls["finite_at_entry"] == [True] * 5
    assert t.lr == 0.002


def test_resolve_sampled_backend_table():
    """The card's table (``PALLAS_WINDOWS``, measured by the crossover
    sweep on an H100), one window set a column; ``xla`` on the CPU and for
    training with ``plan_device``."""
    ml1m = {"user": 9984, "item": 6144}
    ml10m = {"user": 87040, "item": 17408}
    ml10m_k16 = {"user": 107264, "item": 17408}
    assert resolve_sampled_backend("pallas", ml10m, 8) == "pallas"
    assert resolve_sampled_backend("xla", ml1m, 8) == "xla"
    for training in (True, False):
        col = dict(for_training=training)
        # where the kernels won every run in both columns
        assert resolve_sampled_backend("auto", ml10m_k16, 16, **col,
                                       device="cuda:0") == "pallas"
        assert resolve_sampled_backend("auto", ml10m_k16, 32,
                                       **col) == "pallas"
        # ties and losses, and what was not measured, stay xla
        for caps, fanout in ((ml10m, 8), (ml1m, 16), (ml1m, 32),
                             (ml10m_k16, 64), ({"user": 32768,
                                                "item": 8192}, 16),
                             ({"user": 395776, "item": 74240}, 16)):
            assert resolve_sampled_backend("auto", caps, fanout,
                                           **col) == "xla"
        # the CPU is xla everywhere
        assert resolve_sampled_backend("auto", ml10m_k16, 16, **col,
                                       device="cpu") == "xla"
    # ML-1M at fanout 8: the forward won every run, the step not
    assert resolve_sampled_backend("auto", ml1m, 8,
                                   for_training=False) == "pallas"
    assert resolve_sampled_backend("auto", ml1m, 8) == "xla"
    # plan_device trains on xla; its forward-only evaluation keeps the table
    assert resolve_sampled_backend("auto", ml10m_k16, 16,
                                   plan_device=True) == "xla"
    assert resolve_sampled_backend("auto", ml10m_k16, 16, for_training=False,
                                   plan_device=True) == "pallas"
    # the trainer resolves both kinds
    _, tg = sampled_graphs()
    t = SampledTrainer(sampled_cfgs()[1], sampled_iterator(DataIterator, tg),
                       TrainSettings(rating_batch_size=24, recon_batch_size=8),
                       fanout=4, backend="auto", device="cpu")
    assert (t.backend, t.eval_backend) == ("xla", "xla")


def _adam_state(jtrainer):
    inner = jtrainer.opt_state.inner_state
    adam = next(s for s in inner if hasattr(s, "mu"))
    return (int(adam.count), jax.device_get(adam.mu), jax.device_get(adam.nu))


def test_parameters_and_optimizer_state_carried_from_the_jax_trainer():
    """``convert.params_from_flax`` and ``optimizer_state_from_optax`` serve
    the sampled trainer unchanged (the tree is the full-graph model's):
    start mid-run from the JAX trainer's state, and the next step is the
    same."""
    jtrainer, ttrainer = build_sampled_trainers("xla")
    batches = sampled_batches(jtrainer, 4)
    for b in batches[:3]:
        jtrainer.train_iteration(b)
    count, mu, nu = _adam_state(jtrainer)
    assert count == 3
    ttrainer.model.load_state_dict(
        convert.params_from_flax(jax.device_get(jtrainer.params)))
    ttrainer.opt.load_state_dict(
        convert.optimizer_state_from_optax(count, mu, nu))
    want = jax.device_get(jtrainer.train_iteration(batches[3]))
    got = ttrainer.train_iteration(batches[3])
    for name in STATS:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4,
                                   err_msg=name)
    _params_close(jtrainer, ttrainer, 1e-3)


def test_refuses_what_is_not_ported():
    _, tg = sampled_graphs()
    it = sampled_iterator(DataIterator, tg)
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8)
    cfg = sampled_cfgs()[1]
    # The mesh is ported (tests/test_torch_sampled_mesh*.py); it takes a
    # parallel.Mesh.
    with pytest.raises(TypeError, match="mesh"):
        SampledTrainer(cfg, it, s, fanout=4, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="plan_device"):
        SampledTrainer(cfg, it, s, fanout=4, device="cpu", plan_device=True,
                       backend="pallas")
    # remat is ported (tests/test_torch_sampled_options.py); feature-only
    # input with DAE reconstruction is refused, as the JAX package does.
    assert SampledTrainer(cfg, it, s, fanout=4, device="cpu",
                          remat=True).remat
    feature_only = dataclasses.replace(cfg, use_embed=False,
                                       use_fea_proj=True)
    with pytest.raises(NotImplementedError, match="USE_EMBED"):
        SampledTrainer(feature_only, it, s, fanout=4, device="cpu")
    with pytest.raises(ValueError, match="fanout"):
        SampledTrainer(cfg, it, s, fanout=-1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SampledTrainer(cfg, it, s, fanout=4)


def test_sampled_train_cli(tmp_path):
    """``python -m stargcn_tpu_torch.train --num_neighbors 4`` trains in
    sampled mode through the ELL pooling and writes the run's files."""
    import yaml

    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "small.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 256, "RECON_BATCH_SIZE": 64,
                  "LOG_INTERVAL": 2, "VALID_INTERVAL": 4,
                  "SCAN_STEPS": 2}}))
    save_dir = tmp_path / "runs"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main([
            "--cfg", str(cfg_path), "--num_neighbors", "4", "--backend",
            "pallas", "--device", "cpu", "--save_dir", str(save_dir),
            "--max_iter", "4", "--silent"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 4
    assert np.isfinite(result["best_valid_rmse"])
    for name in ("cfg0.yml", "log0.log", "train_loss0.csv",
                 "valid_loss0.csv", "test_loss0.csv", "ckpt_best_0.pt",
                 "ckpt_last_0.pt"):
        assert (save_dir / name).exists(), name
    log_text = (save_dir / "log0.log").read_text()
    assert "sampled frontier caps" in log_text and "result: {" in log_text
    assert [r[0] for r in _read_csv(save_dir / "train_loss0.csv")[1:]] == [
        "2", "4"]
