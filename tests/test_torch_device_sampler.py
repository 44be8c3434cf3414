"""``TRAIN.DEVICE_SAMPLER``: full-graph batches drawn on the device
(``Trainer.train_chunk_dev``), against the JAX package's
(``stargcn_tpu/train/loop.py:_device_sample_step_inputs``), on the CPU.

The port's draws come from its own generator, so they are held in
distribution; fed the JAX package's draws (the same key splits) the step
inputs are equal and one step equals the JAX ``train_chunk_dev`` step, at
the tolerances of ``tests/test_torch_dense_xla.py`` (statistics 1e-4
relative; parameters after the step 1e-3 of each tensor's largest entry,
1e-2 on ``dense``, whose bf16 rounding flips).  Also: the CLI's default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import build_trainers, small_ml10m_cfg
from stargcn_tpu.train import loop as jloop
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.train import loop as tloop
from stargcn_tpu_torch.train.__main__ import resolve_device_sampler
from stargcn_tpu_torch.utils import cfg_from_file

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")
PARAM_TOL = {"bitdense": 1e-3, "xla": 1e-3, "dense": 1e-2}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads (see ``tests/test_torch_dense_xla.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def jax_draws(jtrainer, key):
    """The draws of ``Trainer.draw_device_batch`` as the JAX package makes
    them from one step key (``_device_sample_step_inputs``)."""
    cfg = jtrainer.model_cfg
    k_idx, k_mu, k_zu, k_mi, k_zi, _ = jax.random.split(key, 6)
    n_train = jtrainer.data_iter.train_node_pairs.shape[1]
    draws = {"idx": jax.random.randint(k_idx, (jtrainer.train_batch_padded,),
                                       0, n_train)}
    for t, n, km, kz, i in (("user", cfg.num_users, k_mu, k_zu, 0),
                            ("item", cfg.num_items, k_mi, k_zi, 1)):
        draws[f"sel_{t}"] = jax.random.bernoulli(
            km, jtrainer._dev_pmask[i], (n,))
        draws[f"zero_{t}"] = jax.random.bernoulli(
            kz, jtrainer._dev_pzero[i], (n,))
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "idx"
            else torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


def test_draw_distribution():
    """Every drawn pair is a train edge with its rating; the batch covers
    the train edges; the recon mask tracks P_mask and the zeroed nodes are
    the selected ones (p_zero = 1) (mirrors ``tests/test_train.py``'s
    ``test_device_sampler_distribution``)."""
    _, tr = build_trainers("sum")
    tr._dev_pzero = (1.0, 1.0)       # every selected node is zeroed
    it = tr.data_iter
    p_mask = it.embed_P_mask["user"]
    edges = {tuple(p): r for p, r in zip(np.asarray(it.train_node_pairs).T,
                                         it.train_ratings)}
    arrays = tr.device_train_arrays()
    seen, fracs = set(), []
    for _ in range(40):
        ints, flts, noise, rmask = tloop._device_sample_step_inputs(
            tr, *arrays, tr.draw_device_batch())
        for (u, i, ri), (gt, valid, hit) in zip(ints.T.tolist(),
                                                flts.T.tolist()):
            assert edges[(u, i)] == gt and valid == hit == 1.0
            assert it.possible_rating_values[ri] == gt
        seen.update(map(tuple, ints[:2].T.tolist()))
        nu, mu = noise[:40].numpy(), rmask[:40].numpy()
        np.testing.assert_array_equal(nu == -1, mu > 0)
        np.testing.assert_array_equal(nu[mu == 0], np.nonzero(mu == 0)[0])
        fracs.append(mu.mean())
    assert len(seen) > 0.8 * len(edges)
    sd = np.sqrt(p_mask * (1 - p_mask) / (40 * 40))
    assert abs(np.mean(fracs) - p_mask) < 5 * sd


def test_drawn_batch_through_the_host_fed_step_is_the_same_step():
    """The inputs drawn on the device, fed as host batches to
    ``train_iteration``, give the same step as ``train_step_dev``."""
    _, a = build_trainers("sum")
    _, b = build_trainers("sum")
    for _ in range(2):
        draws = a.draw_device_batch()
        ints, flts, noise, rmask = tloop._device_sample_step_inputs(
            a, *a.device_train_arrays(), draws)
        nu = a.model_cfg.num_users
        rb = (ints[:2].numpy(), flts[0].numpy())
        cb = (noise[:nu].numpy(), noise[nu:].numpy(), rmask[:nu].numpy(),
              rmask[nu:].numpy())
        got = a.train_step_dev(draws)
        want = b.train_iteration(rb, cb)
        for name in STATS:
            assert torch.equal(got[name], want[name]), name
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


@pytest.mark.parametrize("backend", ["bitdense", "xla", "dense"])
def test_step_on_jax_draws_matches_jax(backend):
    """The JAX package's draws give equal step inputs, and one step equal
    to its ``train_chunk_dev`` step (dropout 0)."""
    jtr, ttr = build_trainers("sum", **{"KERNEL.BACKEND": backend})
    assert ttr.model_cfg.backend == backend and ttr.do_remove
    key0 = jax.random.PRNGKey(21)
    key = jax.random.split(key0)[1]        # the step key train_chunk_dev uses
    tp = jnp.asarray(np.asarray(jtr.data_iter.train_node_pairs, np.int32))
    trr = jnp.asarray(np.asarray(jtr.data_iter.train_ratings, np.float32))
    tri = jnp.asarray(np.searchsorted(
        np.asarray(jtr.data_iter.possible_rating_values),
        np.asarray(jtr.data_iter.train_ratings)).astype(np.int32))
    want = jloop._device_sample_step_inputs(jtr, tp, trr, tri, key)[:4]
    draws = jax_draws(jtr, key)
    got = tloop._device_sample_step_inputs(ttr, *ttr.device_train_arrays(),
                                           draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    jtr._rng_key = key0
    jstats = jax.device_get(jtr.train_chunk_dev(1))
    tstats = ttr.train_step_dev(draws)
    for name in STATS:
        np.testing.assert_allclose(tstats[name].numpy(),
                                   np.asarray(jstats[name])[0], rtol=1e-4,
                                   atol=0, err_msg=name)
    want_p = convert.params_from_flax(jax.device_get(jtr.params))
    for k, w in want_p.items():
        w = w.numpy()
        np.testing.assert_allclose(
            ttr.model.state_dict()[k].numpy(), w, rtol=0,
            atol=PARAM_TOL[backend] * np.abs(w).max(), err_msg=k)


def test_fit_with_the_device_sampler(tmp_path):
    """``fit`` with the sampler on trains, validates and checkpoints, and
    draws nothing from the host samplers' stream."""
    _, tr = build_trainers("sum", save_dir=str(tmp_path),
                           **{"TRAIN.DEVICE_SAMPLER": True,
                              "TRAIN.SCAN_STEPS": 3,
                              "TRAIN.LOG_INTERVAL": 3,
                              "TRAIN.VALID_INTERVAL": 6})
    assert tr.s.device_sampler
    state = tr.data_iter._rng.get_state()[1].copy()
    res = tr.fit(max_iter=6)
    assert np.isfinite(res["best_valid_rmse"]) and res["best_iter"] == 6
    assert tr.opt.count == 6
    np.testing.assert_array_equal(tr.data_iter._rng.get_state()[1], state)
    assert (tmp_path / "torch" / "ckpt_best_0.pt").exists()


def test_cli_default_resolution():
    """On for a full-graph run on the card with no mesh; off on the CPU, in
    sampled mode and on a mesh; either flag wins; a config that sets it
    keeps it."""
    def cfg(**over):
        c = small_ml10m_cfg(cfg_from_file)
        for k, v in over.items():
            node, leaf = k.split(".")
            c[node][leaf] = v
        return c

    assert resolve_device_sampler(cfg(), "cuda") is True
    assert resolve_device_sampler(cfg(), "cuda:0") is True
    assert resolve_device_sampler(cfg(), "cpu") is False
    sampled = cfg(**{"GRAPH_SAMPLER.NUM_NEIGHBORS": 8})
    assert resolve_device_sampler(sampled, "cuda") is False
    mesh = cfg(**{"PARALLEL.DATA_AXIS": 2})
    assert resolve_device_sampler(mesh, "cuda") is False
    assert resolve_device_sampler(cfg(), "cpu", True) is True
    assert resolve_device_sampler(cfg(), "cuda", False) is False
    assert resolve_device_sampler(
        cfg(**{"TRAIN.DEVICE_SAMPLER": True}), "cpu") is True


@pytest.mark.parametrize("args", [
    ["--device_sampler"],
    ["--num_neighbors", "4", "--backend", "xla", "--plan_device",
     "--prefetch"]])
def test_train_cli_flags(tmp_path, args):
    """The train CLI's ``--device_sampler`` (full-graph, forced on the CPU)
    and, in sampled mode, ``--plan_device`` with ``--prefetch``: the run
    trains and records the resolved ``TRAIN.DEVICE_SAMPLER``."""
    import logging

    import yaml

    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "small.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 256, "RECON_BATCH_SIZE": 64,
                  "LOG_INTERVAL": 2, "VALID_INTERVAL": 4,
                  "SCAN_STEPS": 2}}))
    save_dir = tmp_path / "runs"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main([
            "--cfg", str(cfg_path), "--device", "cpu", "--save_dir",
            str(save_dir), "--max_iter", "4", "--silent", *args])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 4 and np.isfinite(result["best_valid_rmse"])
    saved = yaml.safe_load((save_dir / "cfg0.yml").read_text())
    assert saved["TRAIN"]["DEVICE_SAMPLER"] is ("--device_sampler" in args)
