"""The port's chunked-ELL backend (``stargcn_tpu_torch/ops/chunked_ell.py``,
``KERNEL.BACKEND: ell``) against the JAX package's, on the CPU.

* ``build_chunked_ell`` / ``build_ell_pack``: the JAX package's arrays,
  array for array, with and without a mask, at K = 4 and 64, with
  ``row_pad`` padding;
* ``ell_pool_rated``: forward and input gradient against ``jax.vjp`` of the
  JAX function within 1e-5 (float32; other summation orders), with all
  rows in one gather and in chunks smaller than V;
* ``ell_multi_link_aggregate`` with the removed-edge correction, ordinal
  sharing, ``stack`` / ``sum`` within 1e-5, and with ``ELL_BF16``: both
  packages round the same float32 operand to bf16 and round the pooled
  result to bf16 once more, where a value on a boundary may land on the
  other neighbour (one bf16 ulp, 2^-8 of it), so the forward is held at
  4e-3 of its largest entry; the JAX package's bf16 backward sums in bf16
  and the port's in float32, so gradients are held at 3e-2 of their
  largest entry (ROADMAP Queue 3's bound for bf16 gradients);
* the ``STARGCN`` forward on ``ell`` against the JAX package's (2e-4, as
  ``tests/test_torch_dense_xla.py`` holds ``xla``), one training step's
  loss and every gradient against the JAX package's ``ell`` step and the
  port's own ``xla`` step (the float32 tolerance of
  ``tests/test_torch_dense_xla.py``: 1e-4 of each
  parameter's largest entry), five steps, evaluation and the export;
* ``fit``, ``export_serving`` and ``Predictor`` on ``ell``, and the train
  CLI with ``--backend ell``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (ROOT, build_port_trainer, build_trainers,
                          host_batches)
from stargcn_tpu import serve as jserve
from stargcn_tpu.models.layers import EllStatic as JEllStatic
from stargcn_tpu.ops import chunked_ell as jell
from stargcn_tpu_torch import convert
from stargcn_tpu_torch import serve as tserve
from stargcn_tpu_torch.graph.device import EdgeSet
from stargcn_tpu_torch.models.layers import EllStatic
from stargcn_tpu_torch.ops import chunked_ell as tell
from stargcn_tpu_torch.train import __main__ as train_cli

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.array(a))


def _edges(seed=0, E=3000, ns=120, nd=90, R=5):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, ns, E), rng.randint(0, nd, E),
            rng.randint(0, R, E), (rng.rand(E) > 0.3).astype(np.float32),
            ns, nd, R)


@pytest.mark.parametrize("K,row_pad,masked", [
    (4, 8, False), (4, 8, True), (64, 8, False), (64, 8, True),
    (4, 48, True)])
def test_pack_arrays_match_jax(K, row_pad, masked):
    src, dst, rat, mask, ns, nd, _ = _edges()
    m = mask if masked else None
    want = jell.build_chunked_ell(src, dst, rat, ns, nd, K=K,
                                  row_pad=row_pad, mask=m)
    got = tell.build_chunked_ell(src, dst, rat, ns, nd, K=K,
                                 row_pad=row_pad, mask=m, device="cpu")
    for f in ("src_idx", "rating", "row_dst"):
        g = getattr(got, f)
        assert g.dtype == torch.int32, f
        np.testing.assert_array_equal(g.numpy(), getattr(want, f),
                                      err_msg=f)
    assert got.src_idx.shape[0] % row_pad == 0
    assert (got.num_src, got.num_dst, got.num_real_edges) == (
        want.num_src, want.num_dst, want.num_real_edges)


@pytest.mark.parametrize("K", [4, 64])
def test_build_ell_pack_matches_jax(K):
    eu, ei, er, mask, nu, ni, _ = _edges(seed=1)
    want = jell.build_ell_pack(eu, ei, er, mask, nu, ni, K=K)
    got = tell.build_ell_pack(eu, ei, er, mask, nu, ni, K=K, device="cpu")
    for side in ("user", "item"):
        for key in ("idx", "rat", "row"):
            np.testing.assert_array_equal(
                got[side][key].numpy(), np.asarray(want[side][key]),
                err_msg=f"{side} {key}")
    assert tell.pack_bytes(got) == sum(
        np.asarray(a).nbytes for d in want.values() for a in d.values())


def _pool_case(seed=2, F=7):
    """Forward and transpose arrays of one random graph, a padded x and a
    cotangent."""
    src, dst, rat, mask, ns, nd, R = _edges(seed)
    f = jell.build_chunked_ell(src, dst, rat, ns, nd, K=8, mask=mask)
    b = jell.build_chunked_ell(dst, src, rat, nd, ns, K=8, mask=mask)
    rng = np.random.RandomState(seed + 10)
    x = rng.randn(ns + 1, F).astype(np.float32)
    x[-1] = 0.0
    g = rng.randn(nd, R, F).astype(np.float32)
    return f, b, x, g, ns, nd, R


@pytest.mark.parametrize("chunk", [None, 16])
def test_pool_rated_matches_jax_vjp(chunk):
    f, b, x, g, ns, nd, R = _pool_case()
    assert chunk is None or chunk < f.src_idx.shape[0]
    arrays = (f.src_idx, f.rating, f.row_dst, b.src_idx, b.rating,
              b.row_dst)
    want, vjp = jax.vjp(lambda xp: jell.ell_pool_rated(
        xp, *map(jnp.asarray, arrays), nd, ns, R, chunk), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    got = tell.ell_pool_rated(xt, *map(t, arrays), nd, ns, R, chunk)
    (dx,) = torch.autograd.grad(got, xt, t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-5)
    assert not dx[-1].any()
    np.testing.assert_allclose(
        got.detach().numpy(),
        jell.ref_pool_rated(x[:-1], f, R), rtol=1e-5, atol=1e-5)


def _statics(removal, bf16, chunk=16, seed=3):
    """The same ``EllStatic`` operands in both packages for the user
    direction of a random graph, with optional removed batch edges."""
    eu, ei, er, mask, nu, ni, R = _edges(seed, E=2500, ns=100, nd=80)
    pack = jell.build_ell_pack(eu, ei, er, mask, nu, ni, K=8)
    rng = np.random.RandomState(seed)
    dst_scale = rng.rand(nu).astype(np.float32)
    src_scale = rng.rand(ni).astype(np.float32)
    rem = [None] * 4
    if removal:
        B = 40
        rem = [rng.randint(0, ni, B), rng.randint(0, nu, B),
               rng.randint(0, R, B), (rng.rand(B) > 0.2).astype(np.float32)]
    p, q = pack["user"], pack["item"]
    common = dict(f_idx=p["idx"], f_rat=p["rat"], f_row=p["row"],
                  b_idx=q["idx"], b_rat=q["rat"], b_row=q["row"],
                  dst_scale=dst_scale, src_scale=src_scale,
                  rem_src=rem[0], rem_dst=rem[1], rem_rating=rem[2],
                  rem_weight=rem[3], chunk=chunk, bf16=bf16)
    to_j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                or hasattr(v, "shape") else v) for k, v in common.items()}
    to_t = {k: (t(np.asarray(v)) if isinstance(v, np.ndarray)
                or hasattr(v, "shape") else v) for k, v in common.items()}
    return JEllStatic(**to_j), EllStatic(**to_t), ni, R


@pytest.mark.parametrize("removal,ordinal,accum,bf16", [
    (False, False, "stack", False), (True, False, "sum", False),
    (True, True, "stack", False), (True, True, "sum", True),
    (False, False, "stack", True)])
def test_multi_link_aggregate_matches_jax(removal, ordinal, accum, bf16):
    jes, tes, ni, R = _statics(removal, bf16)
    rng = np.random.RandomState(4)
    F, U = 6, 5
    x = rng.randn(ni, F).astype(np.float32)
    w = (rng.randn(R, F, U) / 3).astype(np.float32)
    bias = (rng.randn(R, U) / 10).astype(np.float32)

    def jfun(x, w, b):
        return jell.ell_multi_link_aggregate(x, jes, w, b, ordinal, accum)

    want, vjp = jax.vjp(jfun, *map(jnp.asarray, (x, w, bias)))
    g = rng.randn(*want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(g))
    inputs = [t(a).requires_grad_() for a in (x, w, bias)]
    got = tell.ell_multi_link_aggregate(*inputs[:1], tes, *inputs[1:],
                                        ordinal_sharing=ordinal, accum=accum)
    grads = torch.autograd.grad(got, inputs, t(g))
    tol_fwd, tol_grad = (4e-3, 3e-2) if bf16 else (1e-5, 1e-5)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol_fwd * np.abs(want).max() + 1e-6)
    for name, got_g, want_g in zip(("x", "weight", "bias"), grads, wgrads):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(
            got_g.numpy(), want_g, rtol=0,
            atol=tol_grad * np.abs(want_g).max() + 1e-6, err_msg=name)


# ------------------------------ the model ------------------------------


ELL = {"KERNEL.BACKEND": "ell", "KERNEL.ELL_K": 4, "KERNEL.ELL_CHUNK": 32}


def _trainers(accum="sum", **overrides):
    jtrainer, ttrainer = build_trainers(accum, **{**ELL, **overrides})
    assert jtrainer.model_cfg.backend == ttrainer.model_cfg.backend == "ell"
    return jtrainer, ttrainer


def _jax_forward(jtrainer, params, segment, pu, pi, noise, train=False,
                 removed=None):
    g = jtrainer.graph_data
    return jtrainer.model.apply(
        {"params": params}, g, jtrainer.edge_masks[segment],
        jnp.asarray(noise[0]), jnp.asarray(noise[1]), jnp.asarray(pu),
        jnp.asarray(pi), variant_degrees=jtrainer.variant_degrees[segment],
        ell_pack=jtrainer._ell_pack(segment), removed_pairs=removed,
        train=train, rngs={"dropout": jax.random.PRNGKey(0)},
        return_rating_feats=not train)


def test_forward_matches_jax():
    """The eval-mode forward on the test variant (``stack``, ``valid`` and
    the other options are held in the step test below)."""
    segment = "test"
    jtrainer, ttrainer = _trainers()
    v = ttrainer.variants
    rng = np.random.RandomState(5)
    pu = rng.randint(0, 40, 64)
    pi = rng.randint(0, 30, 64)
    nz = jtrainer.data_iter.evaluate_embed_noise_dict
    noise = (nz["user"], nz["movie"])
    want = _jax_forward(jtrainer, jtrainer.params, segment, pu, pi, noise)
    with torch.no_grad():
        got = ttrainer.model(t(noise[0]), t(noise[1]), t(pu), t(pi),
                             v.degrees(segment), v.operands(segment, "ell"),
                             return_rating_feats=True)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               np.asarray(want["pred_ratings"]), **tol)
    for key in ("user", "item"):
        np.testing.assert_allclose(got["rating_feats"][key].numpy(),
                                   np.asarray(want["rating_feats"][key]),
                                   **tol, err_msg=key)
    # the packs equal the JAX trainer's, and identical masks share one
    jpack = jtrainer._ell_pack(segment)
    for side in ("user", "item"):
        for key in ("idx", "rat", "row"):
            np.testing.assert_array_equal(
                v.ell_pack(segment)[side][key].numpy(),
                np.asarray(jpack[side][key]))
    assert v.ell_pack("valid") is v.ell_pack("train")
    assert v.ell_pack("test") is not v.ell_pack("train")


@pytest.mark.parametrize("accum,overrides", [
    ("sum", {}), ("stack", {"GCN.AGG.NORM_SYMM": False}),
    ("sum", {"GCN.AGG.ORDINAL_SHARING": True})])
def test_train_step_gradients_match_jax_and_xla(accum, overrides):
    """One training forward with the batch's edges removed and the
    gradient of every parameter for a random functional of its outputs,
    against the JAX package's ``ell``; then the port's ``loss_and_grads``
    on ``ell`` against its own ``xla`` on the same batch."""
    jtrainer, ttrainer = _trainers(accum, **overrides)
    batch = host_batches(jtrainer, 1)[0]
    ints, flts, noise, _ = jtrainer._prep_host_arrays(*batch)
    assert jtrainer.do_remove and flts[2].sum() > 0
    nu, B = 40, ints.shape[1]
    rng = np.random.RandomState(9)
    w = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("r", (2, B)), ("u0", (nu, 8)), ("i0", (30, 8)), ("u1", (nu, 8)),
        ("i1", (30, 8)))}

    def scalar(out, xp):
        total = xp.sum(out["pred_ratings"] * xp.asarray(w["r"]))
        for b in range(2):
            for key, c in (("user", "u"), ("item", "i")):
                total = total + xp.sum(out["pred_embed"][b][key]
                                       * xp.asarray(w[f"{c}{b}"]))
        return total

    removed = tuple(jnp.asarray(a) for a in (ints[0], ints[1], flts[2],
                                             ints[2]))
    jgrads = jax.grad(lambda p: scalar(_jax_forward(
        jtrainer, p, "train", ints[0], ints[1], (noise[:nu], noise[nu:]),
        train=True, removed=removed), jnp))(jtrainer.params)
    pu, pi, rr = (t(ints[k]).long() for k in range(3))
    got = ttrainer.model(t(noise[:nu]), t(noise[nu:]), pu, pi,
                         ttrainer.variants.degrees("train"),
                         ttrainer._operands("train"),
                         (pu, pi, t(flts[2]), rr), train=True,
                         generator=torch.Generator().manual_seed(0))
    names, params = zip(*ttrainer.model.named_parameters())
    tgrads = dict(zip(names, torch.autograd.grad(scalar(got, torch),
                                                 params)))
    wgrads = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(wgrads) == sorted(tgrads)
    for k, wg in wgrads.items():
        wg = wg.numpy()
        assert np.abs(wg).max() > 0, k
        np.testing.assert_allclose(tgrads[k].numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max(), err_msg=k)

    # the port's ell step against its own xla step on the same batch
    xla = dataclasses.replace(ttrainer.model_cfg, backend="xla")
    twin = type(ttrainer)(xla, ttrainer.data_iter, ttrainer.s, device="cpu")
    twin.model.load_state_dict(ttrainer.model.state_dict())
    e_stats, e_grads = ttrainer.loss_and_grads(*batch)
    x_stats, x_grads = twin.loss_and_grads(*batch)
    for name in ("loss", "rating_loss", "recon_loss", "sq_err"):
        np.testing.assert_allclose(e_stats[name].numpy(),
                                   x_stats[name].numpy(), rtol=1e-4,
                                   err_msg=name)
    for k, xg in x_grads.items():
        xg = xg.numpy()
        np.testing.assert_allclose(e_grads[k].numpy(), xg, rtol=0,
                                   atol=1e-4 * np.abs(xg).max() + 1e-12,
                                   err_msg=k)


def test_five_steps_evaluate_and_export_match_jax():
    jtrainer, ttrainer = _trainers()
    jstats, tstats = [], []
    for rb, cb in host_batches(jtrainer, 5):
        jstats.append(jax.device_get(jtrainer.train_iteration(rb, cb)))
        tstats.append({k: v.numpy() for k, v in
                       ttrainer.train_iteration(rb, cb).items()})
    for name in STATS:
        np.testing.assert_allclose(tstats[0][name], jstats[0][name],
                                   rtol=1e-4, atol=0, err_msg=name)
    want = convert.params_from_flax(jax.device_get(jtrainer.params))
    got = ttrainer.model.state_dict()
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    np.testing.assert_allclose(ttrainer.evaluate("test"),
                               jtrainer.evaluate("test"), rtol=2e-4)
    art = tserve.export_serving(ttrainer, segment="test")
    jart = jserve.export_serving(jtrainer, segment="test")
    for a, b in ((art.user_feats, jart.user_feats),
                 (art.item_feats, jart.item_feats)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_fit_export_and_queries(tmp_path):
    """``fit`` on ``ell`` writes its checkpoints and logs; the export of a
    ``ServingState`` on the fitted parameters equals the trainer's, and the
    ``Predictor`` answers from it; the model refuses an ``EdgeSet``."""
    ttrainer = build_port_trainer(save_dir=str(tmp_path), **{
        **ELL, "TRAIN.SCAN_STEPS": 1, "TRAIN.VALID_INTERVAL": 5,
        "TRAIN.LOG_INTERVAL": 5})
    assert ttrainer.model_cfg.backend == "ell"
    out = ttrainer.fit(max_iter=10, log=lambda *_: None)
    assert out["best_iter"] in (5, 10)
    assert (tmp_path / "ckpt_best_0.pt").exists()
    art = tserve.export_serving(ttrainer, segment="test")
    state = tserve.ServingState(ttrainer.model_cfg, ttrainer.data_iter,
                                device="cpu",
                                state_dict=ttrainer.model.state_dict())
    again = tserve.export_serving(state, segment="test")
    np.testing.assert_allclose(again.user_feats, art.user_feats, rtol=1e-6,
                               atol=1e-6)
    pred = tserve.Predictor(art, device="cpu")
    idx, vals = pred.recommend(np.arange(5), k=3)
    assert idx.shape == (5, 3) and np.isfinite(vals).all()
    r = pred.predict(np.array([0, 1]), np.array([2, 3]))
    assert np.isfinite(r).all()
    v = ttrainer.variants
    pu = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="ell backend reads its chunked-ELL packs"):
        ttrainer.model(None, None, pu, pu, v.degrees("test"),
                       EdgeSet(v.graph_data, v.device_mask("test")))


def test_train_cli_backend_ell(tmp_path, capsys):
    cfg = f"{ROOT}/configs/transductive_ml_100k.yml"
    result = train_cli.main([
        "--cfg", cfg, "--dataset", "synthetic", "--backend", "ell",
        "--save_dir", str(tmp_path), "--max_iter", "2", "--device", "cpu",
        "--silent"])
    assert result["best_iter"] == -1
    assert (tmp_path / "ckpt_last_0.pt").exists()
    from stargcn_tpu_torch import predict

    predict.main(["--cfg", cfg, "--dataset", "synthetic", "--backend",
                  "ell", "--device", "cpu", "--resume",
                  str(tmp_path / "ckpt_last_0.pt"), "--pairs", "1:2"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["mode"] == "predict" and len(line["ratings"]) == 1
