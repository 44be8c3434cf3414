"""The model options on the sampled path against the JAX package, on the
CPU: feature projection (with and without ``RECON_FEA``) in the sampled
forward, its loss and gradients, against the full-graph forward at fanout
-1 and in both ``SampledTrainer`` modes (host plans and ``plan_device``);
feature-only input; bf16 compute; ``remat`` against the port without it
(dropout 0.3, one generator state) and against the JAX package (dropout 0:
the JAX package draws its remat masks in another key order); the train CLI
with ``--remat`` and a YAML with feature projection and bf16.

Tolerances as in ``tests/test_torch_sampled.py`` (outputs 2e-4, gradients
1e-4 of each parameter's largest entry) and, for bf16, as in
``tests/test_torch_model_options.py`` (predictions 3e-2, reconstructed
embeddings 5e-2, the port's predictions within 5% of the scale of its own
float32 ones).  ``remat`` against the port without it: the same loss and
the same gradients to float32 rounding (1e-6 of each parameter's largest
entry: the same operations run again, in the same order).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (build_sampled_trainers, random_params,
                          reference_on_cpu, sampled_batches, sampled_cfgs,
                          sampled_graphs, sampled_iterator, seed_planners)
from stargcn_tpu.graph.device import BipartiteGraphData
from stargcn_tpu.graph.sampling import BlockSampler as JBlockSampler
from stargcn_tpu.models import STARGCN as JSTARGCN
from stargcn_tpu.models import sampled as jsm
from stargcn_tpu.train import sampled_loop as jsl
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.graph.sampling import BlockSampler
from stargcn_tpu_torch.models import STARGCN
from stargcn_tpu_torch.models import sampled as tsm
from stargcn_tpu_torch.models.stargcn import feature_dims
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
from stargcn_tpu_torch.train import sampled_loop as tsl
from stargcn_tpu_torch.train.loop import GraphVariants, graph_features

OUT_TOL = dict(rtol=2e-4, atol=2e-4)
FEA = dict(use_fea_proj=True, fea_mid_map=6, fea_units=5)
STATS = ("loss", "rating_loss", "recon_loss", "sq_err")


@pytest.fixture(autouse=True)
def numpy_reference():
    with reference_on_cpu():
        yield


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    """Graphs, batch pairs, recon ids, noise arrays and features."""
    jg, tg = sampled_graphs()
    rng = np.random.RandomState(1)
    pu = rng.randint(0, 30, 12).astype(np.int32)
    pi = rng.randint(0, 22, 12).astype(np.int32)
    recon_u = np.array([3, 7, 7, 20, -1, -1], np.int32)
    recon_i = np.array([0, 5, 21, -1], np.int32)
    noise_u = np.arange(30, dtype=np.int32)
    noise_i = np.arange(22, dtype=np.int32)
    noise_i[::2] = -1
    noise_u[[3, 11]] = -1
    fea = (tg.features["user"], tg.features["movie"])
    return jg, tg, pu, pi, recon_u, recon_i, noise_u, noise_i, fea


def jax_params(jg, jcfg, fea, seed=0):
    """The flax tree of the full-graph module for ``jcfg`` (features
    included), with O(1) values (``random_params``)."""
    gd = BipartiteGraphData.from_csr(jg["user", "movie"], pad_multiple=64)
    z = jnp.zeros(4, jnp.int32)
    kw = ({} if not jcfg.use_fea_proj else
          dict(user_features=jnp.asarray(fea[0]),
               item_features=jnp.asarray(fea[1])))
    tree = JSTARGCN(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        gd, gd.edge_pad_mask, jnp.arange(30, dtype=jnp.int32),
        jnp.arange(22, dtype=jnp.int32), z, z, train=False, **kw)["params"]
    return random_params(tree, seed)


def build_plans(setup, fanout=4, caps=None, exclude=True, cfgs=None):
    """The same plan from both packages (the port's with the loop
    planner)."""
    jg, tg, pu, pi, recon_u, recon_i, *_ = setup
    jcfg, tcfg = cfgs or sampled_cfgs()
    caps = caps or {"user": 64, "item": 48}
    kw = dict(fanout=fanout, node_pad=32, recon_user_ids=recon_u,
              recon_item_ids=recon_i)
    if exclude:
        kw.update(exclude_pairs=(pu, pi))
    common = dict(num_layers=1, fanout=fanout, node_pad=32,
                  frontier_caps=caps)
    seed_planners(9)
    jplan = jsm.StackedPlan.build(
        jg, jcfg, pu, pi, sampler=JBlockSampler(jg, **common), **kw)
    tplan = tsm.StackedPlan.build(
        tg, tcfg, pu, pi,
        sampler=BlockSampler(tg, planner="loop", **common), **kw)
    return jplan, tplan


def _tfea(fea):
    return (torch.from_numpy(fea[0]), torch.from_numpy(fea[1]))


def _forward_pair(setup, backend, cfgs, seed=0, **kw):
    """Both packages' eval forward over one capped plan with excluded
    batch edges, recon targets and masked noise."""
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    jplan, tplan = build_plans(setup, cfgs=cfgs)
    jcfg, tcfg = cfgs
    params = jax_params(jg, jcfg, fea, seed)
    want = jsm.sampled_forward(params, jcfg, jplan, noise_u, noise_i,
                               backend=backend, features=fea, **kw)
    with torch.no_grad():
        got = tsm.sampled_forward(
            convert.params_from_flax(params), tcfg, tplan, noise_u, noise_i,
            backend=backend, features=_tfea(fea), **kw)
    return got, want


def _assert_outputs(got, want, tol, embed_tol=None):
    embed_tol = embed_tol or tol
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               np.asarray(want["pred_ratings"]), **tol)
    assert len(got["pred_embed"]) == len(want["pred_embed"])
    for b, blk in enumerate(want["pred_embed"]):
        for t in ("user", "item"):
            np.testing.assert_allclose(
                got["pred_embed"][b][t].float().numpy(),
                np.asarray(blk[t]).astype(np.float32), **embed_tol,
                err_msg=f"block {b} {t}")
    assert sorted(got["gt_embed"]) == sorted(want["gt_embed"])
    for t, w in want["gt_embed"].items():
        np.testing.assert_allclose(got["gt_embed"][t].numpy(), np.asarray(w),
                                   **OUT_TOL)


# ---------------------------- feature projection ----------------------------


@pytest.mark.parametrize("recon_fea", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fea_forward_matches_jax(setup, backend, recon_fea):
    cfgs = sampled_cfgs(**FEA, recon_fea=recon_fea)
    got, want = _forward_pair(setup, backend, cfgs)
    assert got["gt_embed"]["user"].shape == (6, 13 if recon_fea else 8)
    _assert_outputs(got, want, OUT_TOL)


@pytest.mark.parametrize("recon_fea", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fea_all_neighbors_equals_the_full_graph_forward(setup, backend,
                                                         recon_fea):
    """Fanout -1 with features reproduces the port's full-graph forward
    (``tests/test_sampled_parallel.py`` holds the JAX package so)."""
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    jcfg, tcfg = sampled_cfgs(**FEA, recon_fea=recon_fea)
    it = sampled_iterator(DataIterator, tg)
    model = STARGCN(tcfg, feature_dims=feature_dims(it))
    model.load_state_dict(convert.params_from_flax(
        jax_params(jg, jcfg, fea, 1)))
    variants = GraphVariants(tcfg, it, torch.device("cpu"))
    fu, fi = graph_features(it, tcfg, "cpu")
    with torch.no_grad():
        full = model(torch.from_numpy(noise_u), torch.from_numpy(noise_i),
                     torch.from_numpy(pu).long(), torch.from_numpy(pi).long(),
                     variants.degrees("test"), variants.bit_pack("test"),
                     user_features=fu, item_features=fi)
        plan = tsm.StackedPlan.build(it.test_graph, tcfg, pu, pi, fanout=-1,
                                     node_pad=32)
        out = tsm.sampled_forward(model, tcfg, plan, noise_u, noise_i,
                                  backend=backend, features=(fu, fi))
    np.testing.assert_allclose(out["pred_ratings"].numpy(),
                               full["pred_ratings"].numpy(), **OUT_TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fea_loss_and_gradients_match_jax(setup, backend):
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    cfgs = sampled_cfgs(**FEA)
    jplan, tplan = build_plans(setup, cfgs=cfgs)
    jcfg, tcfg = cfgs
    params = jax_params(jg, jcfg, fea, 2)
    rng = np.random.RandomState(5)
    gt = rng.choice([1.0, 2.0, 3.0], 12).astype(np.float32)
    valid = np.ones(12, np.float32)
    valid[-2:] = 0

    def jloss(p):
        return jsm.sampled_loss(p, jcfg, jplan.as_device(), noise_u, noise_i,
                                jnp.asarray(gt), jnp.asarray(valid), 2.1, 0.8,
                                0.1, backend=backend, features=fea)[0]

    want, jgrads = jax.value_and_grad(jloss)(params)
    named = {k: v.requires_grad_() for k, v in
             convert.params_from_flax(params).items()}
    got, _ = tsm.sampled_loss(
        named, tcfg, tplan, noise_u, noise_i, torch.from_numpy(gt),
        torch.from_numpy(valid), 2.1, 0.8, 0.1, backend=backend,
        features=_tfea(fea))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = dict(zip(named, torch.autograd.grad(got, list(named.values()))))
    want_grads = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(want_grads) == sorted(named)
    assert "fea_map_item_l0.weight" in named
    for k, w in want_grads.items():
        w = w.numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("nblocks,dae", [(2, True), (1, False)])
def test_feature_only_forward_matches_jax(setup, nblocks, dae):
    cfgs = sampled_cfgs(**FEA, use_embed=False, nblocks=nblocks,
                        use_dae=dae)
    got, want = _forward_pair(setup, "xla", cfgs)
    assert got["gt_embed"] == {}
    _assert_outputs(got, want, OUT_TOL)


def _first_step_matches_jax(jtrainer, ttrainer):
    """One host-planned step on the same batch: statistics within 1e-4,
    parameters after the step within 1e-3 of each tensor's largest
    entry."""
    batch = sampled_batches(jtrainer, 1)[0]
    want = jax.device_get(jtrainer.train_iteration(batch))
    got = ttrainer.train_iteration(batch)
    for name in STATS:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4,
                                   atol=0, err_msg=name)
    jp = convert.params_from_flax(jax.device_get(jtrainer.params))
    for k, w in jp.items():
        w = w.numpy()
        np.testing.assert_allclose(
            ttrainer.model.state_dict()[k].numpy(), w, rtol=0,
            atol=1e-3 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_trainer_with_features_matches_jax(backend):
    jtrainer, ttrainer = build_sampled_trainers(backend, model=FEA)
    assert ttrainer._fea[0].shape == (30, 8)
    _first_step_matches_jax(jtrainer, ttrainer)
    seed_planners(13)       # evaluation plans its own neighbourhoods
    np.testing.assert_allclose(ttrainer.evaluate("test"),
                               jtrainer.evaluate("test"), rtol=2e-4)


def test_device_planned_trainer_with_features_matches_jax():
    """``plan_device`` with feature projection: with the JAX package's plan
    draws, one step's statistics and every gradient equal those of its
    device-planned step (``tests/test_torch_device_sampling.py``'s
    comparison, features on)."""
    from test_torch_device_sampling import jax_uniforms

    jtr, ttr = build_sampled_trainers(plan_device=True, model=FEA)
    (jbatch,), (tbatch,) = (sampled_batches(tr, 1) for tr in (jtr, ttr))
    ibuf, fbuf, spec = jtr._pack_batch(jbatch)
    jfeed = jsm.unpack_tree(jnp.asarray(ibuf), jnp.asarray(fbuf), spec)
    rng = jax.random.PRNGKey(11)
    caps = (jtr.caps["user"], jtr.caps["item"], jtr.exclude_cap)

    @jax.jit
    def jstep(params):
        dplan, pairs_pos, aux, rng2 = jsl._device_plan_phase(
            jtr, caps, jtr._dev_tables, jfeed, rng)

        def loss(p):
            stats = jsl._loss_update(
                jtr, p, jtr.opt_state, dplan, pairs_pos, jfeed["noise_u"],
                jfeed["noise_i"], jfeed["gt"], jfeed["valid"], rng2,
                identity=aux["identity"])[2]
            return stats["loss"], stats

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, jstats), jgrads = jstep(jtr.params)
    ttr.plan_uniform = jax_uniforms(jax.random.split(rng)[1])
    feed = ttr._feed(ttr._pack_batch(tbatch))
    plan, pp, aux = ttr._device_plan(feed)
    stats, grads = tsl._loss_and_grads(
        ttr, dict(feed, plan=dict(plan, pairs_pos=pp)),
        identity=aux["identity"])
    for name in STATS:
        np.testing.assert_allclose(stats[name].numpy(),
                                   np.asarray(jstats[name]), rtol=1e-4,
                                   err_msg=name)
    want = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# ------------------------------- bf16 compute -------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_forward_matches_jax_and_own_float32(setup, backend):
    cfgs = sampled_cfgs(**FEA, compute_dtype="bfloat16")
    got, want = _forward_pair(setup, backend, cfgs)
    assert got["pred_ratings"].dtype == torch.float32
    _assert_outputs(got, want, dict(rtol=3e-2, atol=3e-2),
                    dict(rtol=5e-2, atol=5e-2))
    ref, _ = _forward_pair(setup, backend, sampled_cfgs(**FEA))
    scale = ref["pred_ratings"].abs().max()
    assert (got["pred_ratings"] - ref["pred_ratings"]).abs().max() \
        <= 0.05 * scale


def test_bf16_pallas_feeds_the_kernel_float32(setup, monkeypatch):
    """In bf16 the ``pallas`` route still projects and pools float32 rows,
    as the JAX package does; the ``xla`` route pools bf16 rows."""
    seen = []
    real = tsm.ell_kernels.ell_spmm

    def spy(values, idx, w):
        seen.append(values.dtype)
        return real(values, idx, w)

    monkeypatch.setattr(tsm.ell_kernels, "ell_spmm", spy)
    cfgs = sampled_cfgs(**FEA, compute_dtype="bfloat16")
    _forward_pair(setup, "pallas", cfgs)
    assert seen and set(seen) == {torch.float32}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_gradients_are_float32_and_track_jax(setup, backend):
    """Every gradient is float32; the loss within 3e-2 of the JAX
    package's bf16 loss, the gradients no farther from the port's float32
    gradients than the JAX package's bf16 gradients are from its own (plus
    4e-3 of each parameter's largest entry)."""
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    gt = np.random.RandomState(5).choice([1.0, 2.0, 3.0], 12).astype(
        np.float32)
    valid = np.ones(12, np.float32)
    res = {}
    for dt in ("bfloat16", "float32"):
        cfgs = sampled_cfgs(**FEA, compute_dtype=dt)
        jplan, tplan = build_plans(setup, cfgs=cfgs)
        jcfg, tcfg = cfgs
        params = jax_params(jg, jcfg, fea, 2)
        jl, jg_ = jax.value_and_grad(lambda p: jsm.sampled_loss(
            p, jcfg, jplan.as_device(), noise_u, noise_i, jnp.asarray(gt),
            jnp.asarray(valid), 2.1, 0.8, 0.1, backend=backend,
            features=fea)[0])(params)
        named = {k: v.requires_grad_() for k, v in
                 convert.params_from_flax(params).items()}
        tl, _ = tsm.sampled_loss(
            named, tcfg, tplan, noise_u, noise_i, torch.from_numpy(gt),
            torch.from_numpy(valid), 2.1, 0.8, 0.1, backend=backend,
            features=_tfea(fea))
        grads = torch.autograd.grad(tl, list(named.values()))
        assert all(g.dtype == torch.float32 for g in grads)
        res[dt] = (float(tl), float(jl),
                   {k: g.numpy() for k, g in zip(named, grads)},
                   {k: v.numpy() for k, v in convert.params_from_flax(
                       jax.device_get(jg_)).items()})

    def worst(a, b):
        return max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
                   for k in b)

    tl16, jl16, port16, jax16 = res["bfloat16"]
    _, _, port32, jax32 = res["float32"]
    np.testing.assert_allclose(tl16, jl16, rtol=3e-2)
    assert worst(port16, port32) <= 1.25 * worst(jax16, jax32) + 4e-3


# ----------------------------------- remat -----------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_remat_equals_no_remat_with_dropout(setup, backend):
    """Dropout 0.3 from one generator state: with ``remat`` the loss, the
    predictions and every gradient equal those without it, each level
    replaying its own masks in the backward, and the generator ends where
    it ends without ``remat``."""
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    cfgs = sampled_cfgs(**FEA, gcn_dropout=0.3)
    _, tplan = build_plans(setup, cfgs=cfgs)
    tcfg = cfgs[1]
    params = convert.params_from_flax(jax_params(jg, cfgs[0], fea, 3))
    gt = torch.ones(12) * 2.0
    runs = {}
    for remat in (False, True):
        named = {k: v.clone().requires_grad_() for k, v in params.items()}
        gen = torch.Generator().manual_seed(17)
        loss, (_, preds) = tsm.sampled_loss(
            named, tcfg, tplan, noise_u, noise_i, gt, torch.ones(12), 2.1,
            0.8, 0.1, backend=backend, train=True, generator=gen,
            features=_tfea(fea), remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()))
        runs[remat] = (loss.detach(), preds.detach(),
                       dict(zip(named, grads)), gen.get_state())
    (l0, p0, g0, s0), (l1, p1, g1, s1) = runs[False], runs[True]
    assert torch.equal(s0, s1)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    torch.testing.assert_close(p1, p0, rtol=1e-6, atol=1e-6)
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, rtol=0,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12,
                                   msg=k)
    # dropout acted: another stream gives another loss
    other, _ = tsm.sampled_loss(
        params, tcfg, tplan, noise_u, noise_i, gt, torch.ones(12), 2.1, 0.8,
        0.1, backend=backend, train=True,
        generator=torch.Generator().manual_seed(18), features=_tfea(fea),
        remat=True)
    assert not torch.equal(other.detach(), l0)


def test_remat_keeps_less_for_the_backward(setup):
    """``remat`` keeps only each level's inputs for the backward: the
    autograd graph holds no ``(N, K, E)`` message buffer."""
    jg, *_, noise_u, noise_i, fea = setup
    cfgs = sampled_cfgs(**FEA)
    _, tplan = build_plans(setup, cfgs=cfgs)
    params = {k: v.requires_grad_() for k, v in convert.params_from_flax(
        jax_params(jg, cfgs[0], fea)).items()}
    saved = {}
    for remat in (False, True):
        sizes = []

        def pack(x, sizes=sizes):
            sizes.append(x.numel())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            tsm.sampled_loss(params, cfgs[1], tplan, noise_u, noise_i,
                             torch.ones(12), torch.ones(12), 2.1, 0.8, 0.1,
                             features=_tfea(fea), remat=remat)
        saved[remat] = sum(sizes)
    assert saved[True] < saved[False]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_remat_matches_jax_without_dropout(setup, backend):
    cfgs = sampled_cfgs(**FEA)
    jg, tg, pu, pi, _, _, noise_u, noise_i, fea = setup
    jplan, tplan = build_plans(setup, cfgs=cfgs)
    params = jax_params(jg, cfgs[0], fea, 4)
    gt = np.full(12, 2.0, np.float32)
    valid = np.ones(12, np.float32)
    def jloss(p):
        # jsm.sampled_loss passes no remat: its loss, written out
        out = jsm.sampled_forward(p, cfgs[0], jplan.as_device(), noise_u,
                                  noise_i, backend=backend, train=True,
                                  dropout_rng=jax.random.PRNGKey(0),
                                  features=fea, remat=True)
        loss = jnp.sum(0.5 * jnp.sum(
            (out["pred_ratings"] - (gt - 2.1) / 0.8) ** 2 * valid, axis=1)
            / valid.sum())
        for blk, ok in zip(out["pred_embed"], out["recon_ok"]):
            for t in ("user", "item"):
                d = jnp.sum((blk[t] - out["gt_embed"][t]) ** 2, axis=-1)
                loss = loss + 0.1 * jnp.sum(d * ok[t]) / jnp.maximum(
                    ok[t].sum(), 1.0)
        return loss

    want, jgrads = jax.value_and_grad(jloss)(params)
    named = {k: v.requires_grad_() for k, v in
             convert.params_from_flax(params).items()}
    got, _ = tsm.sampled_loss(
        named, cfgs[1], tplan, noise_u, noise_i, torch.from_numpy(gt),
        torch.from_numpy(valid), 2.1, 0.8, 0.1, backend=backend,
        features=_tfea(fea), train=True, remat=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = dict(zip(named, torch.autograd.grad(got, list(named.values()))))
    for k, w in convert.params_from_flax(jax.device_get(jgrads)).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_remat_trainer_matches_jax_remat_trainer():
    """Both packages' ``SampledTrainer(remat=True)`` (dropout 0) take the
    same first step."""
    jtrainer, ttrainer = build_sampled_trainers(model=FEA)
    jtrainer.remat = ttrainer.remat = True
    _first_step_matches_jax(jtrainer, ttrainer)


def test_trainers_refuse_feature_only_dae():
    _, tg = sampled_graphs()
    it = sampled_iterator(DataIterator, tg)
    cfg = sampled_cfgs(**FEA, use_embed=False)[1]
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8)
    with pytest.raises(NotImplementedError, match="USE_EMBED"):
        SampledTrainer(cfg, it, s, fanout=4, device="cpu")
    SampledTrainer(dataclasses.replace(cfg, nblocks=1, use_dae=False), it,
                   dataclasses.replace(s, use_dae=False), fanout=4,
                   device="cpu")


# ---------------------------------- the CLI ----------------------------------


@pytest.mark.parametrize("sampled", [False, True])
def test_train_cli_with_options(tmp_path, sampled):
    """``python -m stargcn_tpu_torch.train`` on a YAML with feature
    projection and bf16 compute: full-graph, and sampled with ``--remat``;
    then the predict CLI serves the checkpoint."""
    import yaml

    from stargcn_tpu_torch import predict as predict_cli
    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "options.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic", "TEST_RATIO": 0.1},
        "MODEL": {"USE_FEA_PROJ": True, "COMPUTE_DTYPE": "bfloat16"},
        "FEA": {"MID_MAP": 6, "UNITS": 5},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "KERNEL": {"BACKEND": "xla"},
        "TRAIN": {"RATING_BATCH_SIZE": 256, "RECON_BATCH_SIZE": 64,
                  "LOG_INTERVAL": 2, "VALID_INTERVAL": 4,
                  "SCAN_STEPS": 2}}))
    save_dir = tmp_path / "runs"
    args = ["--cfg", str(cfg_path), "--device", "cpu", "--save_dir",
            str(save_dir), "--max_iter", "4", "--silent"]
    if sampled:
        args += ["--num_neighbors", "4", "--backend", "pallas", "--remat"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main(args)
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 4
    assert np.isfinite(result["best_valid_rmse"])
    log_text = (save_dir / "log0.log").read_text()
    assert "result: {" in log_text
    ckpt = save_dir / "ckpt_best_0.pt"
    assert ckpt.exists()
    out = tmp_path / "art.npz"
    predict_cli.main(["--cfg", str(cfg_path), "--device", "cpu", "--resume",
                      str(ckpt), "--save_artifact", str(out), "--pairs",
                      "1:2,3:4"])
    art = np.load(out)
    assert art["user_feats"].dtype == np.float32
    assert np.isfinite(art["user_feats"]).all()
