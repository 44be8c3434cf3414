"""The port's full-graph ``dense`` and ``xla`` backends against the JAX
package: the model forward on the same parameters (moved over by
``convert.params_from_flax``) and against ``numpy_stargcn_forward``, one
training step's gradients, five training steps, evaluation, prediction and
the serving export, a twin of ``tests/test_cross_backend_fuzz.py`` in
which the port's backends agree with each other, ``fit`` on the three
transductive configs, and the train CLI with ``KERNEL.BACKEND: auto``.

Tolerances: forward outputs 2e-4 (float32, other summation orders through
four aggregation layers and the rating head); a step's gradients 1e-4 of
each parameter's largest entry and its statistics 1e-4 relative; after
five steps 1e-3 (Adam divides by the root of the second moment, which
amplifies rounding where a gradient is near zero), as
``tests/test_torch_trainer.py`` holds ``bitdense``.  These hold ``xla``
and ``dense`` on a float32 adjacency ("dense-f32": the JAX side gets a
float32 adjacency too).  On the bf16 adjacency, the trainer's default,
both packages round the same scaled operands and cotangents to bf16, but
their float32 inputs differ in the last bits (other summation orders), so
now and then a value on a rounding boundary goes to the other bf16
neighbour, one bf16 ulp (2^-8 relative) of one term of a sum: a step's
gradients are held at 4e-3 of each parameter's largest entry there, the
parameters after five Adam steps at 1e-2, and statistics and forward
outputs as above.  In the fuzz every float32 path agrees within 2e-4 and
the bf16 adjacency within 2e-2 (its rounded operands against float32
ones).
"""

import dataclasses
import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_slice import ROOT, build_trainers, host_batches
from stargcn_tpu import serve as jserve
from stargcn_tpu.models import STARGCN as JSTARGCN
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch import convert
from stargcn_tpu_torch import serve as tserve
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data.synthetic import synthetic_graph
from stargcn_tpu_torch.graph.device import BipartiteGraphData, EdgeSet
from stargcn_tpu_torch.models import STARGCN, STARGCNConfig
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.ops.agg import build_dense_adjacency
from stargcn_tpu_torch.ops.bitdense import build_bit_pack
from stargcn_tpu_torch.train import Trainer, TrainSettings
from stargcn_tpu_torch.utils import cfg_from_file
from test_numpy_reference import numpy_stargcn_forward

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")
BACKENDS = ("dense", "xla")
# The trainer routes held against the JAX package's: "dense-f32" is the
# dense backend on float32 adjacencies in both packages.
ROUTES = ("xla", "dense-f32", "dense")
GRAD_TOL = {"xla": 1e-4, "dense-f32": 1e-4, "dense": 4e-3}
PARAM_TOL = {"xla": 1e-3, "dense-f32": 1e-3, "dense": 1e-2}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while this module's tests run: the suite runs
    several worker processes on one host, and eight spinning threads in
    each make the CPU products crawl."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _trainers(route, accum="sum", **overrides):
    """Both packages' trainers on ``route``; on "dense-f32" each reads
    float32 adjacencies (the JAX trainer's built as it builds its own)."""
    backend = route.split("-")[0]
    jtrainer, ttrainer = build_trainers(
        accum, **{"KERNEL.BACKEND": backend, **overrides})
    assert jtrainer.model_cfg.backend == ttrainer.model_cfg.backend == backend
    if route == "dense-f32":
        from stargcn_tpu.ops.agg import build_dense_adjacency as j_build

        g = jtrainer.graph_data
        jtrainer.dense_adj = {
            k: j_build(g.edge_item, g.edge_user, g.edge_rating,
                       m * g.edge_pad_mask, g.num_links, g.num_users,
                       g.num_items, dtype=jnp.float32)
            for k, m in jtrainer.edge_masks.items()}
        ttrainer._operands = lambda variant: ttrainer.variants.dense_adj(
            variant, torch.float32)
    return jtrainer, ttrainer


def _jax_forward(jtrainer, params, segment, pu, pi, noise, train=False,
                 removed=None):
    """The JAX model on a variant, as its trainer calls it (``removed``: the
    host-lookup 4-tuple, folded into the mask on ``xla`` as the trainer
    does)."""
    cfg = jtrainer.model_cfg
    mask = jtrainer.edge_masks[segment]
    g = jtrainer.graph_data
    dense = cfg.backend == "dense"
    if removed is not None and not dense:
        mask = g.edge_mask_from_pairs(removed[0], removed[1], removed[2],
                                      mask)
    return jtrainer.model.apply(
        {"params": params}, g, mask, jnp.asarray(noise[0]),
        jnp.asarray(noise[1]), jnp.asarray(pu), jnp.asarray(pi),
        dense_adj=jtrainer.dense_adj[segment] if dense else None,
        variant_degrees=(jtrainer.variant_degrees[segment] if dense
                         else None),
        removed_pairs=removed, train=train,
        rngs={"dropout": jax.random.PRNGKey(0)},
        return_rating_feats=not train)


def _port_forward(ttrainer, segment, pu, pi, noise, **kw):
    v = ttrainer.variants
    return ttrainer.model(
        t(noise[0]), t(noise[1]), t(pu).long(), t(pi).long(),
        v.degrees(segment), v.operands(segment, ttrainer.model_cfg.backend),
        **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("accum,segment", [
    ("sum", "test"), ("sum", "valid"), ("stack", "test")])
def test_forward_matches_jax(backend, accum, segment):
    jtrainer, ttrainer = _trainers(backend, accum)
    rng = np.random.RandomState(5)
    pu = rng.randint(0, 40, 64).astype(np.int32)
    pi = rng.randint(0, 30, 64).astype(np.int32)
    nz = jtrainer.data_iter.evaluate_embed_noise_dict
    noise = (nz["user"], nz["movie"])
    want = _jax_forward(jtrainer, jtrainer.params, segment, pu, pi, noise)
    with torch.no_grad():
        got = _port_forward(ttrainer, segment, pu, pi, noise,
                            return_rating_feats=True)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               np.asarray(want["pred_ratings"]), **tol)
    for key in ("user", "item"):
        np.testing.assert_allclose(got["rating_feats"][key].numpy(),
                                   np.asarray(want["rating_feats"][key]),
                                   **tol, err_msg=key)
        for b in range(2):
            np.testing.assert_allclose(
                got["pred_embed"][b][key].numpy(),
                np.asarray(want["pred_embed"][b][key]), **tol,
                err_msg=f"block {b} {key}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("accum", ["stack", "sum"])
def test_forward_matches_numpy_reference(backend, accum):
    """The from-equations forward of ``tests/test_numpy_reference.py`` on
    the test variant's edges (float32 adjacency on ``dense``, where the
    reference computes in float64)."""
    _, ttrainer = _trainers(backend, accum, **{"GCN.AGG.UNITS": [20]})
    v = ttrainer.variants
    cfg = ttrainer.model_cfg
    rng = np.random.RandomState(2)
    pu = rng.randint(0, 40, 10)
    pi = rng.randint(0, 30, 10)
    noise_u = np.arange(40, dtype=np.int32)
    noise_u[3] = -1
    noise_i = np.arange(30, dtype=np.int32)
    operands = (v.dense_adj("test", torch.float32) if backend == "dense"
                else v.operands("test", backend))
    with torch.no_grad():
        got = ttrainer.model(t(noise_u), t(noise_i), t(pu), t(pi),
                             v.degrees("test"), operands)["pred_ratings"]
    eu, ei, er, pad = v._edges
    real = v.edge_mask("test") * pad > 0
    params = convert.flax_from_params(ttrainer.model.state_dict())
    want = numpy_stargcn_forward(params, cfg, (eu[real], ei[real], er[real]),
                                 noise_u, noise_i, pu, pi)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route,accum,overrides", [
    ("xla", "sum", {}), ("xla", "stack", {"GCN.AGG.NORM_SYMM": False}),
    ("xla", "sum", {"GCN.AGG.ORDINAL_SHARING": True}),
    ("dense-f32", "sum", {}),
    ("dense-f32", "stack", {"GCN.AGG.NORM_SYMM": False}),
    ("dense-f32", "sum", {"GCN.AGG.ORDINAL_SHARING": True}),
    ("dense", "sum", {}), ("dense", "sum", {"GCN.AGG.NORM_SYMM": False})])
def test_train_forward_and_gradients_match_jax(route, accum, overrides):
    """One training forward with the batch's edges removed, and the
    gradient of every parameter for a random functional of its outputs."""
    jtrainer, ttrainer = _trainers(route, accum, **overrides)
    backend = jtrainer.model_cfg.backend
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
    operands = ttrainer._operands("train")
    if backend == "xla":
        operands = EdgeSet(operands.graph, operands.graph.edge_mask_from_pairs(
            pu, pi, t(flts[2]), operands.mask))
    got = ttrainer.model(t(noise[:nu]), t(noise[nu:]), pu, pi,
                         ttrainer.variants.degrees("train"), operands,
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
                                   atol=GRAD_TOL[route] * np.abs(wg).max(),
                                   err_msg=k)


@pytest.fixture(scope="module", params=ROUTES)
def five_steps(request):
    """Both trainers after five steps on the same batches, with each
    step's statistics."""
    jtrainer, ttrainer = _trainers(request.param)
    ttrainer.route = request.param
    jstats, tstats = [], []
    for rb, cb in host_batches(jtrainer, 5):
        jstats.append(jax.device_get(jtrainer.train_iteration(rb, cb)))
        tstats.append({k: v.numpy() for k, v in
                       ttrainer.train_iteration(rb, cb).items()})
    return jtrainer, ttrainer, jstats, tstats


def test_five_steps_match_jax(five_steps):
    jtrainer, ttrainer, jstats, tstats = five_steps
    assert ttrainer.do_remove
    for name in STATS:
        np.testing.assert_allclose(tstats[0][name], jstats[0][name],
                                   rtol=1e-4, atol=0, err_msg=name)
    np.testing.assert_allclose([s["loss"] for s in tstats],
                               [s["loss"] for s in jstats], rtol=1e-3)
    want = convert.params_from_flax(jax.device_get(jtrainer.params))
    got = ttrainer.model.state_dict()
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=0,
            atol=PARAM_TOL[ttrainer.route] * np.abs(w).max(), err_msg=k)
    assert ttrainer.opt.count == 5


@pytest.mark.parametrize("segment", ["valid", "test"])
def test_evaluate_predict_and_export_match_jax(five_steps, segment):
    jtrainer, ttrainer, _, _ = five_steps
    np.testing.assert_allclose(ttrainer.evaluate(segment),
                               jtrainer.evaluate(segment), rtol=2e-4)
    rng = np.random.RandomState(3)
    uu = rng.randint(0, 40, 50).astype(np.int32)
    ii = rng.randint(0, 30, 50).astype(np.int32)
    np.testing.assert_allclose(ttrainer.predict(uu, ii, segment=segment),
                               jtrainer.predict(uu, ii, segment=segment),
                               rtol=2e-4, atol=2e-4)
    art = tserve.export_serving(ttrainer, segment=segment)
    jart = jserve.export_serving(jtrainer, segment=segment)
    for a, b in ((art.user_feats, jart.user_feats),
                 (art.item_feats, jart.item_feats)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(art.rated_items, jart.rated_items)
    # a ServingState on the same parameters exports the same artifact
    state = tserve.ServingState(ttrainer.model_cfg, ttrainer.data_iter,
                                device="cpu",
                                state_dict=ttrainer.model.state_dict(),
                                variants=ttrainer.variants)
    again = tserve.export_serving(state, segment=segment)
    np.testing.assert_array_equal(again.user_feats, art.user_feats)


def test_dense_adjacency_is_shared_between_identical_masks():
    _, ttrainer = _trainers("dense")
    v = ttrainer.variants
    np.testing.assert_array_equal(v.edge_mask("valid"), v.edge_mask("train"))
    assert v.dense_adj("valid") is v.dense_adj("train")
    assert v.dense_adj("test") is not v.dense_adj("train")
    adj = v.dense_adj("train")
    assert adj.dtype == torch.bfloat16 and adj.shape == (10, 40, 30)
    assert int(adj.float().sum()) == int(v.edge_mask("train").sum())
    assert v.dense_adj("train", torch.float32).dtype == torch.float32
    assert len(v._adjs[torch.bfloat16]._cache) == 2
    assert v.operands("train", "dense") is adj
    assert isinstance(v.operands("train", "xla"), EdgeSet)


@pytest.mark.parametrize("backend", BACKENDS)
def test_removal_forms_agree(backend):
    """On ``dense`` the 3-tuple removal (looked up on the device) equals
    the host 4-tuple, and the per-step dense support over an EdgeSet with
    the batch's edges masked out equals the static adjacency with the
    correction; on ``xla`` the mask from ``edge_mask_from_pairs`` equals a
    mask built on the host without the batch's edges."""
    _, ttrainer = _trainers(backend)
    batch = host_batches(ttrainer, 1)[0]
    ints, flts, noise, _ = ttrainer._prep_host_arrays(*batch)
    nu = 40
    pu, pi, rr = (t(ints[k]).long() for k in range(3))
    v = ttrainer.variants
    run = lambda ops, removed=None, **kw: ttrainer.model(  # noqa: E731
        t(noise[:nu]), t(noise[nu:]), pu, pi, v.degrees("train"), ops,
        removed, **kw)["pred_ratings"]
    eu, ei, _, pad = v._edges
    keys = set(zip(ints[0].tolist(), ints[1].tolist()))
    keep = np.array([(a, b) not in keys for a, b in zip(eu, ei)])
    host_mask = t((v.edge_mask("train") * keep).astype(np.float32))
    with torch.no_grad():
        if backend == "dense":
            four = run(v.dense_adj("train", torch.float32),
                       (pu, pi, t(flts[2]), rr))
            three = run(v.dense_adj("train", torch.float32),
                        (pu, pi, t(flts[1])), graph=v.graph_data)
            np.testing.assert_array_equal(three.numpy(), four.numpy())
            per_step = run(EdgeSet(v.graph_data, host_mask))
            np.testing.assert_allclose(per_step.numpy(), four.numpy(),
                                       rtol=2e-4, atol=2e-4)
        else:
            mask = v.graph_data.edge_mask_from_pairs(pu, pi, t(flts[2]),
                                                     v.device_mask("train"))
            np.testing.assert_array_equal(mask.numpy(), host_mask.numpy())
            whole = run(v.operands("train", "xla"))
            removed = run(EdgeSet(v.graph_data, mask))
            assert float((removed - whole).abs().max()) > 1e-3


def test_backends_refuse_the_wrong_operands():
    _, ttrainer = _trainers("xla")
    v = ttrainer.variants
    pu = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="EdgeSet"):
        ttrainer.model(None, None, pu, pu, v.degrees("test"),
                       v.dense_adj("test"))
    bit = STARGCN(dataclasses.replace(ttrainer.model_cfg,
                                      backend="bitdense"))
    with pytest.raises(ValueError, match="bit pack"):
        bit(None, None, pu, pu, v.degrees("test"), v.operands("test", "xla"))


# ------------------------ the cross-backend fuzz --------------------------


@pytest.mark.parametrize("trial", range(4))
def test_all_backends_agree(trial):
    """Random small graphs and configs, seeded as
    ``tests/test_cross_backend_fuzz.py``: the port's ``xla``, chunked
    ``xla``, ``dense`` on a float32 and a bf16 adjacency, ``dense`` on the
    per-step support and ``bitdense`` (plain) agree, and ``xla`` agrees
    with the JAX package's on the same parameters."""
    rng = np.random.RandomState(100 + trial)
    nu_n = int(rng.randint(8, 30))
    ni_n = int(rng.randint(8, 30))
    R = int(rng.choice([2, 3, 5]))
    E = int(rng.randint(40, 200))
    nb = int(rng.choice([1, 2]))
    accum = str(rng.choice(["stack", "sum"]))
    symm = bool(rng.randint(2))
    units = int(rng.choice([6, 12])) * R if accum == "stack" else \
        int(rng.choice([7, 11]))
    g = synthetic_graph(num_users=nu_n, num_items=ni_n, num_edges=E,
                        rating_values=tuple(range(1, R + 1)),
                        seed=200 + trial)
    gd = BipartiteGraphData.from_csr(g["user", "movie"], "cpu",
                                     pad_multiple=32)
    cfg = STARGCNConfig(
        num_users=nu_n, num_items=ni_n, num_links=R, nblocks=nb,
        use_dae=nb > 1 or bool(rng.randint(2)),
        embed_units=int(rng.choice([4, 8])),
        agg_units=(units,), out_units=(int(rng.choice([5, 9])),),
        agg_accum=accum, agg_norm_symm=symm,
        agg_ordinal_sharing=bool(rng.randint(2)),
        gcn_dropout=0.0, gen_rating_mid_map=4, backend="xla")
    pu = torch.from_numpy(rng.randint(0, nu_n, 8))
    pi = torch.from_numpy(rng.randint(0, ni_n, 8))
    noise_u = np.arange(nu_n, dtype=np.int32)
    noise_u[rng.uniform(size=nu_n) < 0.2] = -1
    noise_i = np.arange(ni_n, dtype=np.int32)
    ref_model = STARGCN(cfg, generator=torch.Generator().manual_seed(trial))
    sd = ref_model.state_dict()
    pad = gd.edge_pad_mask
    deg = (torch.zeros(nu_n).index_add_(0, gd.edge_user.long(), pad),
           torch.zeros(ni_n).index_add_(0, gd.edge_item.long(), pad))

    def run(operands, **changes):
        model = STARGCN(dataclasses.replace(cfg, **changes))
        model.load_state_dict(sd)
        with torch.no_grad():
            return model(t(noise_u), t(noise_i), pu, pi, deg,
                         operands)["pred_ratings"].numpy()

    edges = EdgeSet(gd, torch.ones_like(pad))
    ref = run(edges)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(run(edges, edge_chunk=32), ref, **tol)
    adj = {dt: build_dense_adjacency(gd.edge_item, gd.edge_user,
                                     gd.edge_rating, pad, R, nu_n, ni_n,
                                     dtype=dt)
           for dt in (torch.float32, torch.bfloat16)}
    np.testing.assert_allclose(run(adj[torch.float32], backend="dense"),
                               ref, **tol)
    np.testing.assert_allclose(run(adj[torch.bfloat16], backend="dense"),
                               ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    np.testing.assert_allclose(run(edges, backend="dense"), ref, **tol)
    pack = build_bit_pack(gd.edge_user.numpy(), gd.edge_item.numpy(),
                          gd.edge_rating.numpy(), pad.numpy(), nu_n, ni_n, R,
                          "cpu")
    np.testing.assert_allclose(run(pack, backend="bitdense", bit_impl="xla"),
                               ref, **tol)

    # The JAX package's xla forward on the same parameters and graph.
    from stargcn_tpu.graph.device import BipartiteGraphData as JGraph
    from stargcn_tpu.models import STARGCNConfig as JConfig

    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)
                      if f.name not in ("bit_impl",)})
    jgd = JGraph.from_csr(g["user", "movie"], pad_multiple=32)
    want = JSTARGCN(jcfg).apply(
        {"params": convert.flax_from_params(sd)}, jgd, jgd.edge_pad_mask,
        jnp.asarray(noise_u), jnp.asarray(noise_i),
        jnp.asarray(pu.numpy().astype(np.int32)),
        jnp.asarray(pi.numpy().astype(np.int32)),
        train=False)["pred_ratings"]
    np.testing.assert_allclose(ref, np.asarray(want), **tol)


# ------------------------ configs, entry points ---------------------------


def _tiny_iterator(cfg):
    g = synthetic_graph(num_users=40, num_items=30, num_edges=600, seed=9)
    pairs = g["user", "movie"].node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    return g, DataIterator(
        g, "user", "movie", test_node_pairs=pairs[:, perm[:100]],
        valid_node_pairs=pairs[:, perm[100:160]],
        embed_P_mask=cfg.EMBED.MASK_PROP, embed_p_zero=cfg.EMBED.P_ZERO,
        embed_p_self=1.0 - cfg.EMBED.P_ZERO, seed=5)


TRANSDUCTIVE = sorted(glob.glob(os.path.join(ROOT, "configs",
                                             "transductive_*.yml")))


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("cfg_path", TRANSDUCTIVE, ids=os.path.basename)
def test_transductive_config_fits(cfg_path, backend):
    """Every transductive config trains, validates and checkpoints on the
    tiny graph of ``tests/test_configs_e2e.py`` (``auto`` resolves to
    ``dense`` there)."""
    cfg = cfg_from_file(cfg_path)
    cfg.TRAIN.RATING_BATCH_SIZE = 64
    cfg.TRAIN.SCAN_STEPS = 1
    cfg.KERNEL.BACKEND = backend
    g, it = _tiny_iterator(cfg)
    csr = g["user", "movie"]
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link), num_edges=csr.nnz)
    assert model_cfg.backend == ("dense" if backend == "auto" else "xla")
    trainer = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                      device="cpu")
    result = trainer.fit(max_iter=10, log=lambda *_: None)
    assert result["best_iter"] == 10
    assert np.isfinite(result["best_valid_rmse"])
    assert np.isfinite(result["best_test_rmse"]).all()


@pytest.mark.parametrize("backend", ["auto", "dense", "xla", "pallas",
                                     "bitdense"])
def test_model_config_matches_jax(backend):
    """Both packages translate the configs alike, edge chunks included
    (ML-1M sizes; ``pallas`` reads as ``xla`` on the full graph)."""
    path = os.path.join(ROOT, "configs", "transductive_ml_1m.yml")
    got, want = cfg_from_file(path), j_cfg_from_file(path)
    got.KERNEL.BACKEND = want.KERNEL.BACKEND = backend
    got.KERNEL.XLA_MSG_BUDGET_MB = want.KERNEL.XLA_MSG_BUDGET_MB = 100
    for nu, ni, ne in ((6040, 3706, 1_000_209), (943, 1682, 100_000)):
        a = build_model_config(got, nu, ni, 5, num_edges=ne)
        b = j_build_model_config(want, nu, ni, 5, num_edges=ne)
        for field in a.__dataclass_fields__:
            assert getattr(a, field) == getattr(b, field), field
        assert a.backend == {"auto": "dense", "pallas": "xla"}.get(backend,
                                                                   backend)
    # 100 MB hold 100,000 messages of 250 floats: one 65,536-edge chunk.
    assert build_model_config(got, 6040, 3706, 5,
                              num_edges=1_000_209).edge_chunk == (
        None if backend not in ("xla", "pallas") else 65_536)


def test_train_and_predict_cli_need_no_backend(tmp_path, capsys):
    """The train CLI on its default synthetic graph (943 x 1682, 100,000
    edges) with no ``--backend``: ``auto`` resolves to ``dense``, it trains
    10 steps, and the predict CLI serves its checkpoint."""
    from stargcn_tpu_torch import predict
    from stargcn_tpu_torch.train import __main__ as train_cli

    cfg_path = tmp_path / "small.yml"
    cfg_path.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "synthetic"},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 4000, "LOG_INTERVAL": 5,
                  "VALID_INTERVAL": 10}}))
    cfg = cfg_from_file(str(cfg_path))
    assert cfg.KERNEL.BACKEND == "auto"
    assert predict.build_dataset(cfg)[2].backend == "dense"
    save_dir = tmp_path / "runs"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    common = ["--cfg", str(cfg_path), "--device", "cpu"]
    try:
        result = train_cli.main(common + ["--save_dir", str(save_dir),
                                          "--max_iter", "10", "--silent"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] == 10
    assert np.isfinite(result["best_valid_rmse"])
    capsys.readouterr()
    predict.main(common + ["--resume", str(save_dir / "ckpt_best_0.pt"),
                           "--users", "1", "--topk", "3", "--pairs", "1:2"])
    out = [yaml.safe_load(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0]["mode"] == "predict" and len(out[1]["items"]) == 3
