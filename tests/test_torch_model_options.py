"""The model options of the full-graph model against the JAX package, on the
CPU: feature projection (``MODEL.USE_FEA_PROJ`` with and without
``MODEL.RECON_FEA``) on ``dense``, ``xla`` and ``bitdense`` (its plain
versions), feature-only input (``MODEL.USE_EMBED: false``), bf16 compute
(``MODEL.COMPUTE_DTYPE``), per-edge dropout (``GCN.DROPOUT_PER_EDGE``), one
encoder layer at every depth (``GCN.USE_RECURRENT``), the converter's round
trip of their parameters, and the serving export with features.  The same
graph, split and parameters (``_torch_slice.build_trainers``) go to both
packages, dropout 0 unless a test says otherwise.

Tolerances: float32 forward outputs 2e-4, a step's statistics 1e-4
relative and the gradients of a random functional of the outputs 1e-4 of
each parameter's largest entry on ``xla`` and ``bitdense`` and 4e-3 on
``dense``'s bf16 adjacency (``tests/test_torch_dense_xla.py`` explains
why).  bf16 compute: both packages round at the same points, but their
float32 inputs differ in the last bits, so a value on a rounding boundary
can take the other bf16 neighbour; predictions are held at rtol = atol =
3e-2 and reconstructed embeddings at 5e-2 (the JAX package's own bf16
tolerances, ``tests/test_device_sampling.py``), gradients at 4e-3 of each
parameter's largest entry, and the port's bf16 predictions against its own
float32 ones within 5% of their scale (``tests/test_model.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (GRAPH, _iterator, build_trainers, host_batches,
                          random_params, small_ml10m_cfg)
from stargcn_tpu import serve as jserve
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.train import Trainer as JTrainer
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.train.loop import TrainSettings as JTrainSettings
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch import convert
from stargcn_tpu_torch import serve as tserve
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.graph.device import EdgeSet
from stargcn_tpu_torch.models import STARGCN, build_model_config
from stargcn_tpu_torch.models.aggregators import MultiLinkGCNAggregator
from stargcn_tpu_torch.models.layers import Relation
from stargcn_tpu_torch.train import Trainer, TrainSettings
from stargcn_tpu_torch.utils import cfg_from_file

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")
BACKENDS = ("dense", "xla", "bitdense")
GRAD_TOL = {"xla": 1e-4, "bitdense": 1e-4, "dense": 4e-3}
FEA = {"MODEL.USE_FEA_PROJ": True, "FEA.MID_MAP": 6, "FEA.UNITS": 5}
BF16 = {"MODEL.COMPUTE_DTYPE": "bfloat16"}
FEATURE_ONLY = {**FEA, "MODEL.USE_EMBED": False}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while this module's tests run: the suite runs
    several worker processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _trainers(backend, accum="sum", **overrides):
    jtrainer, ttrainer = build_trainers(
        accum, **{"KERNEL.BACKEND": backend, **overrides})
    assert jtrainer.model_cfg.backend == ttrainer.model_cfg.backend
    # The JAX trainer caches its first ``features()``: made inside a jitted
    # step, they would be tracers that its later evaluation cannot read
    # (ROADMAP Queue 3), so they are made here, outside any trace.
    jtrainer.features()
    return jtrainer, ttrainer


def _jax_out(jtrainer, params, segment, pu, pi, noise, train=False,
             removed=None, model=None):
    """The JAX model on a variant as its trainer calls it, features
    included (``removed``: the host-lookup 4-tuple, folded into the mask
    on ``xla``)."""
    cfg = jtrainer.model_cfg
    g = jtrainer.graph_data
    mask = jtrainer.edge_masks[segment]
    static = cfg.backend in ("dense", "bitdense")
    if removed is not None and not static:
        mask = g.edge_mask_from_pairs(removed[0], removed[1], removed[2],
                                      mask)
    fu, fi = jtrainer.features()
    return (model or jtrainer.model).apply(
        {"params": params}, g, mask, jnp.asarray(noise[0]),
        jnp.asarray(noise[1]), jnp.asarray(pu), jnp.asarray(pi),
        user_features=fu, item_features=fi,
        dense_adj=(jtrainer.dense_adj[segment] if cfg.backend == "dense"
                   else None),
        variant_degrees=(jtrainer.variant_degrees[segment] if static
                         else None),
        ell_pack=jtrainer._ell_pack(segment), removed_pairs=removed,
        train=train, rngs={"dropout": jax.random.PRNGKey(0)},
        return_rating_feats=not train)


def _port_out(owner, segment, pu, pi, noise, removed=None, **kw):
    """The port's model on a variant (``owner``: a ``Trainer`` or a
    ``ServingState``), features included."""
    v = owner.variants
    operands = v.operands(segment, owner.model_cfg.backend)
    if removed is not None and isinstance(operands, EdgeSet):
        operands = EdgeSet(operands.graph, operands.graph.edge_mask_from_pairs(
            removed[0], removed[1], removed[2], operands.mask))
    fu, fi = owner.features()
    return owner.model(t(noise[0]), t(noise[1]), t(pu).long(), t(pi).long(),
                       v.degrees(segment), operands, removed,
                       user_features=fu, item_features=fi, **kw)


def _eval_inputs(jtrainer, seed=5):
    rng = np.random.RandomState(seed)
    pu = rng.randint(0, 40, 64).astype(np.int32)
    pi = rng.randint(0, 30, 64).astype(np.int32)
    nz = jtrainer.data_iter.evaluate_embed_noise_dict
    return pu, pi, (nz["user"], nz["movie"])


def _assert_forward(got, want, tol, embed_tol=None):
    embed_tol = embed_tol or tol
    np.testing.assert_allclose(got["pred_ratings"].float().numpy(),
                               np.asarray(want["pred_ratings"]), **tol)
    assert len(got["pred_embed"]) == len(want["pred_embed"])
    for b, (gb, wb) in enumerate(zip(got["pred_embed"],
                                     want["pred_embed"])):
        for key in ("user", "item"):
            np.testing.assert_allclose(
                gb[key].float().numpy(),
                np.asarray(wb[key].astype(jnp.float32)), **embed_tol,
                err_msg=f"block {b} {key}")
    assert sorted(got["gt_embed"]) == sorted(want["gt_embed"])
    for key, w in want["gt_embed"].items():
        np.testing.assert_allclose(got["gt_embed"][key].detach().numpy(),
                                   np.asarray(w), rtol=1e-6, atol=1e-6)
    if "rating_feats" in want:
        for key in ("user", "item"):
            np.testing.assert_allclose(
                got["rating_feats"][key].float().numpy(),
                np.asarray(want["rating_feats"][key].astype(jnp.float32)),
                **embed_tol, err_msg=key)


def _loss_grads(jtrainer, ttrainer, loss_rtol=1e-4):
    """The gradients of one step's training loss (rating + reconstruction,
    batch edges removed) in both packages, after holding the two losses
    within ``loss_rtol``: ``(port, jax)`` numpy dicts by port parameter
    name.  The JAX loss is its trainer's, written out."""
    batch = host_batches(jtrainer, 1)[0]
    ints, flts, noise, rmask = jtrainer._prep_host_arrays(*batch)
    nu = 40
    removed = tuple(jnp.asarray(a) for a in (ints[0], ints[1], flts[2],
                                             ints[2]))
    mean, std, lam = (jtrainer.rating_mean, jtrainer.rating_std,
                      jtrainer.s.recon_lambda)

    def loss(p):
        out = _jax_out(jtrainer, p, "train", ints[0], ints[1],
                       (noise[:nu], noise[nu:]), train=True, removed=removed)
        target = (flts[0] - mean) / std
        n_valid = max(flts[1].sum(), 1.0)
        total = jnp.sum(0.5 * jnp.sum((out["pred_ratings"] - target) ** 2
                                      * flts[1], axis=1) / n_valid)
        for blk in out["pred_embed"]:
            for key, m in (("user", rmask[:nu]), ("item", rmask[nu:])):
                sq = jnp.sum((blk[key] - out["gt_embed"][key]) ** 2, -1)
                total = total + lam * jnp.sum(sq * m) / max(m.sum(), 1.0)
        return total

    jloss, want = jax.value_and_grad(loss)(jtrainer.params)
    want = convert.params_from_flax(jax.device_get(want))
    stats, got = ttrainer.loss_and_grads(*batch)
    np.testing.assert_allclose(stats["loss"].numpy(), np.asarray(jloss),
                               rtol=loss_rtol)
    assert all(g.dtype == torch.float32 for g in got.values())
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in want.items()})


def _worst(got, want):
    """The largest per-parameter error relative to the parameter's
    largest entry."""
    return max(np.abs(got[k] - w).max() / np.abs(w).max()
               for k, w in want.items())


def _assert_grads(tgrads, wgrads, rel):
    assert sorted(wgrads) == sorted(tgrads)
    for k, wg in wgrads.items():
        assert np.abs(wg).max() > 0, k
        np.testing.assert_allclose(tgrads[k], wg, rtol=0,
                                   atol=rel * np.abs(wg).max(), err_msg=k)


# ---------------------------- feature projection ----------------------------


@pytest.mark.parametrize("recon_fea", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fea_proj_forward_matches_jax(backend, recon_fea):
    jtrainer, ttrainer = _trainers(backend, **FEA,
                                   **{"MODEL.RECON_FEA": recon_fea})
    assert {"fea_map_user_l0.weight", "fea_map_item_l1.bias"} <= set(
        ttrainer.model.state_dict())
    # the next block's input: the decoder's output, joined by the projected
    # features unless the decoder reconstructs them
    assert ttrainer.model.enc_b1.l0.agg_user_item.weight.shape[1] == 13
    assert ttrainer.model.embed_map_b0_user_l1.out_features == (
        13 if recon_fea else 8)
    pu, pi, noise = _eval_inputs(jtrainer)
    want = _jax_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    with torch.no_grad():
        got = _port_out(ttrainer, "test", pu, pi, noise,
                        return_rating_feats=True)
    _assert_forward(got, want, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("recon_fea", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fea_proj_step_matches_jax(backend, recon_fea):
    """One training step's loss, and the gradient of every parameter
    (``fea_map_*`` included)."""
    jtrainer, ttrainer = _trainers(backend, **FEA,
                                   **{"MODEL.RECON_FEA": recon_fea})
    _assert_grads(*_loss_grads(jtrainer, ttrainer), GRAD_TOL[backend])


def test_fea_proj_evaluate_predict_and_export_match_jax():
    jtrainer, ttrainer = _trainers("dense", **FEA)
    for rb, cb in host_batches(jtrainer, 2):
        jtrainer.train_iteration(rb, cb)
        ttrainer.train_iteration(rb, cb)
    for segment in ("valid", "test"):
        np.testing.assert_allclose(ttrainer.evaluate(segment),
                                   jtrainer.evaluate(segment), rtol=2e-4)
    rng = np.random.RandomState(3)
    uu = rng.randint(0, 40, 50).astype(np.int32)
    ii = rng.randint(0, 30, 50).astype(np.int32)
    np.testing.assert_allclose(ttrainer.predict(uu, ii),
                               jtrainer.predict(uu, ii), rtol=2e-4,
                               atol=2e-4)
    art = tserve.export_serving(ttrainer)
    jart = jserve.export_serving(jtrainer)
    for a, b in ((art.user_feats, jart.user_feats),
                 (art.item_feats, jart.item_feats)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    # a ServingState on the same parameters reads the features itself
    state = tserve.ServingState(ttrainer.model_cfg, ttrainer.data_iter,
                                device="cpu",
                                state_dict=ttrainer.model.state_dict())
    assert state.features()[0].shape == (40, 8)
    again = tserve.export_serving(state)
    np.testing.assert_allclose(again.user_feats, art.user_feats, rtol=1e-6,
                               atol=1e-6)


def test_features_are_copied_once_and_not_noise_masked():
    """The trainer's feature tensors are the graph's rows, made once; with
    every embedding masked by the noise, the features still reach the
    predictions."""
    _, ttrainer = _trainers("xla", **FEA)
    fu, fi = ttrainer.features()
    assert ttrainer.features()[0] is fu
    np.testing.assert_array_equal(
        fu.numpy(), ttrainer.data_iter.all_graph.features["user"])
    assert fi.shape == (30, 8) and fi.dtype == torch.float32
    pu, pi, _ = _eval_inputs(ttrainer)
    all_masked = (np.full(40, -1, np.int32), np.full(30, -1, np.int32))
    with torch.no_grad():
        a = _port_out(ttrainer, "test", pu, pi, all_masked)["pred_ratings"]
        ttrainer._features = (fu * 2, fi)
        b = _port_out(ttrainer, "test", pu, pi, all_masked)["pred_ratings"]
    assert (a - b).abs().max() > 1e-3


# ------------------------------ feature-only input ------------------------------


def _feature_only_pair(**overrides):
    """A JAX ``Trainer`` (it builds with DAE; only its step fails) and the
    port's ``ServingState`` on its parameters, feature-only input."""
    overrides = {"GCN.DROPOUT": 0.0, "KERNEL.BACKEND": "xla",
                 **FEATURE_ONLY, **overrides}
    jcfg = small_ml10m_cfg(j_cfg_from_file, "sum", **overrides)
    jit_ = _iterator(JDataIterator, jsyn.synthetic_graph(**GRAPH))
    dims = (40, 30, 10)
    settings = JTrainSettings.from_cfg(jcfg)
    settings.hang_timeout_s = 0.0
    jtrainer = JTrainer(j_build_model_config(jcfg, *dims), jit_, settings)
    jtrainer.params = random_params(jtrainer.params)
    tcfg = small_ml10m_cfg(cfg_from_file, "sum", **overrides)
    tit = _iterator(DataIterator, tsyn.synthetic_graph(**GRAPH))
    state = tserve.ServingState(
        build_model_config(tcfg, *dims), tit, device="cpu",
        state_dict=convert.params_from_flax(jtrainer.params))
    return jtrainer, state, tcfg


@pytest.mark.parametrize("nblocks,dae", [(2, True), (1, False)])
def test_feature_only_forward_matches_jax(nblocks, dae):
    """Without embeddings the input is the projected features alone, and
    the reconstruction target is empty, in both packages."""
    jtrainer, state, _ = _feature_only_pair(
        **{"MODEL.NBLOCKS": nblocks, "MODEL.USE_DAE": dae})
    assert not any(k.startswith(("embed_user", "embed_item"))
                   for k in state.model.state_dict())
    assert state.model.enc_b0.l0.agg_user_item.weight.shape[1] == 5
    pu, pi, noise = _eval_inputs(jtrainer)
    want = _jax_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    with torch.no_grad():
        got = _port_out(state, "test", pu, pi, noise,
                        return_rating_feats=True)
    assert got["gt_embed"] == {} and len(got["pred_embed"]) == (
        nblocks if dae else 0)
    _assert_forward(got, want, dict(rtol=2e-4, atol=2e-4))


def test_feature_only_trains_without_dae_and_refuses_dae():
    """``NBLOCKS 1`` without DAE trains as the JAX package trains it; with
    DAE both of the port's trainers refuse (the JAX full-graph step fails
    on the empty target, its sampled trainer refuses)."""
    jtrainer, ttrainer = _trainers(
        "xla", **FEATURE_ONLY, **{"MODEL.NBLOCKS": 1,
                                  "MODEL.USE_DAE": False})
    for rb, cb in host_batches(jtrainer, 2):
        want = jax.device_get(jtrainer.train_iteration(rb, cb))
        got = ttrainer.train_iteration(rb, cb)
        for name in STATS:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=1e-4, atol=0, err_msg=name)
    _, state, tcfg = _feature_only_pair()
    with pytest.raises(NotImplementedError, match="USE_EMBED"):
        Trainer(state.model_cfg, state.data_iter,
                TrainSettings.from_cfg(tcfg), device="cpu")
    with pytest.raises(KeyError):
        jt, _, _ = _feature_only_pair()
        jt.train_iteration(*host_batches(jt, 1)[0])


# ------------------------------- bf16 compute -------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_forward_matches_jax_and_own_float32(backend):
    jtrainer, ttrainer = _trainers(backend, **BF16)
    assert ttrainer.model.cdt == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ttrainer.model.parameters())
    pu, pi, noise = _eval_inputs(jtrainer)
    want = _jax_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    with torch.no_grad():
        got = _port_out(ttrainer, "test", pu, pi, noise,
                        return_rating_feats=True)
    assert got["pred_ratings"].dtype == torch.float32
    assert got["pred_embed"][0]["user"].dtype == torch.bfloat16
    _assert_forward(got, want, dict(rtol=3e-2, atol=3e-2),
                    dict(rtol=5e-2, atol=5e-2))
    # against the port's own float32 forward on the same parameters
    f32 = STARGCN(dataclasses.replace(ttrainer.model_cfg,
                                      compute_dtype="float32"))
    f32.load_state_dict(ttrainer.model.state_dict())
    ttrainer.model, bf16 = f32, ttrainer.model
    with torch.no_grad():
        ref = _port_out(ttrainer, "test", pu, pi, noise)["pred_ratings"]
    ttrainer.model = bf16
    scale = ref.abs().max()
    assert (got["pred_ratings"] - ref).abs().max() <= 0.05 * scale


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_step_matches_jax(backend):
    """bf16 compute with feature projection: every gradient float32; the
    gradients of the training loss within 3e-2 of each parameter's largest
    entry of the JAX package's, and no farther from the port's float32
    gradients than the JAX package's bf16 gradients are from its own
    (bf16-rounded cotangents in sums that cancel: each package's bf16
    gradients stray from float32 by several percent, so the two packages
    cannot agree to 4e-3); the loss within bf16 tolerance."""
    j16, t16 = _trainers(backend, **BF16, **FEA)
    j32, t32 = _trainers(backend, **FEA)
    port16, jax16 = _loss_grads(j16, t16, loss_rtol=3e-2)
    port32, jax32 = _loss_grads(j32, t32)
    assert _worst(port32, jax32) < GRAD_TOL[backend]
    assert _worst(port16, jax16) < 3e-2
    assert _worst(port16, port32) <= 1.25 * _worst(jax16, jax32) + 4e-3
    assert all(v.dtype == torch.float32 for v in t16.opt.mu.values())


# ------------------------------ per-edge dropout ------------------------------


def test_per_edge_dropout_forces_xla_in_both_packages():
    over = {"GCN.DROPOUT_PER_EDGE": True, "KERNEL.BACKEND": "bitdense"}
    want = j_build_model_config(small_ml10m_cfg(j_cfg_from_file, **over),
                                40, 30, 10)
    got = build_model_config(small_ml10m_cfg(cfg_from_file, **over),
                             40, 30, 10)
    assert got.backend == want.backend == "xla"
    assert got.dropout_per_edge and want.dropout_per_edge


@pytest.mark.parametrize("accum", ["sum", "stack"])
def test_per_edge_dropout_eval_equals_per_node_and_jax(accum):
    jtrainer, ttrainer = _trainers(
        "xla", accum, **{"GCN.DROPOUT_PER_EDGE": True,
                         "GCN.AGG.ORDINAL_SHARING": accum == "stack"})
    pu, pi, noise = _eval_inputs(jtrainer)
    with torch.no_grad():
        got = _port_out(ttrainer, "test", pu, pi, noise,
                        return_rating_feats=True)
        per_node = STARGCN(dataclasses.replace(ttrainer.model_cfg,
                                               dropout_per_edge=False))
        per_node.load_state_dict(ttrainer.model.state_dict())
        ttrainer.model, edge_model = per_node, ttrainer.model
        ref = _port_out(ttrainer, "test", pu, pi, noise)
        ttrainer.model = edge_model
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               ref["pred_ratings"].numpy(), rtol=1e-5,
                               atol=1e-5)
    want = _jax_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    _assert_forward(got, want, dict(rtol=2e-4, atol=2e-4))


def test_per_edge_dropout_masks_each_edge():
    """Every edge of one source gets its own element mask: with a constant
    source row, an identity projection and one destination per edge, each
    output row is its edge's mask over the keep rate."""
    E, feat, rate = 4000, 16, 0.3
    agg = MultiLinkGCNAggregator(feat, feat, 1, dropout_rate=rate,
                                 accum="sum", dropout_per_edge=True)
    with torch.no_grad():
        agg.weight.copy_(torch.eye(feat)[None])
    zeros = torch.zeros(E, dtype=torch.long)
    rel = Relation(num_links=1, edge_src=zeros,
                   edge_dst=torch.arange(E), edge_rating=zeros,
                   support=torch.ones(E))
    x = torch.ones(3, feat)
    out = agg(x, rel, E, train=True,
              generator=torch.Generator().manual_seed(1))
    keep = out != 0
    # the keep rate within 5 standard deviations of 1 - rate
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * np.sqrt(
        rate * (1 - rate) / n)
    torch.testing.assert_close(out[keep], torch.full_like(out[keep],
                                                          1 / (1 - rate)))
    assert len({tuple(r) for r in keep.int().tolist()}) > E // 2
    # eval: no mask
    torch.testing.assert_close(agg(x, rel, E), torch.ones(E, feat))
    with pytest.raises(ValueError, match="flat edge"):
        from stargcn_tpu_torch.models.layers import DenseStatic
        agg(x, Relation(1, dense_static=DenseStatic(
            torch.zeros(1, E, 3), torch.ones(E), torch.ones(3))), E)


def test_per_edge_dropout_trains():
    """A training step with per-edge dropout on: finite statistics, and the
    masks differ from step to step."""
    _, ttrainer = _trainers("xla", **{"GCN.DROPOUT_PER_EDGE": True,
                                      "GCN.DROPOUT": 0.3})
    (rb, cb), = host_batches(ttrainer, 1)
    a = ttrainer.loss_and_grads(rb, cb)[0]["loss"]
    b = ttrainer.loss_and_grads(rb, cb)[0]["loss"]
    assert torch.isfinite(a) and a != b


# ------------------------------- GCN recurrence -------------------------------

RECURRENT = {"GCN.USE_RECURRENT": True, "EMBED.UNITS": 12,
             "GCN.AGG.UNITS": [16, 16], "GCN.OUT.UNITS": [12, 12]}


@pytest.mark.parametrize("backend", ["xla", "bitdense"])
def test_recurrent_layer_matches_jax(backend):
    jtrainer, ttrainer = _trainers(backend, **RECURRENT)
    layers = {k.split(".")[1] for k in ttrainer.model.state_dict()
              if k.startswith("enc_b")}
    assert layers == {"l0"} == set(jtrainer.params["enc_b0"])
    assert ttrainer.model.enc_b0.depth == 2
    pu, pi, noise = _eval_inputs(jtrainer)
    want = _jax_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    with torch.no_grad():
        got = _port_out(ttrainer, "test", pu, pi, noise,
                        return_rating_feats=True)
    _assert_forward(got, want, dict(rtol=2e-4, atol=2e-4))
    _assert_grads(*_loss_grads(jtrainer, ttrainer), GRAD_TOL[backend])


def test_recurrent_layer_needs_equal_widths():
    cfg = build_model_config(small_ml10m_cfg(
        cfg_from_file, **{**RECURRENT, "GCN.OUT.UNITS": [6, 6]}), 40, 30, 10)
    with pytest.raises(ValueError, match="USE_RECURRENT"):
        STARGCN(cfg)
    # one layer deep, the flag gives the ordinary model's parameters
    one = build_model_config(small_ml10m_cfg(
        cfg_from_file, **{"GCN.USE_RECURRENT": True}), 40, 30, 10)
    plain = dataclasses.replace(one, gcn_use_recurrent=False)
    assert list(STARGCN(one).state_dict()) == list(
        STARGCN(plain).state_dict())


# --------------------------------- converter ---------------------------------


@pytest.mark.parametrize("overrides", [
    {**FEA, "MODEL.RECON_FEA": True}, RECURRENT, FEATURE_ONLY],
    ids=["fea_proj", "recurrent", "feature_only"])
def test_converter_round_trip(overrides):
    """``fea_map_*`` and a recurrent ``l0`` go to the port and back, and
    the Adam moments of a trained optax state with them."""
    if overrides is FEATURE_ONLY:
        jtrainer, state, _ = _feature_only_pair()
        jparams = jtrainer.params
        names = set(state.model.state_dict())
        opt_state = jtrainer.opt.init(jparams)
    else:
        jtrainer, ttrainer = _trainers("xla", **overrides)
        jtrainer.train_iteration(*host_batches(jtrainer, 1)[0])
        jparams, opt_state = jtrainer.params, jtrainer.opt_state
        names = set(ttrainer.model.state_dict())
    sd = convert.params_from_flax(jax.device_get(jparams))
    assert set(sd) == names
    back = convert.flax_from_params(sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(
        jax.device_get(jparams)))
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, flat)) == sorted(map(str, back_flat))
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back_flat[path], leaf)
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    state = convert.optimizer_state_from_optax(adam.count, adam.mu, adam.nu)
    assert set(state["mu"]) == names
    count, mu, nu = convert.optimizer_state_to_optax(state)
    assert count == int(adam.count)
    for a, b in zip(jax.tree_util.tree_leaves(mu),
                    jax.tree_util.tree_leaves(jax.device_get(adam.mu))):
        np.testing.assert_array_equal(a, b)


def test_fea_proj_checkpoint_round_trip(tmp_path):
    """A ``USE_FEA_PROJ`` trainer's checkpoint restores into a fresh one."""
    _, a = _trainers("xla", **FEA)
    a.save_dir = str(tmp_path)
    a.train_iteration(*host_batches(a, 1)[0])
    path = a.save_checkpoint("last")
    _, b = _trainers("xla", **FEA)
    b.restore_checkpoint(path)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert b.opt.count == 1
    assert os.path.exists(path)
