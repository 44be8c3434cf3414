"""The port's sampled forward (``stargcn_tpu_torch/models/sampled.py``)
against the JAX package's: plans, packed feeds, outputs, loss and
gradients, on the CPU with the same parameters (moved over by
``convert.params_from_flax``) and dropout 0.

Tolerances: outputs 2e-4 (float32 throughout; the two sum the pooled
messages and the projections in other orders through four aggregation
layers); gradients 1e-4 of each parameter tensor's largest entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (random_params, reference_on_cpu, sampled_cfgs,
                          sampled_graphs, sampled_iterator, seed_planners)
from stargcn_tpu.graph.device import BipartiteGraphData
from stargcn_tpu.graph.sampling import BlockSampler as JBlockSampler
from stargcn_tpu.models import STARGCN as JSTARGCN
from stargcn_tpu.models import sampled as jsm
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.graph.sampling import BlockSampler
from stargcn_tpu_torch.models import STARGCN
from stargcn_tpu_torch.models import sampled as tsm
from stargcn_tpu_torch.train.loop import GraphVariants

OUT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def numpy_reference():
    with reference_on_cpu():
        yield


@pytest.fixture(scope="module")
def setup():
    """Graphs, batch pairs, recon ids and noise arrays shared by the
    tests."""
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
    return jg, tg, pu, pi, recon_u, recon_i, noise_u, noise_i


def jax_params(jg, jcfg, seed=0):
    """The flax tree of the full-graph module for ``jcfg``, with O(1)
    values (``random_params``)."""
    gd = BipartiteGraphData.from_csr(jg["user", "movie"], pad_multiple=64)
    z = jnp.zeros(4, jnp.int32)
    tree = JSTARGCN(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        gd, gd.edge_pad_mask, jnp.arange(30, dtype=jnp.int32),
        jnp.arange(22, dtype=jnp.int32), z, z, train=False)["params"]
    return random_params(tree, seed)


def build_plans(setup, fanout, caps=None, exclude=False, recon=True):
    """The same plan from both packages (the port's with the loop
    planner)."""
    jg, tg, pu, pi, recon_u, recon_i, _, _ = setup
    jcfg, tcfg = sampled_cfgs()
    kw = dict(fanout=fanout, node_pad=32)
    if recon:
        kw.update(recon_user_ids=recon_u, recon_item_ids=recon_i)
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


@pytest.mark.parametrize("fanout,caps,exclude", [
    (-1, None, False), (4, None, True),
    (4, {"user": 64, "item": 48}, True), (3, {"user": 64, "item": 48}, False)])
def test_plans_and_packed_feeds_equal_reference(setup, fanout, caps,
                                                exclude):
    jplan, tplan = build_plans(setup, fanout, caps, exclude)
    ji, jf, jspec = jsm.pack_tree(jplan.as_host_tree())
    ti, tf, tspec = tsm.pack_tree(tplan.as_host_tree())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tf, jf)
    assert ti.dtype == np.int32 and tf.dtype == np.float32
    assert tspec[1] == jspec[1]          # per-leaf (is_float, offset, shape)
    hash(tspec)
    if caps:
        for c in tplan.chains:
            for f in c.frontiers:
                assert (f["user"].size, f["item"].size) == (64, 48)
    # seed= restarts the sampling stream
    _, tg, pu, pi, *_ = setup
    cfg = sampled_cfgs()[1]
    a, b = (tsm.pack_tree(tsm.StackedPlan.build(
        tg, cfg, pu, pi, fanout=3, seed=4).as_host_tree()) for _ in range(2))
    np.testing.assert_array_equal(a[0], b[0])


def test_pack_tree_round_trip(setup):
    _, tplan = build_plans(setup, 4, {"user": 64, "item": 48}, True)
    tree = {"plan": tplan.as_host_tree(), "gt": np.ones(5, np.float32),
            "n": np.arange(3, dtype=np.int64), "none": None,
            "pair": (np.zeros((2, 3), np.int32), np.zeros(0, np.float32))}
    ibuf, fbuf, spec = tsm.pack_tree(tree)
    for bufs in ((ibuf, fbuf),
                 (torch.from_numpy(ibuf), torch.from_numpy(fbuf))):
        back = tsm.unpack_tree(*bufs, spec)
        assert back["none"] is None and isinstance(back["pair"], tuple)
        assert back["plan"]["cross_gather"][0] is None
        want_leaves, got_leaves = [], []
        tsm._flatten(tree, want_leaves)
        tsm._flatten(back, got_leaves)
        assert len(want_leaves) == len(got_leaves) > 20
        for w, g in zip(want_leaves, got_leaves):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # views of the two buffers, not copies
    tb = tsm.unpack_tree(torch.from_numpy(ibuf), torch.from_numpy(fbuf),
                         spec)
    assert tb["plan"]["blocks"][0][0]["user"]["idx"].dtype == torch.int32
    with pytest.raises(TypeError, match="dtype"):
        tsm.pack_tree({"x": np.zeros(2, np.float64)})


@pytest.mark.parametrize("backend,accum,ordinal", [
    ("xla", "sum", False), ("xla", "stack", False), ("pallas", "sum", False),
    ("pallas", "stack", False), ("xla", "sum", True), ("pallas", "sum", True)])
def test_forward_matches_reference(setup, backend, accum, ordinal):
    """Eval forward over a capped fanout-4 plan with excluded batch edges,
    recon targets and masked noise, on both backends."""
    jg, tg, pu, pi, _, _, noise_u, noise_i = setup
    jplan, tplan = build_plans(setup, 4, {"user": 64, "item": 48}, True)
    jcfg, tcfg = sampled_cfgs(agg_accum=accum, agg_ordinal_sharing=ordinal)
    params = jax_params(jg, jcfg)
    want = jsm.sampled_forward(params, jcfg, jplan, noise_u, noise_i,
                               backend=backend)
    with torch.no_grad():
        got = tsm.sampled_forward(
            convert.params_from_flax(params), tcfg, tplan, noise_u, noise_i,
            backend=backend)
    assert got["pred_ratings"].shape == (2, 12)
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               want["pred_ratings"], **OUT_TOL)
    for b in range(2):
        for t in ("user", "item"):
            np.testing.assert_allclose(got["pred_embed"][b][t].numpy(),
                                       want["pred_embed"][b][t], **OUT_TOL)
            np.testing.assert_array_equal(got["recon_ok"][b][t].numpy(),
                                          want["recon_ok"][b][t])
    for t in ("user", "item"):
        np.testing.assert_allclose(got["gt_embed"][t].numpy(),
                                   want["gt_embed"][t], rtol=0, atol=0)


@pytest.mark.parametrize("backend,accum", [("xla", "sum"), ("pallas", "sum"),
                                           ("xla", "stack")])
def test_all_neighbors_equals_the_full_graph_forward(setup, backend, accum):
    """With fanout -1 and dropout off the sampled forward reproduces the
    port's full-graph ``STARGCN`` forward on the target pairs, masked
    noise included."""
    jg, tg, pu, pi, _, _, noise_u, noise_i = setup
    jcfg, tcfg = sampled_cfgs(agg_accum=accum)
    it = sampled_iterator(DataIterator, tg)
    model = STARGCN(tcfg)
    model.load_state_dict(convert.params_from_flax(jax_params(jg, jcfg, 1)))
    variants = GraphVariants(tcfg, it, torch.device("cpu"))
    with torch.no_grad():
        full = model(torch.from_numpy(noise_u), torch.from_numpy(noise_i),
                     torch.from_numpy(pu).long(), torch.from_numpy(pi).long(),
                     variants.degrees("test"), variants.bit_pack("test"))
        plan = tsm.StackedPlan.build(it.test_graph, tcfg, pu, pi, fanout=-1,
                                     node_pad=32)
        out = tsm.sampled_forward(model, tcfg, plan, noise_u, noise_i,
                                  backend=backend)
    np.testing.assert_allclose(out["pred_ratings"].numpy(),
                               full["pred_ratings"].numpy(), **OUT_TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_loss_and_gradients_match_reference(setup, backend):
    jg, tg, pu, pi, _, _, noise_u, noise_i = setup
    jplan, tplan = build_plans(setup, 4, {"user": 64, "item": 48}, True)
    jcfg, tcfg = sampled_cfgs()
    params = jax_params(jg, jcfg, 2)
    rng = np.random.RandomState(5)
    gt = rng.choice([1.0, 2.0, 3.0], 12).astype(np.float32)
    valid = np.ones(12, np.float32)
    valid[-2:] = 0

    def jloss(p):
        return jsm.sampled_loss(p, jcfg, jplan.as_device(), noise_u, noise_i,
                                jnp.asarray(gt), jnp.asarray(valid), 2.1, 0.8,
                                0.1, backend=backend)

    (want, (want_rl, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    named = {k: v.requires_grad_() for k, v in
             convert.params_from_flax(params).items()}
    got, (got_rl, preds) = tsm.sampled_loss(
        named, tcfg, tplan, noise_u, noise_i, torch.from_numpy(gt),
        torch.from_numpy(valid), 2.1, 0.8, 0.1, backend=backend)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(got_rl.detach().numpy(), want_rl, rtol=1e-4)
    assert preds.shape == (2, 12)
    grads = torch.autograd.grad(got, list(named.values()))
    want_grads = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(want_grads) == sorted(named)
    for (k, _), g in zip(named.items(), grads):
        w = want_grads[k].numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_every_differentiable_gather_is_an_index_select(setup, backend):
    """Under fixed caps every padded slot names row 0.  The gradient of
    advanced indexing (``x[idx]``) walks equal indices serially on a card,
    that of ``index_select`` is an ``index_add_``: no ``IndexBackward``
    node may appear in the loss's graph."""
    _, tg, pu, pi, _, _, noise_u, noise_i = setup
    _, tplan = build_plans(setup, 4, {"user": 64, "item": 48}, True)
    cfg = sampled_cfgs()[1]
    loss, _ = tsm.sampled_loss(
        STARGCN(cfg), cfg, tplan, noise_u, noise_i, torch.ones(12),
        torch.ones(12), 2.0, 1.0, 0.1, backend=backend)
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(fn for fn, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert "IndexSelectBackward0" in names
    assert not [n for n in names if n.startswith("IndexBackward")], names


def test_dropout_draws_from_the_generator(setup):
    """torch and JAX draw other masks, so with dropout on only the rate and
    the stream are held: a fresh generator with the same seed repeats the
    output, another seed changes it, eval ignores it."""
    _, tg, pu, pi, _, _, noise_u, noise_i = setup
    _, tplan = build_plans(setup, 4, {"user": 64, "item": 48}, True)
    cfg = sampled_cfgs(gcn_dropout=0.5)[1]
    model = STARGCN(cfg, generator=torch.Generator().manual_seed(0))

    def run(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tsm.sampled_forward(model, cfg, tplan, noise_u, noise_i,
                                       train=train, generator=gen
                                       )["pred_ratings"]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(2, train=False))
    with pytest.raises(ValueError, match="generator"):
        tsm.sampled_forward(model, cfg, tplan, noise_u, noise_i, train=True)
    x = torch.ones(200, 50)
    kept = tsm._dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    assert abs(float((kept != 0).float().mean()) - 0.5) < 0.02
    assert set(kept.unique().tolist()) == {0.0, 2.0}


def test_refuses_what_is_not_ported(setup):
    _, tg, pu, pi, _, _, noise_u, noise_i = setup
    _, tplan = build_plans(setup, 4, None, False)
    cfg = sampled_cfgs()[1]
    model = STARGCN(cfg)
    # the mesh is ported (tests/test_torch_sampled_mesh.py); it takes a
    # parallel.Mesh.
    with pytest.raises(TypeError, match="row_sharding"):
        tsm.sampled_forward(model, cfg, tplan, noise_u, noise_i,
                            row_sharding=object())
    # remat and bf16 are ported (tests/test_torch_sampled_options.py);
    # feature projection needs the features.
    fea = dataclasses.replace(cfg, use_fea_proj=True)
    with pytest.raises(ValueError, match="features"):
        tsm.sampled_forward(model, fea, tplan, noise_u, noise_i)
    with pytest.raises(ValueError, match="backend"):
        tsm.sampled_forward(model, cfg, tplan, noise_u, noise_i,
                            backend="ell")
