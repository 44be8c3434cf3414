"""The port's training forward and its gradients against the JAX package's,
on the ``bitdense`` backend with dropout 0 and ``removed_pairs`` from a real
batch, and the port's dropout on its own.

Tolerances: outputs 2e-4 (the eval forward's, see ``test_torch_model.py``);
each parameter's gradient 1e-4 of its largest entry (float32, other
summation orders through four aggregation layers and back)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import build_trainers, host_batches
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.models import STARGCN
from stargcn_tpu_torch.models.aggregators import MultiLinkGCNAggregator
from stargcn_tpu_torch.models.common import dropout


def _step_inputs(trainer, batch):
    """The four host arrays of one step, from either package's trainer."""
    return trainer._prep_host_arrays(*batch)


def _functional(rng, out_shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in out_shapes.items()}


@pytest.mark.parametrize("accum,overrides", [
    ("sum", {}),
    ("stack", {}),
    ("sum", {"GCN.AGG.ORDINAL_SHARING": True}),
    ("sum", {"GCN.AGG.NORM_SYMM": False}),
])
def test_train_forward_and_gradients_match_jax(accum, overrides):
    jtrainer, ttrainer = build_trainers(accum, **overrides)
    batch = host_batches(jtrainer, 1)[0]
    ints, flts, noise, rmask = _step_inputs(jtrainer, batch)
    for a, b in zip(_step_inputs(ttrainer, batch), (ints, flts, noise, rmask)):
        np.testing.assert_array_equal(a, b)
    assert flts[2].sum() == flts[1].sum() > 0     # every batch pair is an edge
    nu, B = jtrainer.model_cfg.num_users, ints.shape[1]
    rng = np.random.RandomState(9)
    w = _functional(rng, {"r": (2, B), "u0": (nu, 8), "i0": (30, 8),
                          "u1": (nu, 8), "i1": (30, 8)})

    def scalar(out, xp):
        total = xp.sum(out["pred_ratings"] * xp.asarray(w["r"]))
        for b in range(2):
            total = total + xp.sum(out["pred_embed"][b]["user"]
                                   * xp.asarray(w[f"u{b}"]))
            total = total + xp.sum(out["pred_embed"][b]["item"]
                                   * xp.asarray(w[f"i{b}"]))
        return total

    jmodel = jtrainer.model.clone(cfg=dataclasses.replace(
        jtrainer.model_cfg, bit_impl="xla"))
    removed = (jnp.asarray(ints[0]), jnp.asarray(ints[1]),
               jnp.asarray(flts[2]), jnp.asarray(ints[2]))

    def jloss(params):
        out = jmodel.apply(
            {"params": params}, jtrainer.graph_data,
            jtrainer.edge_masks["train"], jnp.asarray(noise[:nu]),
            jnp.asarray(noise[nu:]), jnp.asarray(ints[0]),
            jnp.asarray(ints[1]), removed_pairs=removed,
            variant_degrees=jtrainer.variant_degrees["train"],
            ell_pack=jtrainer._ell_pack("train"), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)})
        return scalar(out, jnp), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jtrainer.params)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pu, pi, rr = (t(ints[k]).long() for k in range(3))
    got = ttrainer.model(
        t(noise[:nu]), t(noise[nu:]), pu, pi,
        ttrainer.variants.degrees("train"),
        ttrainer.variants.bit_pack("train"), (pu, pi, t(flts[2]), rr),
        train=True, generator=torch.Generator().manual_seed(0))
    names, params = zip(*ttrainer.model.named_parameters())
    tgrads = dict(zip(names, torch.autograd.grad(scalar(got, torch),
                                                 params)))

    np.testing.assert_allclose(got["pred_ratings"].detach().numpy(),
                               np.asarray(want["pred_ratings"]),
                               rtol=2e-4, atol=2e-4)
    for b in range(2):
        for key in ("user", "item"):
            np.testing.assert_allclose(
                got["pred_embed"][b][key].detach().numpy(),
                np.asarray(want["pred_embed"][b][key]), rtol=2e-4, atol=2e-4)
    wgrads = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(wgrads) == sorted(tgrads)
    for k, wg in wgrads.items():
        wg = wg.numpy()
        assert np.abs(wg).max() > 0, k
        np.testing.assert_allclose(tgrads[k].numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max(), err_msg=k)


def test_removed_pairs_change_the_step_graph():
    """With ``removed_pairs`` the batch's edges are out of the graph: the
    forward differs from the one on the whole train graph, and equals the
    forward on packs built without those edges."""
    _, ttrainer = build_trainers("sum")
    batch = host_batches(ttrainer, 1)[0]
    ints, flts, noise, _ = _step_inputs(ttrainer, batch)
    nu = ttrainer.model_cfg.num_users
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pu, pi, rr = (t(ints[k]).long() for k in range(3))
    v = ttrainer.variants

    def run(degrees, pack, removed):
        with torch.no_grad():
            return ttrainer.model(t(noise[:nu]), t(noise[nu:]), pu, pi,
                                  degrees, pack, removed)["pred_ratings"]

    with_removal = run(v.degrees("train"), v.bit_pack("train"),
                       (pu, pi, t(flts[2]), rr))
    whole = run(v.degrees("train"), v.bit_pack("train"), None)
    assert (with_removal - whole).abs().max() > 1e-3

    from stargcn_tpu_torch.ops.bitdense import build_bit_pack

    eu, ei, er, pad = v._edges
    mask = v.edge_mask("train") * pad
    batch_keys = set(zip(ints[0].tolist(), ints[1].tolist()))
    keep = np.array([(a, b) not in batch_keys for a, b in zip(eu, ei)])
    mask = mask * keep
    pack = build_bit_pack(eu, ei, er, mask, nu, 30, 10, "cpu")
    deg = tuple(torch.from_numpy(np.bincount(e, weights=mask, minlength=n)
                                 .astype(np.float32))
                for e, n in ((eu, nu), (ei, 30)))
    np.testing.assert_allclose(with_removal.numpy(),
                               run(deg, pack, None).numpy(),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(NotImplementedError, match="3-tuple"):
        run(v.degrees("train"), v.bit_pack("train"), (pu, pi, t(flts[2])))


def test_dropout_function():
    gen = torch.Generator().manual_seed(5)
    x = torch.ones(400, 50)
    assert dropout(x, 0.3, False, gen) is x          # eval: the identity
    assert dropout(x, 0.0, True, gen) is x
    y = dropout(x, 0.3, True, gen)
    kept = y != 0
    n = x.numel()
    sigma = np.sqrt(0.3 * 0.7 / n)
    assert abs(float(kept.float().mean()) - 0.7) < 3 * sigma
    assert torch.allclose(y[kept], torch.tensor(1.0 / 0.7))
    # same seed -> same mask; the stream moves on between calls
    a = dropout(x, 0.3, True, torch.Generator().manual_seed(8))
    b = dropout(x, 0.3, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, y)
    assert torch.count_nonzero(dropout(x, 1.0, True, gen)) == 0


def test_aggregator_never_drops_the_bias_column():
    """With zero weights the output is the bias carried through the
    pooling on the ones column: dropout on the source features, at any
    rate, leaves it as it is."""
    _, ttrainer = build_trainers("sum")
    from stargcn_tpu_torch.models.stargcn import _build_bit_static_operands

    v = ttrainer.variants
    bit_u, _ = _build_bit_static_operands(
        ttrainer.model_cfg, v.bit_pack("train"), *v.degrees("train"))
    agg = MultiLinkGCNAggregator(8, 16, 10, dropout_rate=0.9, accum="sum")
    with torch.no_grad():
        agg.weight.zero_()
        agg.bias.copy_(torch.randn(10, 16))
    x = torch.randn(30, 8)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        dropped = agg(x, bit_u, train=True, generator=gen)
        kept = agg(x, bit_u, train=False)
    assert torch.allclose(dropped, kept, atol=1e-6)
    assert kept.abs().max() > 0
    # and with weights, training mode does change the output
    with torch.no_grad():
        agg.weight.copy_(torch.randn(10, 8, 16))
        assert not torch.allclose(agg(x, bit_u, train=True, generator=gen),
                                  agg(x, bit_u, train=False))


def test_model_dropout_is_seeded_and_off_in_eval():
    _, ttrainer = build_trainers("sum", **{"GCN.DROPOUT": 0.5})
    model = ttrainer.model
    assert isinstance(model, STARGCN) and model.cfg.gcn_dropout == 0.5
    pu = torch.arange(8)
    v = ttrainer.variants

    def run(train, seed):
        with torch.no_grad():
            return model(None, None, pu, pu, v.degrees("train"),
                         v.bit_pack("train"), train=train,
                         generator=torch.Generator().manual_seed(seed)
                         )["pred_ratings"]

    assert torch.equal(run(False, 1), run(False, 2))
    assert torch.equal(run(True, 1), run(True, 1))
    assert not torch.equal(run(True, 1), run(True, 2))
    assert not torch.equal(run(True, 1), run(False, 1))
