"""The chunked-ELL backend (``KERNEL.BACKEND: ell``) under the model options,
against the JAX package's ``ell`` on the CPU: feature projection
(``MODEL.USE_FEA_PROJ``, with and without ``MODEL.RECON_FEA``), bf16 compute
(``MODEL.COMPUTE_DTYPE``) and one encoder layer at every depth
(``GCN.USE_RECURRENT``).  The eval-mode forward on the test variant, then
one training step's loss and the gradient of every parameter.

The ``ell`` model takes a batch's removed pairs as a correction to its
packs, not folded into the mask, so the JAX training forward here passes
them as ``removed_pairs`` with the variant's mask unchanged (the helper of
``tests/test_torch_model_options.py`` folds them into the mask, as the
``xla`` model takes them).

Tolerances are those of ``tests/test_torch_model_options.py`` for each
dtype: float32 forward outputs 2e-4, gradients 1e-4 of each parameter's
largest entry; bf16 predictions 3e-2, reconstructed embeddings 5e-2,
gradients 3e-2 of each parameter's largest entry and the loss 3e-2
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import build_trainers, host_batches
from stargcn_tpu_torch import convert
from test_torch_model_options import (BF16, FEA, GRAD_TOL, RECURRENT,
                                      _assert_forward, _assert_grads,
                                      _eval_inputs, _port_out, _worst)

ELL = {"KERNEL.BACKEND": "ell", "KERNEL.ELL_K": 4, "KERNEL.ELL_CHUNK": 32}
OPTIONS = {
    "fea_proj": FEA,
    "fea_proj_recon": {**FEA, "MODEL.RECON_FEA": True},
    "bf16": BF16,
    "bf16_fea_proj": {**BF16, **FEA},
    "recurrent": RECURRENT,
}
F32_TOL = dict(fwd=dict(rtol=2e-4, atol=2e-4), embed=None,
               grad=GRAD_TOL["xla"], loss=1e-4)
BF16_TOL = dict(fwd=dict(rtol=3e-2, atol=3e-2),
                embed=dict(rtol=5e-2, atol=5e-2), grad=3e-2, loss=3e-2)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _tol(name):
    return BF16_TOL if name.startswith("bf16") else F32_TOL


def _trainers(name):
    jtrainer, ttrainer = build_trainers("sum", **ELL, **OPTIONS[name])
    assert jtrainer.model_cfg.backend == ttrainer.model_cfg.backend == "ell"
    # Made outside any trace: the JAX trainer caches its first features.
    jtrainer.features()
    return jtrainer, ttrainer


def _jax_ell_out(jtrainer, params, segment, pu, pi, noise, train=False,
                 removed=None):
    """The JAX ``ell`` model on a variant, features included; ``removed``
    (the host-lookup 4-tuple) goes to the model as a correction, the mask
    stays the variant's."""
    fu, fi = jtrainer.features()
    return jtrainer.model.apply(
        {"params": params}, jtrainer.graph_data, jtrainer.edge_masks[segment],
        jnp.asarray(noise[0]), jnp.asarray(noise[1]), jnp.asarray(pu),
        jnp.asarray(pi), user_features=fu, item_features=fi,
        variant_degrees=jtrainer.variant_degrees[segment],
        ell_pack=jtrainer._ell_pack(segment), removed_pairs=removed,
        train=train, rngs={"dropout": jax.random.PRNGKey(0)},
        return_rating_feats=not train)


def _ell_loss_grads(jtrainer, ttrainer, loss_rtol):
    """One step's training loss (rating + reconstruction, the batch's
    edges removed) and its gradients in both packages, the losses held
    within ``loss_rtol``: ``(port, jax)`` numpy dicts by port name."""
    batch = host_batches(jtrainer, 1)[0]
    ints, flts, noise, rmask = jtrainer._prep_host_arrays(*batch)
    assert jtrainer.do_remove and flts[2].sum() > 0
    nu = 40
    removed = tuple(jnp.asarray(a) for a in (ints[0], ints[1], flts[2],
                                             ints[2]))
    mean, std, lam = (jtrainer.rating_mean, jtrainer.rating_std,
                      jtrainer.s.recon_lambda)

    def loss(p):
        out = _jax_ell_out(jtrainer, p, "train", ints[0], ints[1],
                           (noise[:nu], noise[nu:]), train=True,
                           removed=removed)
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


@pytest.mark.parametrize("name", list(OPTIONS))
def test_ell_forward_matches_jax(name):
    jtrainer, ttrainer = _trainers(name)
    tol = _tol(name)
    pu, pi, noise = _eval_inputs(jtrainer)
    want = _jax_ell_out(jtrainer, jtrainer.params, "test", pu, pi, noise)
    with torch.no_grad():
        got = _port_out(ttrainer, "test", pu, pi, noise,
                        return_rating_feats=True)
    assert got["pred_ratings"].dtype == torch.float32
    assert got["pred_embed"][0]["user"].dtype == (
        torch.bfloat16 if name.startswith("bf16") else torch.float32)
    _assert_forward(got, want, tol["fwd"], tol["embed"])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_ell_step_matches_jax(name):
    """The gradient of every parameter (``fea_map_*`` and the recurrent
    ``l0`` included) of one step with the batch's edges removed."""
    jtrainer, ttrainer = _trainers(name)
    tol = _tol(name)
    port, ref = _ell_loss_grads(jtrainer, ttrainer, tol["loss"])
    if name.startswith("bf16"):
        assert sorted(port) == sorted(ref)
        assert _worst(port, ref) < tol["grad"]
    else:
        _assert_grads(port, ref, tol["grad"])
