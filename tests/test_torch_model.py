"""The port's STAR-GCN eval forward against the JAX package's, on the
``bitdense`` backend with the same parameters (moved over by
``convert.params_from_flax``).

Tolerance 2e-4: float32 throughout; the two sum the bit-pooled messages
and the projections in different orders, through four aggregation layers
and the rating head."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import build_pair
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.models import STARGCN


@pytest.fixture(scope="module")
def pair_sum():
    return build_pair("sum")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_params_round_trip(pair_sum):
    trainer, state = pair_sum
    sd = convert.params_from_flax(trainer.params)
    want = dict(_flat(trainer.params))
    got = dict(_flat(convert.flax_from_params(sd)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], a, err_msg="/".join(path))
    # One to one onto the port's module tree, shapes included.
    model_sd = state.model.state_dict()
    assert sorted(sd) == sorted(model_sd)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(model_sd[k].shape), k
    # A flax Dense kernel (in, out) is an nn.Linear weight (out, in).
    k = np.asarray(trainer.params["rating_user_proj_b1"]["kernel"])
    np.testing.assert_array_equal(sd["rating_user_proj_b1.weight"].numpy(),
                                  k.T)


def _jax_forward(trainer, segment, pu, pi):
    it = trainer.data_iter
    noise = it.evaluate_embed_noise_dict
    model = trainer.model.clone(cfg=dataclasses.replace(
        trainer.model_cfg, bit_impl="xla"))
    return model.apply(
        {"params": trainer.params}, trainer.graph_data,
        trainer.edge_masks[segment], jnp.asarray(noise["user"]),
        jnp.asarray(noise["movie"]), jnp.asarray(pu), jnp.asarray(pi),
        variant_degrees=trainer.variant_degrees[segment],
        ell_pack=trainer._ell_pack(segment), train=False,
        return_rating_feats=True)


def _port_forward(state, segment, pu, pi, model=None):
    noise = state.data_iter.evaluate_embed_noise_dict
    with torch.inference_mode():
        return (model or state.model)(
            torch.from_numpy(noise["user"]), torch.from_numpy(noise["movie"]),
            torch.from_numpy(pu), torch.from_numpy(pi),
            state.variants.degrees(segment), state.variants.bit_pack(segment),
            return_rating_feats=True)


@pytest.mark.parametrize("accum,segment", [
    ("sum", "test"), ("sum", "valid"), ("stack", "test")])
def test_forward_matches_jax(pair_sum, accum, segment):
    trainer, state = pair_sum if accum == "sum" else build_pair(accum)
    rng = np.random.RandomState(5)
    pu = rng.randint(0, 40, 64).astype(np.int32)
    pi = rng.randint(0, 30, 64).astype(np.int32)
    want = _jax_forward(trainer, segment, pu, pi)
    got = _port_forward(state, segment, pu, pi)
    assert tuple(got["pred_ratings"].shape) == (2, 64)
    np.testing.assert_allclose(got["pred_ratings"].numpy(),
                               np.asarray(want["pred_ratings"]),
                               rtol=2e-4, atol=2e-4)
    for key in ("user", "item"):
        np.testing.assert_allclose(got["rating_feats"][key].numpy(),
                                   np.asarray(want["rating_feats"][key]),
                                   rtol=2e-4, atol=2e-4, err_msg=key)
    for b in range(2):
        for key in ("user", "item"):
            np.testing.assert_allclose(
                got["pred_embed"][b][key].numpy(),
                np.asarray(want["pred_embed"][b][key]),
                rtol=2e-4, atol=2e-4, err_msg=f"block {b} {key}")


def test_plain_impl_equals_kernel_wrapper_on_cpu(pair_sum):
    """On the CPU the kernel wrapper is its plain version: the two
    ``bit_impl`` routes give the same forward bit for bit."""
    _, state = pair_sum
    pu = np.arange(8, dtype=np.int32)
    a = _port_forward(state, "test", pu, pu)
    plain = STARGCN(dataclasses.replace(state.model_cfg, bit_impl="xla"))
    plain.load_state_dict(state.model.state_dict())
    b = _port_forward(state, "test", pu, pu, model=plain.eval())
    np.testing.assert_array_equal(a["pred_ratings"].numpy(),
                                  b["pred_ratings"].numpy())


def test_seeded_init_follows_flax_scheme(pair_sum):
    _, state = pair_sum
    cfg = state.model_cfg
    m1 = STARGCN(cfg, generator=torch.Generator().manual_seed(7))
    m2 = STARGCN(cfg, generator=torch.Generator().manual_seed(7))
    for (k, v1), v2 in zip(m1.state_dict().items(),
                           m2.state_dict().values()):
        assert torch.equal(v1, v2), k
    emb = m1.embed_user.weight
    assert emb.abs().max() <= 0.1 and emb.std() > 0.03
    for name, p in m1.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
    w = m1.rating_user_proj_b0.weight            # (out, in): fan-in = in
    assert w.abs().max() <= np.sqrt(3.0 / w.shape[1])
    agg = m1.enc_b0.l0.agg_user_item.weight      # (R, in, U)
    assert agg.abs().max() <= np.sqrt(3.0 / (agg.shape[0] * agg.shape[1]))


def test_unported_paths_raise(pair_sum):
    """The ``ell`` backend (and ``pallas``, a sampled-mode name) and
    per-edge dropout off the flat edge arrays raise; the model options that
    are ported build and run on ``bitdense`` (held against the JAX package
    in ``tests/test_torch_model_options.py``); feature projection needs the
    raw feature widths."""
    _, state = pair_sum
    pu = torch.zeros(1, dtype=torch.long)
    for field, value in (("backend", "ell"), ("backend", "pallas"),
                         ("dropout_per_edge", True)):
        cfg = dataclasses.replace(state.model_cfg, **{field: value})
        with pytest.raises(NotImplementedError):
            model = STARGCN(cfg)
            model(None, None, pu, pu, state.variants.degrees("test"),
                  state.variants.bit_pack("test"))
    bf16 = dataclasses.replace(state.model_cfg, compute_dtype="bfloat16")
    out = STARGCN(bf16)(None, None, pu, pu, state.variants.degrees("test"),
                        state.variants.bit_pack("test"))
    assert out["pred_ratings"].dtype == torch.float32
    fea = dataclasses.replace(state.model_cfg, use_fea_proj=True)
    with pytest.raises(ValueError, match="feature_dims"):
        STARGCN(fea)
    with pytest.raises(ValueError, match="unknown compute dtype"):
        STARGCN(dataclasses.replace(state.model_cfg, compute_dtype="int8"))


@pytest.mark.parametrize("field,value,match", [
    ("backend", "ell", "ell"),
    ("dropout_per_edge", True, "DROPOUT_PER_EDGE"),
])
def test_ell_and_per_edge_dropout_still_refused(pair_sum, field, value,
                                                match):
    """The ``dense`` and ``xla`` backends build, and ``xla`` with
    ``GCN.DROPOUT_PER_EDGE``; the ``ell`` backend and per-edge dropout on
    ``bitdense`` are still refused, by name."""
    _, state = pair_sum
    for backend in ("dense", "xla"):
        STARGCN(dataclasses.replace(state.model_cfg, backend=backend))
    STARGCN(dataclasses.replace(state.model_cfg, backend="xla",
                                dropout_per_edge=True))
    with pytest.raises(NotImplementedError, match=match):
        STARGCN(dataclasses.replace(state.model_cfg, **{field: value}))
