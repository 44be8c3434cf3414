"""The port's bitdense ops against the JAX package's: pack bytes, the
``bit_expand_matmul`` wrapper (its plain version on the CPU) against the
XLA model and the Pallas kernel in interpret mode, and the multi-link
aggregation on the same weights.

Tolerances: 1e-5 for the pooled sums (f32 sums of the same terms in
another order), 2e-4 for the aggregation (adds a projection matmul)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stargcn_tpu.models.layers import BitStatic as JBitStatic
from stargcn_tpu.ops import bitdense as jbd
from stargcn_tpu_torch.models.layers import BitStatic
from stargcn_tpu_torch.ops import bitdense as tbd


def _edges(rng, num_dst, num_src, num_edges, R):
    dst = rng.randint(0, num_dst, num_edges).astype(np.int32)
    src = rng.randint(0, num_src, num_edges).astype(np.int32)
    rat = rng.randint(0, R, num_edges).astype(np.int32)
    return dst, src, rat


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("R", [1, 3, 10])
def test_pack_bits_bytes_identical(rng, R):
    D, S_n = 37, 23
    dst, src, rat = _edges(rng, D, S_n, 300, R)
    mask = (rng.rand(dst.size) > 0.3).astype(np.float32)
    for m in (None, mask):
        got, gd8 = tbd.pack_bits(dst, src, rat, R, D, S_n, mask=m)
        want, wd8 = jbd.pack_bits(dst, src, rat, R, D, S_n, mask=m)
        assert gd8 == wd8 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))


def test_build_bit_pack_layouts(rng):
    R, Nu, Ni = 3, 29, 17
    u, i, r = _edges(rng, Nu, Ni, 120, R)
    mask = np.ones(u.size, np.float32)
    got = tbd.build_bit_pack(u, i, r, mask, Nu, Ni, R, device="cpu")
    want = jbd.build_bit_pack(u, i, r, mask, Nu, Ni, R)
    for t in ("user", "item"):
        for k in ("pf", "pb"):
            np.testing.assert_array_equal(got[t][k].numpy(),
                                          np.asarray(want[t][k]))
    assert got["user"]["pf"] is got["item"]["pb"]


def _feats(rng, rows, F):
    """Source features scaled by 1/sqrt(rows), so a dense row's sum stays
    O(1) and f32 summation order moves it by well under 1e-5."""
    return (rng.randn(rows, F) / np.sqrt(rows)).astype(np.float32)


def _packed(rng, R, dense):
    """A pack from random edges (sparse) or random bytes (dense)."""
    D, S_n = 29, 17
    dst, src, rat = _edges(rng, D, S_n, 150, R)
    P, d8 = jbd.pack_bits(dst, src, rat, R, D, S_n)
    P = np.asarray(P)
    if dense:
        P = rng.randint(0, 256, P.shape).astype(np.uint8)
    return P, d8


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3, 10])
def test_expand_matches_xla(rng, R, F, dense):
    P, d8 = _packed(rng, R, dense)
    x = _feats(rng, P.shape[1], F)
    got = tbd.bit_expand_matmul(torch.from_numpy(P), torch.from_numpy(x),
                                R, d8)
    want = jbd.xla_expand_matmul(jnp.asarray(P), jnp.asarray(x), R, d8)
    assert got.shape == (R, 8, d8, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3])
def test_expand_matches_pallas_interpret(rng, R, F, dense):
    """The Pallas kernel rounds x to bf16 inside; the port's CPU path is
    fed the bf16-rounded x."""
    P, d8 = _packed(rng, R, dense)
    x = _feats(rng, P.shape[1], F)
    want = jbd.bit_expand_matmul(jnp.asarray(P), jnp.asarray(x), R, d8,
                                 interpret=True)
    got = tbd.bit_expand_matmul(torch.from_numpy(P),
                                torch.from_numpy(_bf16(x)), R, d8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("R", [1, 3])
def test_pool_matches_numpy_golden(rng, R):
    P, d8 = _packed(rng, R, dense=False)
    x = _feats(rng, P.shape[1], 5)
    P_t = torch.from_numpy(P)
    # p_bwd is read by the backward only; the forward never looks at it.
    got = tbd.bit_pool_rated(torch.from_numpy(x), P_t, P_t, R, d8, d8)
    golden = jbd.ref_bit_pool(x, P, R, d8)
    np.testing.assert_allclose(got.numpy(), golden, rtol=1e-5, atol=1e-5)
    plain = tbd.bit_pool_rated(torch.from_numpy(x), P_t, P_t, R, d8, d8,
                               impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_expand_chunked_equals_unchunked(rng):
    P, d8 = _packed(rng, 3, dense=True)
    P_t = torch.from_numpy(P)
    # Small integers sum exactly in f32 in any order, so the two chunkings
    # must agree bit for bit.
    x = torch.from_numpy(rng.randint(-4, 5, (P.shape[1], 9)).astype(
        np.float32))
    whole = tbd.xla_expand_matmul(P_t, x, 3, d8)
    rows = tbd.xla_expand_matmul(P_t, x, 3, d8,
                                 chunk_bytes=8 * P.shape[1] * 4 * 7)
    np.testing.assert_array_equal(rows.numpy(), whole.numpy())


def test_expand_bf16_input_sums_in_f32(rng):
    P, d8 = _packed(rng, 3, dense=True)
    x = _bf16(_feats(rng, P.shape[1], 7))
    got = tbd.bit_expand_matmul(torch.from_numpy(P),
                                torch.from_numpy(x).to(torch.bfloat16), 3, d8)
    want = tbd.bit_expand_matmul(torch.from_numpy(P), torch.from_numpy(x),
                                 3, d8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_expand_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    P = torch.zeros((8, 1024), dtype=torch.uint8, device="meta")
    x = torch.zeros((1024, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbd.bit_expand_matmul(P, x, 1, 8)


def test_resolve_impl():
    for name in ("auto", "pallas"):
        assert tbd.resolve_impl(name) == "kernel"
    assert tbd.resolve_impl("xla") == "plain"
    assert tbd.resolve_impl("pallas16") == "kernel16"
    with pytest.raises(ValueError):
        tbd.resolve_impl("nope")


@pytest.mark.parametrize("ordinal", [False, True])
@pytest.mark.parametrize("accum", ["sum", "stack"])
def test_multi_link_aggregate_matches(rng, accum, ordinal):
    R, Nu, Ni, Fin, U = 10, 41, 23, 6, 4
    u, i, r = _edges(rng, Nu, Ni, 200, R)
    mask = (rng.rand(u.size) > 0.2).astype(np.float32)
    jpack = jbd.build_bit_pack(u, i, r, mask, Nu, Ni, R)
    tpack = tbd.build_bit_pack(u, i, r, mask, Nu, Ni, R, device="cpu")
    x = rng.randn(Ni, Fin).astype(np.float32)       # item -> user direction
    weight = rng.randn(R, Fin, U).astype(np.float32)
    bias = rng.randn(R, U).astype(np.float32)
    dst_scale = rng.rand(Nu).astype(np.float32)
    src_scale = rng.rand(Ni).astype(np.float32)
    d8_dst = jpack["user"]["pf"].shape[0] // R
    d8_src = jpack["user"]["pb"].shape[0] // R
    jbs = JBitStatic(p_fwd=jpack["user"]["pf"], p_bwd=jpack["user"]["pb"],
                     dst_scale=jnp.asarray(dst_scale),
                     src_scale=jnp.asarray(src_scale),
                     d8_dst=d8_dst, d8_src=d8_src, impl="xla")
    tbs = BitStatic(p_fwd=tpack["user"]["pf"], p_bwd=tpack["user"]["pb"],
                    dst_scale=torch.from_numpy(dst_scale),
                    src_scale=torch.from_numpy(src_scale),
                    d8_dst=d8_dst, d8_src=d8_src)
    want = jbd.bit_multi_link_aggregate(
        jnp.asarray(x), jbs, jnp.asarray(weight), jnp.asarray(bias),
        ordinal_sharing=ordinal, accum=accum)
    got = tbd.bit_multi_link_aggregate(
        torch.from_numpy(x), tbs, torch.from_numpy(weight),
        torch.from_numpy(bias), ordinal_sharing=ordinal, accum=accum)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
