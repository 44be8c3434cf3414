"""The port's 16-bit bitdense route (``KERNEL.BIT_IMPL: pallas16``) against
the JAX package's: row-interleaved pack bytes, ``bit_expand_matmul16`` and
``bit_reduce_matmul16`` (their plain versions on the CPU) against the Pallas
kernels in interpret mode fed the same bf16-rounded inputs, against the
natural route on the natural pack, and ``bit_pool_rated`` with its gradient
on the ``kernel16`` route against ``bit_pool_rated(impl="pallas16")``.

Tolerances: 1e-5 of the largest entry against the JAX functions (f32 sums
of the same terms in another order); 1e-6 between the port's two plain
versions (the same sums over the same rows, in another row order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stargcn_tpu.ops import bitdense as jbd
from stargcn_tpu_torch.ops import bitdense as tbd

RIL = 128
# 1500 destinations pad to 2048: d8 = 256, two blocks of 128 packed rows.
D, S_N = 1500, 23


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _edges(rng, num_dst, num_src, num_edges, R):
    return (rng.randint(0, num_dst, num_edges).astype(np.int32),
            rng.randint(0, num_src, num_edges).astype(np.int32),
            rng.randint(0, R, num_edges).astype(np.int32))


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _packs(rng, R, dense=False, num_edges=600):
    """``(P16, P, d8)``: one direction's pack with ``row_interleave=128``
    and the natural pack of the same edges (or of the same random bytes,
    with ``dense``)."""
    dst, src, rat = _edges(rng, D, S_N, num_edges, R)
    P16, d8 = tbd.pack_bits(dst, src, rat, R, D, S_N, row_interleave=RIL)
    P, _ = tbd.pack_bits(dst, src, rat, R, D, S_N)
    if dense:
        P = rng.randint(0, 256, P.shape).astype(np.uint8)
        phys = tbd.natural_to_physical(np.arange(d8), RIL)
        P16 = np.empty_like(P)
        P16.reshape(R, d8, -1)[:, phys] = P.reshape(R, d8, -1)
    return P16, P, d8


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("R", [1, 3, 10])
def test_pack_bits_interleaved_bytes_identical(rng, R, masked):
    dst, src, rat = _edges(rng, D, S_N, 900, R)
    mask = (rng.rand(dst.size) > 0.3).astype(np.float32) if masked else None
    for interleave, ril in ((0, RIL), (256, 0), (256, RIL)):
        got, gd8 = tbd.pack_bits(dst, src, rat, R, D, S_N, mask=mask,
                                 interleave=interleave, row_interleave=ril)
        want, wd8 = jbd.pack_bits(dst, src, rat, R, D, S_N, mask=mask,
                                  interleave=interleave, row_interleave=ril)
        assert gd8 == wd8 == 256 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))
    # The interleaved pack is the natural one with its rows permuted.
    nat, d8 = tbd.pack_bits(dst, src, rat, R, D, S_N, mask=mask)
    phys = tbd.natural_to_physical(np.arange(d8), RIL)
    np.testing.assert_array_equal(
        got.reshape(R, d8, -1)[:, phys],
        tbd.pack_bits(dst, src, rat, R, D, S_N, mask=mask,
                      interleave=256)[0].reshape(R, d8, -1))
    assert not np.array_equal(
        tbd.pack_bits(dst, src, rat, R, D, S_N, mask=mask,
                      row_interleave=RIL)[0], nat)


def test_row_map_is_a_permutation_of_each_block():
    phys = tbd.natural_to_physical(np.arange(3 * RIL), RIL)
    for b in range(3):
        np.testing.assert_array_equal(
            np.sort(phys[b * RIL:(b + 1) * RIL]),
            np.arange(b * RIL, (b + 1) * RIL))
    # natural w -> 2 * (w % 64) + w // 64: rows 2k and 2k+1 hold w = k and
    # w = k + 64, the pair one TPU u16 lane holds.
    assert phys[:3].tolist() == [0, 2, 4] and phys[64:67].tolist() == [1, 3, 5]
    t = tbd.natural_to_physical(torch.arange(3 * RIL), RIL)
    np.testing.assert_array_equal(t.numpy(), phys)


@pytest.mark.parametrize("R", [1, 3, 10])
def test_build_bit_pack_interleaved_layouts(rng, R):
    Nu, Ni = 1100, 1300
    u, i, r = _edges(rng, Nu, Ni, 700, R)
    mask = (rng.rand(u.size) > 0.2).astype(np.float32)
    got = tbd.build_bit_pack(u, i, r, mask, Nu, Ni, R, device="cpu",
                             row_interleave=RIL)
    want = jbd.build_bit_pack(u, i, r, mask, Nu, Ni, R, row_interleave=RIL)
    for t in ("user", "item"):
        for k in ("pf", "pb"):
            np.testing.assert_array_equal(got[t][k].numpy(),
                                          np.asarray(want[t][k]))
    assert got["row_interleave"] == RIL
    assert tbd.build_bit_pack(u, i, r, mask, Nu, Ni, R,
                              device="cpu")["row_interleave"] == 0


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3])
def test_expand16_matches_pallas16_interpret(rng, R, F, dense):
    """The Pallas kernel rounds x to bf16 inside; the port's CPU path is
    fed the bf16-rounded x."""
    P16, _, d8 = _packs(rng, R, dense)
    x = _bf16(rng.randn(P16.shape[1], F) / np.sqrt(P16.shape[1]))
    want = jbd.bit_expand_matmul16(jnp.asarray(P16), jnp.asarray(x), R, d8,
                                   interpret=True)
    got = tbd.bit_expand_matmul16(torch.from_numpy(P16),
                                  torch.from_numpy(x), R, d8)
    assert got.shape == (R, 8, d8, F) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3])
def test_reduce16_matches_pallas16_interpret(rng, R, F, dense):
    P16, _, d8 = _packs(rng, R, dense)
    g = _bf16(rng.randn(R, P16.shape[1], F) / np.sqrt(P16.shape[1]))
    want = jbd.bit_reduce_matmul16(jnp.asarray(P16), jnp.asarray(g), R, d8,
                                   interpret=True)
    # The cotangent as the backward hands it over: a permuted view.
    g_view = torch.from_numpy(np.ascontiguousarray(
        g.transpose(1, 0, 2))).permute(1, 0, 2)
    got = tbd.bit_reduce_matmul16(torch.from_numpy(P16), g_view, R, d8)
    assert got.shape == (8, d8, F) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_reduce16_is_natural_order_at_wide_f(rng):
    """At F = 600 the reference's ``bit_reduce_matmul16`` halves its row
    block (``_fit_bm``, ``stargcn_tpu/ops/bitdense.py:424``) while the pack
    stays interleaved at 128, so its output rows come back permuted.  The
    port holds the contract: natural order at every F, equal to
    ``xla_reduce_matmul`` on the natural pack."""
    R, F = 2, 600
    P16, P, d8 = _packs(rng, R, dense=False, num_edges=1500)
    g = _bf16(rng.randn(R, P.shape[1], F) / np.sqrt(P.shape[1]))
    want = np.asarray(jbd.xla_reduce_matmul(jnp.asarray(P), jnp.asarray(g),
                                            R, d8))
    got = tbd.bit_reduce_matmul16(torch.from_numpy(P16), torch.from_numpy(g),
                                  R, d8)
    _close(got.numpy(), want)
    ref16 = np.asarray(jbd.bit_reduce_matmul16(
        jnp.asarray(P16), jnp.asarray(g), R, d8, interpret=True))
    assert np.abs(ref16 - want).max() > 1e-2 * np.abs(want).max()
    # expand16 has no such fault at this F.
    x = _bf16(rng.randn(P.shape[1], F))
    _close(tbd.bit_expand_matmul16(torch.from_numpy(P16),
                                   torch.from_numpy(x), R, d8).numpy(),
           jbd.xla_expand_matmul(jnp.asarray(P), jnp.asarray(x), R, d8))


@pytest.mark.parametrize("F", [1, 65, 600])
@pytest.mark.parametrize("R", [1, 10])
def test_plain16_equals_plain_on_the_natural_pack(rng, R, F):
    P16, P, d8 = _packs(rng, R, dense=True)
    P16_t, P_t = torch.from_numpy(P16), torch.from_numpy(P)
    x = torch.from_numpy(rng.randn(P.shape[1], F).astype(np.float32))
    g = torch.from_numpy(rng.randn(R, P.shape[1], F).astype(np.float32))
    _close(tbd.xla_expand_matmul16(P16_t, x, R, d8).numpy(),
           tbd.xla_expand_matmul(P_t, x, R, d8).numpy(), 1e-6)
    _close(tbd.xla_reduce_matmul16(P16_t, g, R, d8).numpy(),
           tbd.xla_reduce_matmul(P_t, g, R, d8).numpy(), 1e-6)


@pytest.mark.parametrize("R", [1, 10])
def test_pool_rated16_and_gradient_match_jax_pallas16(rng, R):
    """``bit_pool_rated`` on the ``kernel16`` route and its gradient
    against the JAX package's ``pallas16`` route in interpret mode, on
    bf16-representable x and cotangent (both kernels round to bf16)."""
    Nd, Ns = 1100, 1300
    dst, src, rat = _edges(rng, Nd, Ns, 800, R)
    pf, d8_dst = tbd.pack_bits(dst, src, rat, R, Nd, Ns, row_interleave=RIL)
    pb, d8_src = tbd.pack_bits(src, dst, rat, R, Ns, Nd, row_interleave=RIL)
    x = _bf16(rng.randn(pf.shape[1], 5))
    g = _bf16(rng.randn(8 * d8_dst, R, 5))
    want, vjp = jax.vjp(
        lambda v: jbd.bit_pool_rated(v, jnp.asarray(pf), jnp.asarray(pb), R,
                                     d8_dst, d8_src, "pallas16", True),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tbd.bit_pool_rated(xt, torch.from_numpy(pf), torch.from_numpy(pb),
                             R, d8_dst, d8_src, "kernel16")
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.shape == (8 * d8_dst, R, 5)
    _close(got.detach().numpy(), want)
    _close(got_dx.numpy(), want_dx)


def test_resolve_pallas16_and_its_layout():
    assert tbd.resolve_impl("pallas16") == "kernel16"
    assert tbd.pack_row_interleave("kernel16") == RIL
    for impl in ("kernel", "plain"):
        assert tbd.pack_row_interleave(impl) == 0


@pytest.mark.parametrize("fn", ["bit_expand_matmul16", "bit_reduce_matmul16"])
def test_wrappers16_refuse(fn):
    """A tensor that is not on the CPU goes to the kernel or raises; a row
    block that is odd or does not divide d8 is refused."""
    wrapper = getattr(tbd, fn)
    P = torch.zeros((256, 1024), dtype=torch.uint8, device="meta")
    v = torch.zeros((1024, 4) if "expand" in fn else (1, 1024, 4),
                    device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(P, v, 1, 256)
    cpu = (torch.zeros((256, 1024), dtype=torch.uint8),
           torch.zeros((1024, 4) if "expand" in fn else (1, 1024, 4)))
    for bm in (0, 127, 96):
        with pytest.raises(ValueError, match="bm"):
            wrapper(*cpu, 1, 256, bm=bm)
    assert wrapper(*cpu, 1, 256, bm=64).abs().max() == 0


def test_model_refuses_packs_of_the_other_layout():
    from stargcn_tpu_torch.models.stargcn import (STARGCNConfig,
                                                  _build_bit_static_operands)

    rng = np.random.RandomState(0)
    Nu, Ni, R = 40, 30, 3
    u, i, r = _edges(rng, Nu, Ni, 100, R)
    deg = (torch.ones(Nu), torch.ones(Ni))
    for impl, ril in (("pallas16", 0), ("pallas", RIL), ("xla", RIL)):
        cfg = STARGCNConfig(num_users=Nu, num_items=Ni, num_links=R,
                            bit_impl=impl)
        pack = tbd.build_bit_pack(u, i, r, None, Nu, Ni, R, device="cpu",
                                  row_interleave=ril)
        with pytest.raises(ValueError, match="row_interleave"):
            _build_bit_static_operands(cfg, pack, *deg)
    cfg = STARGCNConfig(num_users=Nu, num_items=Ni, num_links=R,
                        bit_impl="pallas16")
    pack = tbd.build_bit_pack(u, i, r, None, Nu, Ni, R, device="cpu",
                              row_interleave=RIL)
    bit_u, bit_i = _build_bit_static_operands(cfg, pack, *deg)
    assert bit_u.impl == bit_i.impl == "kernel16"
