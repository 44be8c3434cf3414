"""The backward of the port's bitdense aggregation against the JAX
package's: ``xla_reduce_matmul`` and the ``bit_reduce_matmul`` wrapper (its
plain version on the CPU) against the XLA model and the Pallas kernel in
interpret mode, ``bit_pool_rated`` and its gradient against ``jax.vjp`` and
against autograd through a dense 0/1 adjacency, and the removed-edge
correction.

Tolerance 1e-5 relative to the largest entry: f32 sums of the same terms in
another order."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stargcn_tpu.models.layers import BitStatic as JBitStatic
from stargcn_tpu.ops import bitdense as jbd
from stargcn_tpu_torch.models.layers import BitStatic
from stargcn_tpu_torch.ops import bitdense as tbd
from stargcn_tpu_torch.ops import gather as tgather


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


def _packed(rng, R, dense):
    D, S_n = 29, 17
    dst, src, rat = _edges(rng, D, S_n, 150, R)
    P, d8 = tbd.pack_bits(dst, src, rat, R, D, S_n)
    if dense:
        P = rng.randint(0, 256, P.shape).astype(np.uint8)
    return P, d8


def _cotangent(rng, R, s_pad, F):
    return (rng.randn(R, s_pad, F) / np.sqrt(s_pad)).astype(np.float32)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3, 10])
def test_reduce_matches_xla(rng, R, F, dense):
    P, d8 = _packed(rng, R, dense)
    g = _cotangent(rng, R, P.shape[1], F)
    want = jbd.xla_reduce_matmul(jnp.asarray(P), jnp.asarray(g), R, d8)
    for fn in (tbd.xla_reduce_matmul, tbd.bit_reduce_matmul):
        got = fn(torch.from_numpy(P), torch.from_numpy(g), R, d8)
        assert got.shape == (8, d8, F) and got.dtype == torch.float32
        _close(got.numpy(), want)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("F", [7, 65])
@pytest.mark.parametrize("R", [1, 3])
def test_reduce_matches_pallas_interpret(rng, R, F, dense):
    """The Pallas kernel rounds g to bf16 inside; the port's CPU path is
    fed the bf16-rounded g."""
    P, d8 = _packed(rng, R, dense)
    g = _cotangent(rng, R, P.shape[1], F)
    want = jbd.bit_reduce_matmul(jnp.asarray(P), jnp.asarray(g), R, d8,
                                 interpret=True)
    got = tbd.bit_reduce_matmul(torch.from_numpy(P),
                                torch.from_numpy(_bf16(g)), R, d8)
    _close(got.numpy(), want)


def test_reduce_takes_a_permuted_view_and_chunks(rng):
    P, d8 = _packed(rng, 3, dense=True)
    P_t = torch.from_numpy(P)
    # Small integers sum exactly in f32 in any order.
    g_sr = torch.from_numpy(rng.randint(-4, 5, (P.shape[1], 3, 9)).astype(
        np.float32))
    view = g_sr.permute(1, 0, 2)
    assert not view.is_contiguous()
    whole = tbd.xla_reduce_matmul(P_t, view.contiguous(), 3, d8)
    assert torch.equal(tbd.bit_reduce_matmul(P_t, view, 3, d8), whole)
    rows = tbd.xla_reduce_matmul(P_t, view, 3, d8,
                                 chunk_bytes=8 * P.shape[1] * 4 * 5)
    assert torch.equal(rows, whole)
    # bf16 g sums in f32
    small = g_sr.permute(1, 0, 2).to(torch.bfloat16)
    assert torch.equal(tbd.bit_reduce_matmul(P_t, small, 3, d8), whole)


def _both_packs(rng, R, D, S_n, E):
    dst, src, rat = _edges(rng, D, S_n, E, R)
    pf, d8_dst = tbd.pack_bits(dst, src, rat, R, D, S_n)
    pb, d8_src = tbd.pack_bits(src, dst, rat, R, S_n, D)
    return (dst, src, rat), pf, pb, d8_dst, d8_src


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("R", [1, 10])
def test_pool_rated_and_gradient_match_jax_vjp(rng, R, impl):
    _, pf, pb, d8_dst, d8_src = _both_packs(rng, R, 41, 23, 200)
    x = (rng.randn(pf.shape[1], 5)).astype(np.float32)
    g = rng.randn(8 * d8_dst, R, 5).astype(np.float32)
    want, vjp = jax.vjp(
        lambda v: jbd.bit_pool_rated(v, jnp.asarray(pf), jnp.asarray(pb), R,
                                     d8_dst, d8_src, "xla", False),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tbd.bit_pool_rated(xt, torch.from_numpy(pf), torch.from_numpy(pb),
                             R, d8_dst, d8_src, impl)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.shape == (8 * d8_dst, R, 5)
    _close(got.detach().numpy(), want)
    assert got_dx.shape == xt.shape
    _close(got_dx.numpy(), want_dx)


def test_pool_rated_gradient_matches_dense_autograd(rng):
    """Against autograd through the explicit 0/1 adjacency that the packed
    bits stand for."""
    R = 3
    (dst, src, rat), pf, pb, d8_dst, d8_src = _both_packs(rng, R, 41, 23,
                                                          200)
    adj = torch.zeros(R, 8 * d8_dst, pf.shape[1])
    adj[rat, dst, src] = 1.0
    x = torch.from_numpy(rng.randn(pf.shape[1], 5).astype(np.float32))
    g = torch.from_numpy(rng.randn(8 * d8_dst, R, 5).astype(np.float32))
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    got = tbd.bit_pool_rated(xa, torch.from_numpy(pf), torch.from_numpy(pb),
                             R, d8_dst, d8_src)
    want = torch.einsum("rds,sf->drf", adj, xb)
    _close(got.detach().numpy(), want.detach().numpy())
    _close(torch.autograd.grad(got, xa, g)[0].numpy(),
           torch.autograd.grad(want, xb, g)[0].numpy())


def test_pool_rated_saves_only_the_backward_pack(rng):
    _, pf, pb, d8_dst, d8_src = _both_packs(rng, 3, 41, 23, 200)
    x = torch.zeros(pf.shape[1], 5, requires_grad=True)
    p_bwd = torch.from_numpy(pb)
    out = tbd.bit_pool_rated(x, torch.from_numpy(pf), p_bwd, 3, d8_dst,
                             d8_src, "plain")
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is p_bwd


def test_adjoint_identity(rng):
    """<expand(p_fwd, x), g> == <x, reduce(p_bwd, g)>: the two functions
    and the two pack layouts fit together."""
    R = 10
    _, pf, pb, d8_dst, d8_src = _both_packs(rng, R, 41, 23, 300)
    x = torch.from_numpy(_bf16(rng.randn(pf.shape[1], 6)))
    g = torch.from_numpy(_bf16(rng.randn(8 * d8_dst, R, 6)))
    fwd = tbd.bit_expand_matmul(torch.from_numpy(pf), x, R, d8_dst)
    fwd = fwd.permute(1, 2, 0, 3).reshape(8 * d8_dst, R, 6)
    bwd = tbd.bit_reduce_matmul(torch.from_numpy(pb), g.permute(1, 0, 2), R,
                                d8_src).reshape(8 * d8_src, 6)
    lhs = float((fwd.double() * g.double()).sum())
    rhs = float((x.double() * bwd.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_reduce_refusals():
    P = torch.zeros((16, 1024), dtype=torch.uint8, device="meta")
    g = torch.zeros((2, 1024, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):     # not on the CPU:
        tbd.bit_reduce_matmul(P, g, 2, 8)             # kernel or raise
    with pytest.raises(ValueError, match="CUDA"):     # mismatched devices
        tbd.bit_reduce_matmul(torch.zeros((16, 1024), dtype=torch.uint8),
                              g, 2, 8)


def test_reduce_checks_before_launch(monkeypatch):
    """The checks that guard the kernel on the card, reached here by
    letting CPU tensors pass for CUDA ones: dtype, rank, shape, a strided
    inner dimension.  None of them falls back to the plain version."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    P = torch.zeros((16, 1024), dtype=torch.uint8)
    g = torch.zeros((2, 1024, 4))
    with pytest.raises(TypeError, match="uint8"):
        tbd.bit_reduce_matmul(P.float(), g, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        tbd.bit_reduce_matmul(P, g.double(), 2, 8)
    with pytest.raises(ValueError, match="3-D"):
        tbd.bit_reduce_matmul(P, g[0], 2, 8)
    with pytest.raises(ValueError, match="do not fit"):
        tbd.bit_reduce_matmul(P, g, 4, 8)
    with pytest.raises(ValueError, match="do not fit"):
        tbd.bit_reduce_matmul(P, g[:, :512], 2, 8)
    with pytest.raises(ValueError, match="last dimension"):
        tbd.bit_reduce_matmul(P, torch.zeros((2, 4, 1024)).permute(0, 2, 1),
                              2, 8)
    with pytest.raises(ValueError, match="contiguous P"):
        tbd.bit_reduce_matmul(torch.zeros((1024, 16),
                                          dtype=torch.uint8).t(), g, 2, 8)


@pytest.mark.parametrize("accum", ["sum", "stack"])
def test_aggregate_with_removed_edges_and_gradients_match_jax(rng, accum):
    """``bit_multi_link_aggregate`` with the removed-edge correction, and
    its gradients in x, weight and bias, against ``jax.grad``."""
    R, Nu, Ni, Fin, U, B = 10, 41, 23, 6, 4, 30
    u, i, r = _edges(rng, Nu, Ni, 200, R)
    mask = np.ones(u.size, np.float32)
    jpack = jbd.build_bit_pack(u, i, r, mask, Nu, Ni, R)
    tpack = tbd.build_bit_pack(u, i, r, mask, Nu, Ni, R, device="cpu")
    x = rng.randn(Ni, Fin).astype(np.float32)       # item -> user direction
    weight = rng.randn(R, Fin, U).astype(np.float32)
    bias = rng.randn(R, U).astype(np.float32)
    dst_scale = rng.rand(Nu).astype(np.float32)
    src_scale = rng.rand(Ni).astype(np.float32)
    # removed: the first B edges, of which a few are marked as no hit
    hit = (rng.rand(B) > 0.2).astype(np.float32)
    functional = rng.randn(Nu, U * (R if accum == "stack" else 1)).astype(
        np.float32)
    d8_dst = jpack["user"]["pf"].shape[0] // R
    d8_src = jpack["user"]["pb"].shape[0] // R
    jbs = JBitStatic(
        p_fwd=jpack["user"]["pf"], p_bwd=jpack["user"]["pb"],
        dst_scale=jnp.asarray(dst_scale), src_scale=jnp.asarray(src_scale),
        rem_src=jnp.asarray(i[:B]), rem_dst=jnp.asarray(u[:B]),
        rem_rating=jnp.asarray(r[:B]), rem_weight=jnp.asarray(hit),
        d8_dst=d8_dst, d8_src=d8_src, impl="xla")
    tbs = BitStatic(
        p_fwd=tpack["user"]["pf"], p_bwd=tpack["user"]["pb"],
        dst_scale=torch.from_numpy(dst_scale),
        src_scale=torch.from_numpy(src_scale),
        rem_src=torch.from_numpy(i[:B]).long(),
        rem_dst=torch.from_numpy(u[:B]).long(),
        rem_rating=torch.from_numpy(r[:B]).long(),
        rem_weight=torch.from_numpy(hit), d8_dst=d8_dst, d8_src=d8_src)

    def jloss(x_, w_, b_):
        out = jbd.bit_multi_link_aggregate(x_, jbs, w_, b_,
                                           ordinal_sharing=False,
                                           accum=accum)
        return jnp.sum(out * functional), out

    (_, want), want_grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(weight), jnp.asarray(bias))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, weight, bias)]
    got = tbd.bit_multi_link_aggregate(args[0], tbs, args[1], args[2],
                                       ordinal_sharing=False, accum=accum)
    got_grads = torch.autograd.grad(
        (got * torch.from_numpy(functional)).sum(), args)
    _close(got.detach().numpy(), want, rel=2e-4)
    for name, a, b in zip(("x", "weight", "bias"), got_grads, want_grads):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=0,
            atol=1e-4 * np.abs(np.asarray(b)).max(), err_msg=name)


def test_gather_ops_match_jax(rng):
    from stargcn_tpu.ops import gather as jgather

    x = rng.randn(50, 4).astype(np.float32)
    idx = rng.randint(0, 50, 30).astype(np.int32)
    np.testing.assert_array_equal(
        tgather.take_rows(torch.from_numpy(x),
                          torch.from_numpy(idx).long()).numpy(),
        np.asarray(jgather.take_rows(jnp.asarray(x), jnp.asarray(idx))))
    vals = rng.randn(30, 4).astype(np.float32)
    seg = rng.randint(-2, 14, 30).astype(np.int32)   # some out of range
    want = jgather.onehot_segment_sum(jnp.asarray(vals), jnp.asarray(seg), 12)
    got = tgather.onehot_segment_sum(torch.from_numpy(vals),
                                     torch.from_numpy(seg).long(), 12)
    _close(got.numpy(), want)
    got1 = tgather.onehot_segment_sum(torch.from_numpy(vals[:, 0].copy()),
                                      torch.from_numpy(seg).long(), 12)
    assert got1.shape == (12,)
    _close(got1.numpy(), np.asarray(want)[:, 0])
