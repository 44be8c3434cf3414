"""The port's seg-op family (``stargcn_tpu_torch/ops/segment.py``) against
the JAX package's ``stargcn_tpu/ops/segment.py``, on the cases of
``tests/test_segment_ops.py``: the same seeded numpy inputs through both,
values and gradients (the JAX vjp and torch autograd of one random
cotangent).

Tolerances: 1e-5 relative to the largest value (float32; the two sum a
segment in different orders) for values and gradients, 1e-4 where a
softmax or a product of two gathers adds a rounding step.  Max and min
gradients are compared on inputs without ties: where several elements
reach a segment's maximum, the port splits the gradient evenly and the
JAX package's scan (the narrow-row formulation of ``seg_max`` and
``seg_min``) unevenly, which the last tests pin down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stargcn_tpu.ops.segment as J
import stargcn_tpu_torch.ops as T

SHAPES = [(1, 5, 10), (4, 17, 101), (2, 100, 1000)]


def rand_indptr(rng, seg_num, nnz):
    cuts = np.sort(rng.choice(np.arange(1, nnz), seg_num - 1, replace=False))
    return np.concatenate([[0], cuts, [nnz]]).astype(np.int32)


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1.0),
                               err_msg=what)


def _both(jfn, tfn, args, grad_args, rng, rel=1e-5):
    """Values and the gradient of every argument in ``grad_args`` (their
    positions) through both packages, for one cotangent."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    for k in grad_args:
        targs[k].requires_grad_(True)
    want, vjp = jax.vjp(jax.jit(lambda *g: jfn(*[
        g[grad_args.index(i)] if i in grad_args else a
        for i, a in enumerate(jargs)])), *[jargs[k] for k in grad_args])
    got = tfn(*targs)
    _close(got, want, rel, "values")
    ct = rng.normal(size=np.shape(want)).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    tgrads = torch.autograd.grad(got, [targs[k] for k in grad_args],
                                 torch.from_numpy(ct))
    for k, jg, tg in zip(grad_args, jgrads, tgrads):
        _close(tg, jg, rel, f"gradient of argument {k}")


@pytest.mark.parametrize("shape", SHAPES)
def test_seg_sum(rng, shape):
    b, s, nnz = shape
    data = rng.normal(size=(b, nnz)).astype(np.float32)
    indptr = rand_indptr(rng, s, nnz)
    _both(J.seg_sum, T.seg_sum, (data, indptr), [0], rng)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("op", ["seg_max", "seg_min"])
def test_seg_max_min(rng, shape, op):
    b, s, nnz = shape
    data = rng.normal(size=(b, nnz)).astype(np.float32)   # tie-free
    indptr = rand_indptr(rng, s, nnz)
    _both(getattr(J, op), getattr(T, op), (data, indptr), [0], rng)


def test_seg_reduce_empty_segments():
    data = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    indptr = np.asarray([0, 0, 2, 2, 3], np.int32)
    for op, want in (("seg_sum", [[0, 3, 0, 3]]), ("seg_max", [[0, 2, 0, 3]]),
                     ("seg_min", [[0, 1, 0, 3]])):
        got = getattr(T, op)(torch.from_numpy(data), torch.from_numpy(indptr))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)
        np.testing.assert_array_equal(
            got.numpy(), getattr(J, op)(jnp.asarray(data),
                                        jnp.asarray(indptr)), err_msg=op)
    # Negative maxima stay negative; an empty segment still gives 0.
    neg = torch.tensor([[-3.0, -1.0, -2.0]])
    np.testing.assert_array_equal(
        T.seg_max(neg, torch.tensor([0, 2, 2, 3])).numpy(), [[-1, 0, -2]])


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_seg_indptr_to_segment_ids(rng, shape):
    _, s, nnz = shape
    indptr = rand_indptr(rng, s, nnz)
    indptr[1] = indptr[2]                                 # an empty segment
    got = T.indptr_to_segment_ids(torch.from_numpy(indptr), nnz)
    want = J.indptr_to_segment_ids(jnp.asarray(indptr), nnz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("op", ["seg_broadcast_add", "seg_broadcast_mul"])
def test_seg_broadcast(rng, shape, op):
    b, s, nnz = shape
    lhs = rng.normal(size=(b, nnz)).astype(np.float32)
    rhs = rng.normal(size=(b, s)).astype(np.float32)
    indptr = rand_indptr(rng, s, nnz)
    _both(getattr(J, op), getattr(T, op), (lhs, rhs, indptr), [0, 1], rng)
    _both(lambda r, p: J.seg_broadcast_to(r, p, nnz),
          lambda r, p: T.seg_broadcast_to(r, p, nnz), (rhs, indptr), [0],
          rng)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_seg_softmax(rng, shape):
    b, s, nnz = shape
    data = rng.normal(size=(b, nnz)).astype(np.float32)
    indptr = rand_indptr(rng, s, nnz)
    _both(J.seg_softmax, T.seg_softmax, (data, indptr), [0], rng, rel=1e-4)


def test_seg_take_k_corr(rng):
    K, n_node, n_nbr, F, nnz = 3, 11, 17, 8, 40
    e1 = rng.normal(size=(K, n_node, F)).astype(np.float32)
    e2 = rng.normal(size=(K, n_nbr, F)).astype(np.float32)
    nids = rng.randint(0, n_nbr, size=nnz).astype(np.int32)
    indptr = rand_indptr(rng, n_node, nnz)
    _both(J.seg_take_k_corr, T.seg_take_k_corr, (e1, e2, nids, indptr),
          [0, 1], rng, rel=1e-4)


def test_seg_weighted_pool(rng):
    B, n_nbr, F, S, nnz = 2, 23, 16, 9, 50
    data = rng.normal(size=(B, n_nbr, F)).astype(np.float32)
    w = rng.normal(size=(B, nnz)).astype(np.float32)
    idx = rng.randint(0, n_nbr, size=nnz).astype(np.int32)
    indptr = rand_indptr(rng, S, nnz)
    _both(J.seg_weighted_pool, T.seg_weighted_pool, (data, w, idx, indptr),
          [0, 1], rng, rel=1e-4)


@pytest.mark.parametrize("pool_type", ["sum", "avg", "max"])
def test_seg_pool(rng, pool_type):
    B, n_nbr, F, S, nnz = 2, 53, 4, 9, 50
    data = rng.normal(size=(B, n_nbr, F)).astype(np.float32)
    # Distinct indices, so that no segment repeats a row (a max tie).
    idx = rng.permutation(n_nbr)[:nnz].astype(np.int32)
    indptr = rand_indptr(rng, S, nnz)
    indptr[3] = indptr[4]                                 # an empty segment
    _both(lambda d, i, p: J.seg_pool(d, i, p, pool_type),
          lambda d, i, p: T.seg_pool(d, i, p, pool_type),
          (data, idx, indptr), [0], rng)


def test_seg_pool_rejects_unknown_type():
    with pytest.raises(ValueError, match="pool_type"):
        T.seg_pool(torch.ones(1, 2, 1), torch.tensor([0]),
                   torch.tensor([0, 1]), "median")


def test_adjoint_structure(rng):
    """``seg_weighted_pool`` and ``seg_take_k_corr`` are each other's
    adjoints: the pool's weight gradient for a cotangent is the SDDMM of
    the cotangent against the data."""
    B, n_nbr, F, S, nnz = 1, 7, 3, 4, 12
    data = torch.from_numpy(rng.normal(size=(B, n_nbr, F)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(B, nnz)).astype(np.float32))
    w.requires_grad_(True)
    idx = torch.from_numpy(rng.randint(0, n_nbr, size=nnz))
    indptr = torch.from_numpy(rand_indptr(rng, S, nnz))
    ct = torch.from_numpy(rng.normal(size=(B, S, F)).astype(np.float32))
    (dw,) = torch.autograd.grad(T.seg_weighted_pool(data, w, idx, indptr),
                                w, ct)
    sddmm = T.seg_take_k_corr(ct, data, idx, indptr)
    _close(dw, sddmm.numpy(), 1e-5)


def test_max_tie_splits_the_gradient_evenly():
    """Three elements tie for a segment's maximum: the port gives each a
    third of the gradient; the JAX package's scan gives (1/4, 1/4, 1/2).
    Away from ties the two agree (the tests above)."""
    d = np.asarray([[1.0, 1.0, 1.0, 0.5]], np.float32)
    indptr = np.asarray([0, 3, 4], np.int32)
    x = torch.from_numpy(d).requires_grad_(True)
    (g,) = torch.autograd.grad(
        T.seg_max(x, torch.from_numpy(indptr)).sum(), x)
    np.testing.assert_allclose(g.numpy(), [[1 / 3, 1 / 3, 1 / 3, 1.0]],
                               rtol=1e-6)
    jg = jax.grad(lambda v: J.seg_max(v, jnp.asarray(indptr)).sum())(
        jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(jg), [[0.25, 0.25, 0.5, 1.0]])


def test_pool_max_tie_matches_jax():
    """``seg_pool(..., 'max')`` reduces the wide (feature) rows by a
    scatter in both packages, and both split a tie evenly."""
    data = np.ones((1, 3, 2), np.float32)
    idx = np.arange(3, dtype=np.int32)
    indptr = np.asarray([0, 3], np.int32)
    x = torch.from_numpy(data).requires_grad_(True)
    (g,) = torch.autograd.grad(T.seg_pool(
        x, torch.from_numpy(idx), torch.from_numpy(indptr), "max").sum(), x)
    jg = jax.grad(lambda v: J.seg_pool(v, jnp.asarray(idx),
                                       jnp.asarray(indptr), "max").sum())(
        jnp.asarray(data))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
