"""The port's kernel-backed seg-op variants (``ops/ell.py``) against the
JAX package's (``stargcn_tpu/ops/ell.py``, Pallas in interpret mode) and
its plain seg ops.  Tolerance 1e-5: float32, short sums."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stargcn_tpu.ops import ell as jell
from stargcn_tpu.ops import seg_take_k_corr, seg_weighted_pool
from stargcn_tpu_torch.ops import ell as tell

TOL = dict(rtol=1e-5, atol=1e-5)


def rand_indptr(rng, seg_num, nnz):
    cuts = np.sort(rng.choice(np.arange(1, nnz), seg_num - 1, replace=False))
    return np.concatenate([[0], cuts, [nnz]]).astype(np.int32)


def test_ell_from_csr_equals_reference(rng):
    for seg_num, nnz in ((9, 40), (3, 3), (12, 90)):
        indptr = rand_indptr(rng, seg_num, nnz)
        a, b = tell.ell_from_csr(indptr), jell.ell_from_csr(indptr)
        np.testing.assert_array_equal(a.slot_edge, b.slot_edge)
        np.testing.assert_array_equal(a.slot_mask, b.slot_mask)
        assert (a.num_seg, a.nnz) == (b.num_seg, b.nnz)
        assert a.slot_edge.dtype == np.int32
    empty = tell.ell_from_csr(np.array([0, 0, 2, 2]))
    assert empty.slot_edge.shape == (3, 2) and empty.slot_mask.sum() == 2


def test_seg_weighted_pool_matches(rng):
    B, n_nbr, F, S, nnz = 2, 23, 16, 9, 50
    data = rng.normal(size=(B, n_nbr, F)).astype(np.float32)
    w = rng.normal(size=(B, nnz)).astype(np.float32)
    idx = rng.randint(0, n_nbr, size=nnz).astype(np.int32)
    indptr = rand_indptr(rng, S, nnz)
    ell = tell.ell_from_csr(indptr)
    td = torch.from_numpy(data).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tell.seg_weighted_pool_pallas(td, tw, idx, ell)
    want = seg_weighted_pool(jnp.asarray(data), jnp.asarray(w),
                             jnp.asarray(idx), jnp.asarray(indptr))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    pallas = jell.seg_weighted_pool_pallas(
        jnp.asarray(data), jnp.asarray(w), idx, jell.ell_from_csr(indptr),
        interpret=True)
    np.testing.assert_allclose(got.detach().numpy(), pallas, **TOL)
    # gradients through the autograd.Function against jax.grad of the
    # plain seg op
    ct = rng.normal(size=got.shape).astype(np.float32)
    gd, gw = torch.autograd.grad(got, (td, tw), torch.from_numpy(ct))
    jd, jw = jax.grad(lambda d, ww: (seg_weighted_pool(
        d, ww, jnp.asarray(idx), jnp.asarray(indptr)) * ct).sum(),
        argnums=(0, 1))(jnp.asarray(data), jnp.asarray(w))
    np.testing.assert_allclose(gd.numpy(), jd, **TOL)
    np.testing.assert_allclose(gw.numpy(), jw, **TOL)


def test_seg_take_k_corr_matches(rng):
    K_, n_node, n_nbr, F, nnz = 2, 11, 17, 8, 40
    e1 = rng.normal(size=(K_, n_node, F)).astype(np.float32)
    e2 = rng.normal(size=(K_, n_nbr, F)).astype(np.float32)
    nids = rng.randint(0, n_nbr, size=nnz).astype(np.int32)
    indptr = rand_indptr(rng, n_node, nnz)
    got = tell.seg_take_k_corr_pallas(
        torch.from_numpy(e1), torch.from_numpy(e2), nids,
        tell.ell_from_csr(indptr)).numpy()
    want = seg_take_k_corr(jnp.asarray(e1), jnp.asarray(e2),
                           jnp.asarray(nids), jnp.asarray(indptr))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = jell.seg_take_k_corr_pallas(
        jnp.asarray(e1), jnp.asarray(e2), nids, jell.ell_from_csr(indptr),
        interpret=True)
    np.testing.assert_allclose(got, pallas, **TOL)
