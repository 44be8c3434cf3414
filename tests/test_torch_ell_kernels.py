"""The port's ELL ops (``stargcn_tpu_torch/ops/ell_kernels.py``) against the
JAX package's Pallas kernels in interpret mode and its numpy goldens.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions, the slot ordering that the transpose kernel reads
and the ``autograd.Function``'s wiring; the CUDA kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.

Tolerance 1e-5 (absolute and relative): float32 sums of at most 32 terms of
O(1), taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stargcn_tpu.ops import pallas_kernels as pk
from stargcn_tpu_torch.ops import ell_kernels as ek

TOL = dict(rtol=1e-5, atol=1e-5)
# Small Pallas blocks, so that a case spans several grid steps.
BLOCKS = dict(block_d=16, block_f=128, block_s=32)

# (num_dst, num_src, K, feat)
CASES = [(50, 70, 9, 33), (130, 300, 4, 140), (7, 1, 3, 5), (40, 60, 1, 1),
         (20, 45, 32, 65), (33, 90, 8, 250)]


def make_ell(seed, num_dst, num_src, K, feat, pad_frac=0.3,
             out_of_range=False):
    rng = np.random.RandomState(seed)
    lo, hi = (-4, num_src + 4) if out_of_range else (0, num_src)
    idx = rng.randint(lo, hi, size=(num_dst, K)).astype(np.int32)
    w = rng.normal(size=(num_dst, K)).astype(np.float32)
    w[rng.uniform(size=(num_dst, K)) < pad_frac] = 0.0
    vals = rng.normal(size=(num_src, feat)).astype(np.float32)
    q = rng.normal(size=(num_dst, feat)).astype(np.float32)
    return vals, idx, w, q


def T(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", CASES)
def test_spmm_matches_pallas_and_golden(case):
    vals, idx, w, _ = make_ell(0, *case)
    got = ek.ell_spmm_fwd_only(*T(vals, idx, w)).numpy()
    np.testing.assert_allclose(got, pk.ref_ell_spmm(vals, idx, w), **TOL)
    want = pk.ell_spmm_fwd_only(jnp.asarray(vals), jnp.asarray(idx),
                                jnp.asarray(w), interpret=True, **BLOCKS)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_sddmm_matches_pallas_and_golden(case):
    vals, idx, _, q = make_ell(1, *case)
    got = ek.ell_sddmm(*T(q, vals, idx)).numpy()
    np.testing.assert_allclose(got, pk.ref_ell_sddmm(q, vals, idx), **TOL)
    want = pk.ell_sddmm(jnp.asarray(q), jnp.asarray(vals), jnp.asarray(idx),
                        interpret=True, block_d=16, block_s=32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES)
def test_spmm_transpose_matches_pallas_and_scatter(case):
    vals, idx, w, g = make_ell(2, *case)
    num_src = vals.shape[0]
    got = ek.ell_spmm_transpose(*T(g, idx, w), num_src).numpy()
    want = np.zeros_like(vals)
    for i in range(idx.shape[0]):
        for k in range(idx.shape[1]):
            want[idx[i, k]] += w[i, k] * g[i]
    np.testing.assert_allclose(got, want, **TOL)
    pallas = pk.ell_spmm_transpose(jnp.asarray(g), jnp.asarray(idx),
                                   jnp.asarray(w), num_src, interpret=True,
                                   **BLOCKS)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_out_of_range_and_padded_slots_contribute_nothing():
    """An index outside [0, num_src) matches no source in the Pallas
    kernels; padded slots (weight 0) may hold any index, in range or
    not."""
    vals, idx, w, q = make_ell(3, 40, 25, 6, 17, pad_frac=0.4,
                               out_of_range=True)
    idx[w == 0] = np.random.RandomState(4).randint(
        -100, 100, size=int((w == 0).sum()))
    assert ((idx < 0) | (idx >= 25)).any()
    jv, ji, jw, jq = (jnp.asarray(a) for a in (vals, idx, w, q))
    np.testing.assert_allclose(
        ek.ell_spmm_fwd_only(*T(vals, idx, w)).numpy(),
        pk.ell_spmm_fwd_only(jv, ji, jw, interpret=True, **BLOCKS), **TOL)
    np.testing.assert_allclose(
        ek.ell_sddmm(*T(q, vals, idx)).numpy(),
        pk.ell_sddmm(jq, jv, ji, interpret=True, block_d=16, block_s=32),
        **TOL)
    np.testing.assert_allclose(
        ek.ell_spmm_transpose(*T(q, idx, w), 25).numpy(),
        pk.ell_spmm_transpose(jq, ji, jw, 25, interpret=True, **BLOCKS),
        **TOL)


def test_rows_that_repeat_a_source():
    """Every slot of a row, and many rows, may name the same source."""
    vals, idx, w, g = make_ell(5, 30, 3, 8, 12, pad_frac=0.0)
    idx[:10] = 1
    got = ek.ell_spmm_fwd_only(*T(vals, idx, w)).numpy()
    np.testing.assert_allclose(got, pk.ref_ell_spmm(vals, idx, w), **TOL)
    back = ek.ell_spmm_transpose(*T(g, idx, w), 3).numpy()
    want = np.zeros_like(vals)
    np.add.at(want, idx.reshape(-1),
              (w[:, :, None] * g[:, None, :]).reshape(-1, 12))
    np.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", [(30, 40, 4, 18), (25, 9, 8, 65)])
def test_autograd_function_matches_custom_vjp(case):
    """``ell_spmm``'s value and both gradients against the JAX
    ``custom_vjp`` through the Pallas kernels."""
    vals, idx, w, ct = make_ell(6, *case)
    out, vjp = jax.vjp(
        lambda v, ww: pk.ell_spmm(v, jnp.asarray(idx), ww, True),
        jnp.asarray(vals), jnp.asarray(w))
    dv, dw = vjp(jnp.asarray(ct))

    tv, ti, tw, tct = T(vals, idx, w, ct)
    tv.requires_grad_()
    tw.requires_grad_()
    got = ek.ell_spmm(tv, ti, tw)
    gv, gw = torch.autograd.grad(got, (tv, tw), tct)
    np.testing.assert_allclose(got.detach().numpy(), out, **TOL)
    np.testing.assert_allclose(gv.numpy(), dv, **TOL)
    # every slot gets a weight gradient, padded ones too
    np.testing.assert_allclose(gw.numpy(), dw, **TOL)
    assert np.abs(gw.numpy()[w == 0]).max() > 0


def test_backward_runs_only_what_is_asked_for(monkeypatch):
    """The plan's weights need no gradient on the training path: then
    ``values`` is not kept for the backward and no SDDMM runs."""
    calls = []
    for name in ("ell_sddmm", "ell_spmm_transpose"):
        real = getattr(ek, name)
        monkeypatch.setattr(ek, name, lambda *a, _n=name, _f=real:
                            (calls.append(_n), _f(*a))[1])
    vals, idx, w, ct = make_ell(7, 12, 9, 3, 5)
    tv, ti, tw, tct = T(vals, idx, w, ct)
    tv.requires_grad_()
    out = ek.ell_spmm(tv, ti, tw)
    assert out.grad_fn.saved_tensors[2] is None
    out.backward(tct)
    assert calls == ["ell_spmm_transpose"]
    calls.clear()
    tw.requires_grad_()
    (gw,) = torch.autograd.grad(ek.ell_spmm(tv.detach(), ti, tw), tw, tct)
    assert calls == ["ell_sddmm"] and gw.shape == tw.shape


def test_sorted_slots_reproduce_the_transpose():
    """The transpose kernel sums, per source row, the run that
    ``sort_slots`` hands it: emulate that loop in numpy."""
    vals, idx, w, g = make_ell(8, 37, 21, 5, 6, out_of_range=True)
    seg_ptr, dst_sorted, w_sorted = (
        t.numpy() for t in ek.sort_slots(*T(idx, w), 21))
    assert seg_ptr.shape == (22,) and seg_ptr[0] == 0
    live = (w != 0) & (idx >= 0) & (idx < 21)
    assert seg_ptr[-1] == live.sum()
    out = np.zeros((21, 6), np.float32)
    for s in range(21):
        run = slice(seg_ptr[s], seg_ptr[s + 1])
        # ascending slot order within a run: the sum's order is fixed
        assert (np.diff(dst_sorted[run]) >= 0).all()
        for i, ws in zip(dst_sorted[run], w_sorted[run]):
            out[s] += ws * g[i]
    np.testing.assert_allclose(
        out, ek.plain_ell_spmm_transpose(*T(g, idx, w), 21).numpy(), **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    vals, idx, w, q = T(*make_ell(9, 6, 5, 2, 4))
    for bad in (
            lambda: ek._check("k", {"values": vals}, idx, w, True),
            lambda: ek._check("k", {"values": vals.double()}, idx, w, True)):
        with pytest.raises((ValueError, TypeError)):
            bad()
    assert set(ek.LAUNCHES) == {"ell_spmm_fwd_only", "ell_sddmm",
                                "ell_spmm_transpose"}
    assert sum(ek.LAUNCHES.values()) == 0    # plain versions do not count


@settings(max_examples=30, deadline=None, database=None)
@given(num_dst=st.integers(1, 24), num_src=st.integers(1, 24),
       K=st.integers(1, 12), feat=st.integers(1, 40),
       seed=st.integers(0, 2**16))
def test_plain_versions_match_goldens_over_shapes(num_dst, num_src, K, feat,
                                                  seed):
    vals, idx, w, q = make_ell(seed, num_dst, num_src, K, feat)
    np.testing.assert_allclose(
        ek.ell_spmm_fwd_only(*T(vals, idx, w)).numpy(),
        pk.ref_ell_spmm(vals, idx, w), **TOL)
    np.testing.assert_allclose(
        ek.ell_sddmm(*T(q, vals, idx)).numpy(),
        pk.ref_ell_sddmm(q, vals, idx), **TOL)
    # adjoint identity <spmm(v), q> = <v, spmm_t(q)>
    lhs = (pk.ref_ell_spmm(vals, idx, w).astype(np.float64) * q).sum()
    rhs = (ek.ell_spmm_transpose(*T(q, idx, w), num_src).numpy()
           .astype(np.float64) * vals).sum()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-4)
