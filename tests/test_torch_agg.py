"""The port's ``ops/agg.py`` and the pair lookup of ``graph/device.py``
against the JAX package's, on the same seeded numpy inputs: values, and
gradients through the JAX vjp and torch autograd of one random cotangent.

Tolerances, relative to the largest value: 1e-5 for float32 sums that the
two packages order differently; 1e-4 where the edges go through in
chunks (another order again); 2e-3 for a bf16 adjacency product, whose
scaled operand and cotangent are rounded to bf16 in both packages and
whose float32 sums may round a last bf16 bit the other way.  Integer and
0/1 results are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stargcn_tpu.ops.agg as J
import stargcn_tpu_torch.ops.agg as T
from stargcn_tpu.graph.device import BipartiteGraphData as JGraph
from stargcn_tpu.train.loop import resolve_edge_chunk as j_resolve_edge_chunk
from stargcn_tpu_torch.graph.device import BipartiteGraphData, EdgeSet
from stargcn_tpu_torch.models import resolve_edge_chunk


def make_edges(rng, num_src, num_dst, num_links, E):
    return (rng.randint(0, num_src, size=E).astype(np.int32),
            rng.randint(0, num_dst, size=E).astype(np.int32),
            rng.randint(0, num_links, size=E).astype(np.int32),
            rng.uniform(0.1, 1.0, size=E).astype(np.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _vjp_both(jfn, tfn, diff, rng, rel, rel_grad=None):
    """``jfn(*jax arrays)`` and ``tfn(*tensors)`` of the float arrays
    ``diff``: values and the gradient of each, for one cotangent."""
    want, vjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in diff])
    targs = [t(a).requires_grad_(True) for a in diff]
    got = tfn(*targs)
    _close(got, want, rel, "values")
    ct = rng.normal(size=np.shape(want)).astype(np.float32)
    for k, (jg, tg) in enumerate(zip(
            vjp(jnp.asarray(ct)), torch.autograd.grad(got, targs, t(ct)))):
        _close(tg, jg, rel_grad or rel, f"gradient of input {k}")


@pytest.mark.parametrize("chunk", [None, 7, 64])
def test_gather_weighted_segment_sum(rng, chunk):
    n, U, E, S = 19, 5, 60, 11
    values = rng.normal(size=(n, U)).astype(np.float32)
    gidx = rng.randint(0, n, size=E).astype(np.int32)
    seg = rng.randint(0, S, size=E).astype(np.int32)
    w = rng.normal(size=E).astype(np.float32)
    _vjp_both(lambda v, ww: J.gather_weighted_segment_sum(
                  v, jnp.asarray(gidx), ww, jnp.asarray(seg), S),
              lambda v, ww: T.gather_weighted_segment_sum(
                  v, t(gidx), ww, t(seg), S, chunk=chunk),
              (values, w), rng, 1e-5)


def test_gather_scatter_saves_no_message_buffer(rng):
    """The flat aggregation keeps the index arrays and the weights for its
    backward, never an ``(E, units)`` message buffer."""
    n, U, E, S = 50, 16, 400, 30
    values = torch.randn(n, U, requires_grad=True)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = T.gather_weighted_segment_sum(
            values, t(rng.randint(0, n, E)), torch.rand(E),
            t(rng.randint(0, S, E)), S, chunk=64)
    assert saved and all(s == (E,) for s in saved), saved
    out.sum().backward()
    assert values.grad.shape == (n, U)


def _agg_inputs(rng, R=4, num_src=13, num_dst=9, E=60, U=6):
    es, ed, er, sup = make_edges(rng, num_src, num_dst, R, E)
    proj = rng.normal(size=(R, num_src, U)).astype(np.float32)
    return proj, es, ed, er, sup, num_dst


@pytest.mark.parametrize("accum", ["stack", "sum"])
@pytest.mark.parametrize("backend,chunk", [
    ("xla", None), ("xla", 8), ("xla", 1000), ("dense", None)])
def test_multi_link_aggregate(rng, accum, backend, chunk):
    proj, es, ed, er, sup, nd = _agg_inputs(rng)
    rel = 1e-4 if chunk else 1e-5
    _vjp_both(lambda p, s: J.multi_link_aggregate(
                  p, jnp.asarray(es), jnp.asarray(ed), jnp.asarray(er), s,
                  nd, accum=accum, backend=backend, edge_chunk=chunk),
              lambda p, s: T.multi_link_aggregate(
                  p, t(es), t(ed), t(er), s, nd, accum=accum,
                  backend=backend, edge_chunk=chunk),
              (proj, sup), rng, rel)


@pytest.mark.parametrize("transposed", [False, True])
def test_multi_link_aggregate_prebuilt_dense_support(rng, transposed):
    proj, es, ed, er, sup, nd = _agg_inputs(rng)
    R, ns = proj.shape[:2]
    if transposed:    # the (R, num_src, num_dst) layout of the other side
        ds = np.array(J.build_dense_support(es, ed, er, sup, R, nd, ns))
        ds = np.ascontiguousarray(ds.transpose(0, 2, 1))
    else:
        ds = np.array(J.build_dense_support(es, ed, er, sup, R, nd, ns))
    _vjp_both(lambda p, d: J.multi_link_aggregate(
                  p, es, ed, er, sup, nd, backend="dense", dense_support=d,
                  dense_transposed=transposed),
              lambda p, d: T.multi_link_aggregate(
                  p, t(es), t(ed), t(er), t(sup), nd, backend="dense",
                  dense_support=d, dense_transposed=transposed),
              (proj, ds), rng, 1e-5)


def test_multi_link_aggregate_rejects_unknown_names(rng):
    proj, es, ed, er, sup, nd = _agg_inputs(rng)
    args = (t(proj), t(es), t(ed), t(er), t(sup), nd)
    with pytest.raises(ValueError, match="backend"):
        T.multi_link_aggregate(*args, backend="ell-x")
    with pytest.raises(ValueError, match="accum"):
        T.multi_link_aggregate(*args, accum="max")


def test_multi_link_project_gradients(rng):
    x = rng.normal(size=(7, 5)).astype(np.float32)
    W = rng.normal(size=(3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    for ordinal in (False, True):
        _vjp_both(lambda *a: J.multi_link_project(*a, ordinal_sharing=ordinal),
                  lambda *a: T.multi_link_project(*a,
                                                  ordinal_sharing=ordinal),
                  (x, W, b), rng, 1e-5)


def _adjacency(rng, R, D, S, p=0.4):
    return (rng.uniform(size=(R, D, S)) < p).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True])
def test_scaled_dense_aggregate(rng, dtype, transposed):
    R, D, S, U = 3, 17, 11, 6
    adj = _adjacency(rng, R, S if transposed else D, D if transposed else S)
    adj[0, 0, 0] = -1.0      # a removed edge counted twice: adj - delta
    proj = rng.normal(size=(R, S, U)).astype(np.float32)
    ds = rng.uniform(0.2, 1.0, D).astype(np.float32)
    ss = rng.uniform(0.2, 1.0, S).astype(np.float32)
    jadj = jnp.asarray(adj, getattr(jnp, dtype))
    tadj = t(adj).to(getattr(torch, dtype))
    rel = 1e-5 if dtype == "float32" else 2e-3
    _vjp_both(lambda p, a, b: J.scaled_dense_aggregate(
                  p, jadj, a, b, transposed=transposed),
              lambda p, a, b: T.scaled_dense_aggregate(
                  p, tadj, a, b, transposed=transposed),
              (proj, ds, ss), rng, rel)


def test_scaled_dense_aggregate_rounds_like_jax(rng):
    """The bf16 route rounds the scaled projection before the product and
    its cotangent after it: on small integer data (exact in float32) the
    port's values and gradients are the JAX package's bit for bit."""
    R, D, S, U = 2, 9, 7, 3
    adj = _adjacency(rng, R, D, S)
    proj = (rng.randint(-300, 300, (R, S, U)) / 7.0).astype(np.float32)
    ds = np.full(D, 1.0, np.float32)
    ss = np.full(S, 1.0, np.float32)
    ct = (rng.randint(-300, 300, (D, R, U)) / 3.0).astype(np.float32)
    want, vjp = jax.vjp(lambda p: J.scaled_dense_aggregate(
        p, jnp.asarray(adj, jnp.bfloat16), jnp.asarray(ds), jnp.asarray(ss)),
        jnp.asarray(proj))
    p = t(proj).requires_grad_(True)
    got = T.scaled_dense_aggregate(p, t(adj).bfloat16(), t(ds), t(ss))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g,) = torch.autograd.grad(got, p, t(ct))
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(vjp(jnp.asarray(ct))[0]))
    # ... and the rounding is real: the float32 adjacency differs.
    f32 = T.scaled_dense_aggregate(t(proj), t(adj), t(ds), t(ss))
    assert not torch.equal(f32, got.detach())


def test_removed_edges_correction(rng):
    R, ns, nd, U, B = 3, 12, 8, 5, 20
    proj = rng.normal(size=(R, ns, U)).astype(np.float32)
    rs, rd, rr, _ = make_edges(rng, ns, nd, R, B)
    rw = (rng.uniform(size=B) < 0.7).astype(np.float32) * 0.3
    _vjp_both(lambda p, w: J.removed_edges_correction(
                  p, jnp.asarray(rs), jnp.asarray(rd), jnp.asarray(rr), w,
                  nd),
              lambda p, w: T.removed_edges_correction(
                  p, t(rs), t(rd), t(rr), w, nd),
              (proj, rw), rng, 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_build_dense_adjacency(rng, dtype):
    R, nd, ns, E = 3, 10, 7, 80          # E > R*nd*ns/3: repeated entries
    es, ed, er, _ = make_edges(rng, ns, nd, R, E)
    mask = (rng.uniform(size=E) < 0.8).astype(np.float32)
    got = T.build_dense_adjacency(t(es), t(ed), t(er), t(mask), R, nd, ns,
                                  dtype=getattr(torch, dtype))
    want = J.build_dense_adjacency(jnp.asarray(es), jnp.asarray(ed),
                                   jnp.asarray(er), jnp.asarray(mask), R, nd,
                                   ns, dtype=getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (R, nd, ns)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert set(np.unique(got.float().numpy())) <= {0.0, 1.0}


def test_build_dense_support(rng):
    R, nd, ns, E = 3, 10, 7, 80
    es, ed, er, sup = make_edges(rng, ns, nd, R, E)
    _vjp_both(lambda s: J.build_dense_support(es, ed, er, s, R, nd, ns),
              lambda s: T.build_dense_support(t(es), t(ed), t(er), s, R, nd,
                                              ns),
              (sup,), rng, 1e-6)


@pytest.mark.parametrize("symm", [True, False])
def test_masked_degrees_and_edge_support(rng, symm):
    ns, nd, E = 15, 11, 90
    es, ed, _, _ = make_edges(rng, ns, nd, 1, E)
    mask = (rng.uniform(size=E) < 0.6).astype(np.float32)
    es[:5] = 14                  # a source whose every edge is masked
    mask[:5] = 0.0
    got = T.masked_degrees(t(es), t(ed), t(mask), ns, nd)
    want = J.masked_degrees(jnp.asarray(es), jnp.asarray(ed),
                            jnp.asarray(mask), ns, nd)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sup = T.edge_support(*got, t(es), t(ed), t(mask), symm=symm)
    jsup = J.edge_support(*want, jnp.asarray(es), jnp.asarray(ed),
                          jnp.asarray(mask), symm=symm)
    _close(sup, jsup, 1e-6)
    assert float(sup[:5].abs().sum()) == 0.0


# --------------------------- the pair lookup ------------------------------


def _graphs(rng, nu=23, ni=17, E=150, R=4):
    keys = rng.choice(nu * ni, E, replace=False)
    u, i = keys // ni, keys % ni
    r = rng.randint(0, R, E)
    return (BipartiteGraphData.from_arrays(u, i, r, nu, ni, R, "cpu",
                                           pad_multiple=64),
            JGraph.from_arrays(u, i, r, nu, ni, R, pad_multiple=64), u, i)


def test_lookup_keys_match_jax(rng):
    g, jg, _, _ = _graphs(rng)
    assert g.has_pair_lookup == jg.has_pair_lookup
    np.testing.assert_array_equal(g.lookup_keys.numpy(),
                                  np.asarray(jg.lookup_keys))
    np.testing.assert_array_equal(g.lookup_perm.numpy(),
                                  np.asarray(jg.lookup_perm))
    assert g.lookup_keys.dtype == torch.int32
    # the sentinel sits above every key, on the padded slots
    assert int(g.lookup_keys[-1]) == 23 * 17 + 1
    big = BipartiteGraphData.from_arrays([0], [0], [0], 70_000, 40_000, 1,
                                         "cpu")
    assert not big.has_pair_lookup
    with pytest.raises(ValueError, match="int32"):
        big.edge_mask_from_pairs(torch.zeros(1, dtype=torch.long),
                                 torch.zeros(1, dtype=torch.long),
                                 torch.ones(1), big.edge_pad_mask)


def test_edge_mask_from_pairs_matches_jax(rng):
    """Hits zero their edge; misses (pairs that are no edge, including ones
    whose search ends on a padded slot), invalid slots and repeated pairs
    leave every other edge as it was."""
    g, jg, u, i = _graphs(rng)
    base = (rng.uniform(size=g.num_edges_padded) < 0.9).astype(np.float32)
    base *= g.edge_pad_mask.numpy()
    hits = rng.choice(u.size, 12, replace=False)
    pu = np.concatenate([u[hits], u[hits[:3]], [22, 0, 22, 5],
                         u[hits[:2]]]).astype(np.int32)
    pi = np.concatenate([i[hits], i[hits[:3]], [16, 0, 0, 3],
                         i[hits[:2]]]).astype(np.int32)
    valid = np.ones(pu.size, np.float32)
    valid[-2:] = 0.0                           # invalid slots name edges
    assert len({(a, b) for a, b in zip(u, i)}
               & set(zip(pu[12:-2], pi[12:-2]))) < 7   # some misses
    got = g.edge_mask_from_pairs(t(pu).long(), t(pi).long(), t(valid),
                                 t(base))
    want = jg.edge_mask_from_pairs(jnp.asarray(pu), jnp.asarray(pi),
                                   jnp.asarray(valid), jnp.asarray(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    named = set(zip(pu[valid > 0], pi[valid > 0]))
    expect = base.copy()
    for k in range(u.size):
        if (u[k], i[k]) in named:
            expect[k] = 0.0
    np.testing.assert_array_equal(got.numpy(), expect)


def test_mask_from_edge_indices_and_edge_set(rng):
    g, jg, _, _ = _graphs(rng)
    idx = np.asarray([0, 5, 7, 149])
    m = g.mask_from_edge_indices(idx)
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jg.mask_from_edge_indices(idx)))
    assert m.dtype == torch.float32 and m.device == g.edge_user.device
    es = EdgeSet(g, m)
    assert es.graph is g and es.mask is m


@pytest.mark.parametrize("backend,num_edges,units,budget", [
    ("xla", 10_000_000, (250,), 1500),       # ML-10M: chunks of 1,441,792
    ("xla", 1_000_209, (250,), 1500),        # ML-1M: fits, no chunks
    ("xla", 1_000_209, (500,), 100),         # a small budget: 65,536 floor
    ("xla", None, (250,), 1500),
    ("dense", 10_000_000, (250,), 1500),
    ("bitdense", 10_000_000, (250,), 1500),
])
def test_resolve_edge_chunk_matches_jax(backend, num_edges, units, budget):
    got = resolve_edge_chunk(backend, num_edges, units, budget)
    assert got == j_resolve_edge_chunk(backend, num_edges, units, budget)
    if backend == "xla" and num_edges == 10_000_000 and budget == 1500:
        assert got == 1_441_792 and -(-num_edges // got) == 7
