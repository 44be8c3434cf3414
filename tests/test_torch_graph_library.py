"""The port's host graph library (``stargcn_tpu_torch/graph/kernels.py`` and
``graph/csr.py``) against the JAX package's NumPy path, array for array and
dtype for dtype, on small random graphs made from numpy seeds.

The JAX package's C++ extension is switched off inside each test
(``stargcn_tpu.graph.kernels._native`` patched to None), so its NumPy path
runs even where the extension is built.  The random functions draw from
each package's seeded stream: ``set_seed(s)`` in both, then the same calls
in the same order must give equal arrays, over a few seeds.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stargcn_tpu.graph import csr as jcsr
from stargcn_tpu.graph import kernels as jk
from stargcn_tpu_torch import graph as tgraph
from stargcn_tpu_torch.graph import csr as tcsr
from stargcn_tpu_torch.graph import kernels as tk

SEEDS = (0, 1, 7)
RATINGS = (1.0, 2.0, 3.0, 4.0, 5.0)


@pytest.fixture(autouse=True)
def _numpy_path(monkeypatch):
    monkeypatch.setattr(jk, "_native", None)


def _same(got, want, what=""):
    """Equal structure, equal arrays, equal dtypes."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _arrays(seed, rows=30, cols=25, density=0.25, square=False):
    """A random CSR (some rows empty) as (ind_ptr, end_points, values)."""
    rng = np.random.RandomState(seed)
    cols = rows if square else cols
    dense = rng.rand(rows, cols) < density
    dense[rng.choice(rows, 3, replace=False)] = False
    vals = rng.choice(RATINGS, (rows, cols)).astype(np.float32) * dense
    m = sp.csr_matrix(vals)
    return (m.indptr.astype(np.int32), m.indices.astype(np.int32),
            m.data.astype(np.float32))


def _mats(seed, **kw):
    """The same ``CSRMat`` in both packages, its ids not the indices."""
    ind_ptr, end_points, values = _arrays(seed, **kw)
    rng = np.random.RandomState(seed + 100)
    nr, nc = ind_ptr.size - 1, int(kw.get("cols", 25))
    row_ids = (rng.permutation(nr) + 7).astype(np.int32)
    col_ids = (rng.permutation(nc) * 2 + 3).astype(np.int32)
    args = (ind_ptr, end_points, values, row_ids, col_ids, RATINGS)
    return jcsr.CSRMat(*args), tcsr.CSRMat(*args)


def _mat_arrays(m):
    return (m.ind_ptr, m.end_points, m.values, m.row_ids, m.col_ids,
            m.multi_link)


# --------------------------------- kernels ---------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_kernels_match(seed):
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 12, 80)
    _same(tk.unique_cnt(arr), jk.unique_cnt(arr), "unique_cnt")
    for data in (rng.rand(50).astype(np.float32),
                 rng.randint(0, 9, 50).astype(np.int32),
                 rng.rand(50)):
        idx = rng.randint(0, 50, 30)
        _same(tk.take_1d(data, idx), jk.take_1d(data, idx), "take_1d")
    ind_ptr, end_points, values = _arrays(seed)
    rhs = rng.rand(ind_ptr.size - 1)
    _same(tk.seg_sum(values, ind_ptr), jk.seg_sum(values, ind_ptr))
    _same(tk.seg_add(values, rhs, ind_ptr), jk.seg_add(values, rhs, ind_ptr))
    _same(tk.seg_mul(values, rhs, ind_ptr), jk.seg_mul(values, rhs, ind_ptr))
    for ml in (RATINGS, (5.0, 1.0, 3.0), (2.0, 9.0)):
        _same(tk.multi_link_split(values, ind_ptr, ml),
              jk.multi_link_split(values, ind_ptr, ml), f"split {ml}")
    for remove in (rng.choice(values.size, 17, replace=False), [],
                   np.arange(values.size)):
        _same(tk.remove_edges_by_indices(ind_ptr, end_points, remove),
              jk.remove_edges_by_indices(ind_ptr, end_points, remove))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_kernels_match_under_equal_seeds(seed):
    """One stream per package, seeded alike, consumed by the same calls in
    the same order (each call advances it)."""
    ind_ptr, end_points, _ = _arrays(seed, square=True)
    n = ind_ptr.size - 1
    node_ids = (np.random.RandomState(seed).permutation(n) * 3).astype(
        np.int32)
    sel = np.random.RandomState(seed + 1).choice(n, 12, replace=False)
    tk.set_seed(seed)
    jk.set_seed(seed)
    for _ in range(2):
        for start in (-1, int(sel[0])):
            _same(tk.random_walk(end_points, ind_ptr, start, walk_length=40),
                  jk.random_walk(end_points, ind_ptr, start, walk_length=40),
                  "random_walk")
        _same(tk.random_walk(end_points, ind_ptr, int(sel[1]), 60, 0.3, 6),
              jk.random_walk(end_points, ind_ptr, int(sel[1]), 60, 0.3, 6),
              "random_walk capped")
        for cap in (4, 1000):
            _same(tk.get_random_walk_nodes(end_points, ind_ptr, int(sel[2]),
                                           cap, 50),
                  jk.get_random_walk_nodes(end_points, ind_ptr, int(sel[2]),
                                           cap, 50), "walk nodes")
        for scale, replace in ((1.0, False), (2.5, False), (1.5, True)):
            _same(tk.uniform_neg_sampling(end_points, ind_ptr, sel, n, scale,
                                          replace),
                  jk.uniform_neg_sampling(end_points, ind_ptr, sel, n, scale,
                                          replace), f"neg {scale} {replace}")
        for fanout in (3, -1, 100):
            _same(tk.random_sel_neighbor_and_merge(end_points, ind_ptr,
                                                   node_ids, sel, fanout),
                  jk.random_sel_neighbor_and_merge(end_points, ind_ptr,
                                                   node_ids, sel, fanout),
                  f"merge {fanout}")


def test_kernel_surface():
    """Every function of the JAX module has a port, and every NumPy version
    that one of the port's native routes replaces is kept as
    ``plain_<name>``."""
    import inspect

    public = {n for n, f in inspect.getmembers(jk, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == jk.__name__}
    assert public <= set(dir(tk)), public - set(dir(tk))
    for name in ("unique_inverse", "unique_cnt", "take_1d",
                 "row_indices_from_indptr", "seg_sum", "seg_add", "seg_mul",
                 "csr_submat", "multi_link_split", "remove_edges_by_indices"):
        assert callable(getattr(tk, "plain_" + name)), name


# ----------------------------------- CSR -----------------------------------


def test_empty_as_zero_and_merges():
    arrays = [np.array([], np.int64), np.array([3, 1]), np.zeros((0, 2))]
    for dtype in (np.int32, np.float32):
        _same(tcsr.empty_as_zero(arrays, dtype),
              jcsr.empty_as_zero(arrays, dtype))
    rng = np.random.RandomState(4)
    lists = [rng.randint(0, 20, 15), rng.randint(5, 30, (3, 4)),
             np.array([], np.int32), np.array([7])]
    _same(tgraph.merge_nodes(lists), jcsr.merge_nodes(lists), "merge_nodes")
    dicts = [{"user": lists[0], "movie": lists[1]},
             {"movie": lists[3]}, {"tag": lists[2], "user": lists[1]}]
    t_uniq, t_inv = tgraph.merge_node_ids_dict(dicts)
    j_uniq, j_inv = jcsr.merge_node_ids_dict(dicts)
    assert list(t_uniq) == list(j_uniq)
    for key in j_uniq:
        _same(t_uniq[key], j_uniq[key], key)
    for t_d, j_d in zip(t_inv, j_inv):
        assert list(t_d) == list(j_d)
        for key in j_d:
            _same(t_d[key], j_d[key], key)


def test_node_features_take_by_id():
    rng = np.random.RandomState(2)
    ids = (rng.permutation(20) * 5 + 11).astype(np.int32)
    data = rng.rand(20, 3).astype(np.float32)
    query = ids[rng.randint(0, 20, 9)]
    want = jcsr.NodeFeatures(data, ids).take_by_id(query)
    got = tgraph.NodeFeatures(data, ids)
    _same(got.take_by_id(query), want, "numpy")
    _same(got.rmap[query], jcsr.NodeFeatures(data, ids).rmap[query], "rmap")
    tensor = tgraph.NodeFeatures(torch.from_numpy(data), ids)
    out = tensor.take_by_id(query)
    assert isinstance(out, torch.Tensor) and out.device == tensor.data.device
    _same(out.numpy(), want, "tensor")
    for unknown in ([12], [ids.max() + 1], [ids.min() - 50]):
        with pytest.raises(ValueError, match="not in this graph"):
            got.take_by_id(unknown)
    with pytest.raises(ValueError, match="feature rows"):
        tgraph.NodeFeatures(data[1:], ids)
    assert repr(got) == "NodeFeatures(num=20, dim=(3,))"
    assert tcsr.NodeIDRMapFast is tcsr.NodeIDRMap


@pytest.mark.parametrize("seed", SEEDS)
def test_spy_round_trip_txt_and_pair_indices(seed, tmp_path):
    jm, tm = _mats(seed)
    _same(tm.node_pair_indices, jm.node_pair_indices, "node_pair_indices")
    t_sp, j_sp = tm.to_spy(), jm.to_spy()
    assert t_sp.shape == j_sp.shape
    _same((t_sp.indptr, t_sp.indices, t_sp.data),
          (j_sp.indptr, j_sp.indices, j_sp.data), "to_spy")
    before = tm.values.copy(), tm.end_points.copy(), tm.ind_ptr.copy()
    t_sp.data[:] = -1
    t_sp.indices[:] = 0
    t_sp.indptr[:] = 0
    _same((tm.values, tm.end_points, tm.ind_ptr), before, "aliased")
    mat = sp.random(17, 11, density=0.3, format="coo",
                    random_state=np.random.RandomState(seed))
    _same(_mat_arrays(tcsr.CSRMat.from_spy(mat, multi_link=RATINGS)),
          _mat_arrays(jcsr.CSRMat.from_spy(mat, multi_link=RATINGS)),
          "from_spy")
    _same(_mat_arrays(tcsr.CSRMat.from_spy(j_sp)),
          _mat_arrays(jcsr.CSRMat.from_spy(j_sp)), "from_spy csr")
    tm.save_edges_txt(tmp_path / "t.txt")
    jm.save_edges_txt(tmp_path / "j.txt")
    text = (tmp_path / "t.txt").read_bytes()
    assert text == (tmp_path / "j.txt").read_bytes()
    assert text.count(b"\n") == tm.nnz


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_submat_matches_under_equal_seeds(seed):
    jm, tm = _mats(seed)
    rows = np.random.RandomState(seed).choice(30, 10, replace=False)
    tk.set_seed(seed)
    jk.set_seed(seed)
    for _ in range(2):
        for ncols in (2, 5, -1):
            _same(_mat_arrays(tm.sample_submat(rows, ncols=ncols)),
                  _mat_arrays(jm.sample_submat(rows, ncols=ncols)),
                  f"sample_submat {ncols}")
        _same(_mat_arrays(tm.sample_submat(ncols=3)),
              _mat_arrays(jm.sample_submat(ncols=3)), "all rows")
        _same(_mat_arrays(tm.sample_submat_by_id(tm.row_ids[rows], 3)),
              _mat_arrays(jm.sample_submat_by_id(jm.row_ids[rows], 3)),
              "by id")
        _same(_mat_arrays(tm.sample_submat(rows, 2, seed=seed + 9)),
              _mat_arrays(jm.sample_submat(rows, 2, seed=seed + 9)),
              "one-shot seed")


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_neighbors_matches_under_equal_seeds(seed):
    jm, tm = _mats(seed)
    src = tm.row_ids[np.random.RandomState(seed).choice(30, 12,
                                                        replace=False)]
    tk.set_seed(seed)
    jk.set_seed(seed)
    for mat_pair in ((tm, jm), (tm.T, jm.T)):
        t_mat, j_mat = mat_pair
        for kw in (dict(), dict(symm=False), dict(num_neighbors=2),
                   dict(src_ids=src[:5] if t_mat is tm else None,
                        num_neighbors=3),
                   dict(use_multi_link=False, num_neighbors=4),
                   dict(num_neighbors=1, seed=seed + 3)):
            got = t_mat.sample_neighbors(**kw)
            want = j_mat.sample_neighbors(**kw)
            _same(got, want, f"sample_neighbors {kw}")
    # the support is the matrix's own, taken before sampling
    ep, vals, ptr, sup = tm.sample_neighbors(use_multi_link=False)
    _same(sup, tm.get_support(True))
    # the per-level counts add up to the edges sampled
    ep_l, _, ptr_l, _ = tm.sample_neighbors(num_neighbors=-1)
    assert sum(int(p[-1]) for p in ptr_l) == tm.nnz == sum(map(len, ep_l))
