"""The port's host graph layer for inductive splits against the JAX
package's: ``csr_submat``, ``CSRMat.submat`` / ``submat_by_id``,
``HeterGraph.sel_subgraph_by_id`` keyed on users and on items, edge
fetching and removal by index, ``save`` / ``load`` round trips (each
package loading what the other saved) and the consistency checks.  Every
array must be equal, dtype included."""

import numpy as np
import pytest

from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.graph import CSRMat as JCSRMat
from stargcn_tpu.graph import HeterGraph as JHeterGraph
from stargcn_tpu.graph import kernels as jkernels
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.graph import CSRMat, HeterGraph
from stargcn_tpu_torch.graph import kernels as tkernels

GRAPH = dict(num_users=40, num_items=30, num_edges=420, seed=3)
CSR_FIELDS = ("ind_ptr", "end_points", "values", "row_ids", "col_ids",
              "multi_link")


def _csr_equal(a, b):
    for name in CSR_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert x.dtype == y.dtype, name
    np.testing.assert_array_equal(a.node_pair_ids, b.node_pair_ids)


def _graph_equal(a, b):
    assert a.edge_pairs == b.edge_pairs
    for pair in (("user", "movie"), ("movie", "user")):
        _csr_equal(a[pair], b[pair])
    for key in ("user", "movie"):
        np.testing.assert_array_equal(a.node_ids[key], b.node_ids[key])
        np.testing.assert_array_equal(a.features[key], b.features[key])


def _random_csr(rng):
    """Ragged rows with unsorted columns, empty rows, and an empty
    matrix now and then."""
    nr, nc = rng.randint(1, 25), rng.randint(1, 25)
    deg = rng.randint(0, nc + 1, nr) * (rng.rand(nr) < 0.8)
    ind_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ends = [rng.permutation(nc)[:d] for d in deg]
    ep = (np.concatenate(ends) if deg.sum() else np.zeros(0)).astype(np.int32)
    return ind_ptr, ep, nr, nc


@pytest.mark.parametrize("trial", range(3))
def test_csr_submat_matches_jax(trial):
    """Rows in any order, columns any subset in any order (renumbered by
    position, not sorted), the original edge positions as int64."""
    rng = np.random.RandomState(trial)
    for _ in range(40):
        ind_ptr, ep, nr, nc = _random_csr(rng)
        rows = rng.choice(nr, rng.randint(0, nr + 1), replace=False)
        cols = rng.choice(nc, rng.randint(0, nc + 1), replace=False)
        want = jkernels.csr_submat(ind_ptr, ep, rows, cols, nc)
        got = tkernels.csr_submat(ind_ptr, ep, rows, cols, nc)
        assert got[2].dtype == np.int64
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("row_ids,col_ids", [
    (None, "perm"), ("perm", None), ("perm", "perm"), ("empty", None)])
def test_submat_by_id_matches_jax(row_ids, col_ids):
    jcsr = jsyn.synthetic_graph(**GRAPH)["user", "movie"]
    tcsr = tsyn.synthetic_graph(**GRAPH)["user", "movie"]
    rng = np.random.RandomState(7)

    def ids(kind, n):
        if kind is None:
            return None
        if kind == "empty":
            return np.zeros(0, np.int32)
        return rng.permutation(n)[:n * 2 // 3].astype(np.int32)

    r, c = ids(row_ids, 40), ids(col_ids, 30)
    _csr_equal(tcsr.submat_by_id(r, c), jcsr.submat_by_id(r, c))
    rows = None if r is None else tcsr.row_id_to_ind(r)
    cols = None if c is None else tcsr.col_id_to_ind(c)
    _csr_equal(tcsr.submat(rows, cols), jcsr.submat(rows, cols))
    # a submatrix is a submatrix, and its transpose holds the same edges
    sub = tcsr.submat_by_id(r, c)
    assert sub.issubmat(tcsr) and sub.issubmat(jcsr)
    assert sub.issubmat(sub.T.T)
    sub.check_consistency()
    _csr_equal(sub.T, jcsr.submat_by_id(r, c).T)


@pytest.mark.parametrize("key", ["user", "movie"])
def test_sel_subgraph_by_id_matches_jax(key):
    """The selected type's nodes shrink to the ids given, in that order;
    the other type keeps all its nodes; both directions equal."""
    jg = jsyn.synthetic_graph(**GRAPH)
    tg = tsyn.synthetic_graph(**GRAPH)
    n = 40 if key == "user" else 30
    ids = np.random.RandomState(2).permutation(n)[:n // 2].astype(np.int32)
    jsub, tsub = jg.sel_subgraph_by_id(key, ids), tg.sel_subgraph_by_id(
        key, ids)
    _graph_equal(tsub, jsub)
    np.testing.assert_array_equal(tsub.node_ids[key], ids)
    axis = 0 if key == "user" else 1
    pairs = tsub["user", "movie"].node_pair_ids
    assert np.isin(pairs[axis], ids).all()
    full = tg["user", "movie"].node_pair_ids
    assert pairs.shape[1] == np.isin(full[axis], ids).sum()
    tsub.check_consistency()
    assert tsub["user", "movie"].issubmat(tg["user", "movie"])
    # then the valid pairs leave it, as the inductive valid graph is built
    valid = pairs[:, ::3]
    _graph_equal(tsub.remove_edges_by_id("user", "movie", valid),
                 jsub.remove_edges_by_id("user", "movie", valid))


def test_id_maps_features_and_structure_match_jax():
    jg = jsyn.synthetic_graph(**GRAPH)
    tg = tsyn.synthetic_graph(**GRAPH)
    ids = np.array([5, 1, 17, 3], np.int32)
    jsub, tsub = (g.sel_subgraph_by_id("movie", ids) for g in (jg, tg))
    for a, b in ((tg, jg), (tsub, jsub)):
        np.testing.assert_array_equal(a.node_id_to_ind("movie", ids),
                                      b.node_id_to_ind("movie", ids))
        np.testing.assert_array_equal(a.features_by_id("user", [3, 0, 9]),
                                      b.features_by_id("user", [3, 0, 9]))
        assert a.get_multi_link_structure() == b.get_multi_link_structure()
        assert list(a.node_names) == list(b.node_names)
        assert (("user", "movie") in a) and (("movie", "user") in a)
        assert ("user", "user") not in a
    # an id outside the subset maps to -1, and the strict lookup refuses it
    assert tsub["movie", "user"].row_id_to_ind(2) == -1
    with pytest.raises(ValueError, match="not in this graph"):
        tsub["movie", "user"].rows_of([5, 2])
    with pytest.raises(ValueError, match="not in this graph"):
        tsub["movie", "user"].rows_of([40])
    np.testing.assert_array_equal(tsub["movie", "user"].rows_of(ids[::-1]),
                                  [3, 2, 1, 0])
    tg.check_continous_node_ids()
    jg.check_continous_node_ids()
    with pytest.raises(ValueError, match="contiguous"):
        tsub.check_continous_node_ids()
    feats = tg.device_features("cpu")
    assert feats["user"].dtype.is_floating_point
    np.testing.assert_array_equal(feats["movie"].numpy(),
                                  tg.features["movie"])


def test_fetch_and_remove_by_ind_match_jax():
    jcsr = jsyn.synthetic_graph(**GRAPH)["user", "movie"]
    tcsr = tsyn.synthetic_graph(**GRAPH)["user", "movie"]
    rng = np.random.RandomState(4)
    inds = np.stack([rng.randint(0, 40, 200), rng.randint(0, 30, 200)])
    got, want = tcsr.fetch_edges_by_ind(inds), jcsr.fetch_edges_by_ind(inds)
    assert (got > 0).any() and (got == 0).any()
    np.testing.assert_array_equal(got, want)
    _csr_equal(tcsr.remove_edges_by_ind(inds), jcsr.remove_edges_by_ind(inds))
    assert tcsr.size == jcsr.size == tcsr.nnz


@pytest.mark.parametrize("writer,reader", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_save_load_round_trip(tmp_path, writer, reader):
    """A graph (an inductive subgraph, whose ids are a permuted subset)
    saved by one package loads equal in the other."""
    pkgs = {"torch": (tsyn, HeterGraph, CSRMat),
            "jax": (jsyn, JHeterGraph, JCSRMat)}
    syn, _, _ = pkgs[writer]
    ids = np.random.RandomState(1).permutation(30)[:20].astype(np.int32)
    g = syn.synthetic_graph(**GRAPH).sel_subgraph_by_id("movie", ids)
    g.save(str(tmp_path / "g"))
    g["user", "movie"].save(str(tmp_path / "m.npz"))
    _, hetero, csr = pkgs[reader]
    back = hetero.load(str(tmp_path / "g"))
    _graph_equal(back, g)
    back.check_consistency()
    _csr_equal(csr.load(str(tmp_path / "m.npz")), g["user", "movie"])


def test_check_consistency_catches_a_duplicate_end_point():
    m = CSRMat(ind_ptr=[0, 2, 3], end_points=[1, 1, 0], values=[1, 2, 3],
               row_ids=[0, 1], col_ids=[0, 1])
    with pytest.raises(AssertionError, match="row 0"):
        m.check_consistency()
    jm = JCSRMat(ind_ptr=[0, 2, 3], end_points=[1, 1, 0], values=[1, 2, 3],
                 row_ids=[0, 1], col_ids=[0, 1])
    with pytest.raises(AssertionError, match="row 0"):
        jm.check_consistency()
