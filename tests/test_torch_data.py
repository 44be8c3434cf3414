"""The port's host layer against the JAX package's: config merge, synthetic
graphs, CSR variant removal, ``DataIterator`` and the device edge arrays
give identical results for the same inputs and seeds."""

import glob
import os

import numpy as np
import pytest
import torch

from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.graph import BipartiteGraphData as JGraphData
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.graph import BipartiteGraphData
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.utils import cfg_from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))
RATINGS_10 = tuple(np.arange(0.5, 5.01, 0.5))


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _csr_equal(a, b):
    for name in ("ind_ptr", "end_points", "values", "row_ids", "col_ids",
                 "multi_link"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_merge_matches(path):
    got, want = cfg_from_file(path), j_cfg_from_file(path)
    assert _plain(got) == _plain(want)
    got.DATASET.NAME = want.DATASET.NAME = "synthetic"
    for backend in ("auto", "bitdense"):
        got.KERNEL.BACKEND = want.KERNEL.BACKEND = backend
        for nu, ni in ((943, 1682), (69_878, 10_677)):
            t = build_model_config(got, nu, ni, 10)
            j = j_build_model_config(want, nu, ni, 10)
            for field in t.__dataclass_fields__:
                assert getattr(t, field) == getattr(j, field), field


def test_config_rejects_unknown_key(tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text("MODEL:\n  NOPE: 1\n")
    with pytest.raises(KeyError):
        cfg_from_file(str(p))


@pytest.mark.parametrize("kw", [
    dict(num_users=40, num_items=30, num_edges=500, seed=3),
    dict(num_users=50, num_items=20, num_edges=300, seed=0,
         rating_values=RATINGS_10),
    # the vectorised dedup branch (target > 2M), which ML-10M takes
    dict(num_users=3000, num_items=1500, num_edges=2_000_100, seed=5),
])
def test_synthetic_ratings_identical(kw):
    got = tsyn.synthetic_ratings(**kw)
    want = jsyn.synthetic_ratings(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 123])
def test_synthetic_graph_identical(seed):
    kw = dict(num_users=60, num_items=45, num_edges=700,
              rating_values=RATINGS_10, seed=seed)
    got, want = tsyn.synthetic_graph(**kw), jsyn.synthetic_graph(**kw)
    for key in ("user", "movie"):
        np.testing.assert_array_equal(got.features[key], want.features[key])
        np.testing.assert_array_equal(got.node_ids[key], want.node_ids[key])
    for pair in (("user", "movie"), ("movie", "user")):
        _csr_equal(got[pair], want[pair])
    assert got.meta_graph == want.meta_graph


def _split(graph, seed=0):
    pairs = graph["user", "movie"].node_pair_ids
    perm = np.random.RandomState(seed).permutation(pairs.shape[1])
    n = pairs.shape[1] // 10
    return pairs[:, perm[:n]], pairs[:, perm[n:2 * n]]


def test_csr_lookup_and_removal_identical():
    kw = dict(num_users=40, num_items=30, num_edges=500, seed=3)
    tcsr = tsyn.synthetic_graph(**kw)["user", "movie"]
    jcsr = jsyn.synthetic_graph(**kw)["user", "movie"]
    rng = np.random.RandomState(1)
    # half real edges, half arbitrary pairs (mostly non-edges)
    real = tcsr.node_pair_ids[:, rng.permutation(tcsr.nnz)[:60]]
    other = np.stack([rng.randint(0, 40, 60), rng.randint(0, 30, 60)])
    q = np.concatenate([real, other], axis=1).astype(np.int32)
    np.testing.assert_array_equal(tcsr.edge_indices_by_id(q),
                                  jcsr.edge_indices_by_id(q))
    np.testing.assert_array_equal(tcsr.fetch_edges_by_id(q),
                                  jcsr.fetch_edges_by_id(q))
    _csr_equal(tcsr.remove_edges_by_id(q), jcsr.remove_edges_by_id(q))
    _csr_equal(tcsr.T, jcsr.T)
    np.testing.assert_array_equal(tcsr.node_pair_ids, jcsr.node_pair_ids)


def test_data_iterator_identical():
    kw = dict(num_users=50, num_items=35, num_edges=600,
              rating_values=RATINGS_10, seed=7)
    tg, jg = tsyn.synthetic_graph(**kw), jsyn.synthetic_graph(**kw)
    test_pairs, valid_pairs = _split(tg)
    common = dict(test_node_pairs=test_pairs, valid_node_pairs=valid_pairs,
                  embed_P_mask=0.1, embed_p_zero=0.0, embed_p_self=1.0,
                  seed=123)
    t = DataIterator(tg, "user", "movie", **common)
    j = JDataIterator(jg, "user", "movie", **common)
    for name in ("test_graph", "val_graph", "train_graph"):
        for pair in (("user", "movie"), ("movie", "user")):
            _csr_equal(getattr(t, name)[pair], getattr(j, name)[pair])
    for name in ("train_node_pairs", "train_ratings", "valid_node_pairs",
                 "valid_ratings", "test_node_pairs", "test_ratings",
                 "possible_rating_values"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    for key in ("user", "movie"):
        np.testing.assert_array_equal(t.evaluate_embed_noise_dict[key],
                                      j.evaluate_embed_noise_dict[key])


def test_data_iterator_rejects_inductive():
    """An inductive split needs the held-out node type; the split itself
    is held against the JAX package in ``tests/test_torch_inductive.py``."""
    g = tsyn.synthetic_graph(num_users=20, num_items=10, num_edges=80)
    test_pairs, valid_pairs = _split(g)
    with pytest.raises(ValueError, match="inductive_key"):
        DataIterator(g, "user", "movie", is_inductive=True,
                     test_node_pairs=test_pairs, valid_node_pairs=valid_pairs)


def test_device_graph_identical():
    kw = dict(num_users=40, num_items=30, num_edges=500,
              rating_values=RATINGS_10, seed=3)
    tcsr = tsyn.synthetic_graph(**kw)["user", "movie"]
    jcsr = jsyn.synthetic_graph(**kw)["user", "movie"]
    t = BipartiteGraphData.from_csr(tcsr, device="cpu")
    j = JGraphData.from_csr(jcsr)
    for name in ("edge_user", "edge_item", "edge_rating", "edge_pad_mask"):
        tv = getattr(t, name)
        assert tv.device == torch.device("cpu")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (t.num_users, t.num_items, t.num_links) == (
        j.num_users, j.num_items, j.num_links)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_from_coo_identical_with_duplicates(seed):
    """Unsorted COO input with repeated pairs: columns sorted within rows
    and repeats summed, as the JAX package's scipy-built CSR has them."""
    from stargcn_tpu.graph import CSRMat as JCSRMat
    from stargcn_tpu_torch.graph import CSRMat

    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 25, 400)
    cols = rng.randint(0, 18, 400)
    vals = rng.randint(1, 6, 400).astype(np.float32)
    got = CSRMat.from_coo(rows, cols, vals, 27, 18, multi_link=[1, 2, 3])
    want = JCSRMat.from_coo(rows, cols, vals, 27, 18, multi_link=[1, 2, 3])
    _csr_equal(got, want)
    _csr_equal(got.T, want.T)
    np.testing.assert_array_equal(got.row_indices, want.row_indices)
