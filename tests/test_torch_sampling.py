"""The port's host planner (``graph/kernels.py``, ``graph/csr.py``,
``graph/sampling.py``) against the JAX package's NumPy path: equal arrays
from equal seeds with the loop planner, and the vectorised planner held to
the same contract."""

import numpy as np
import pytest

from _torch_slice import reference_on_cpu, sampled_graphs, seed_planners
from stargcn_tpu.graph import kernels as jk
from stargcn_tpu.graph.sampling import BlockSampler as JBlockSampler
from stargcn_tpu_torch.graph import kernels as tk
from stargcn_tpu_torch.graph.sampling import BlockSampler, FrontierCapError


@pytest.fixture(autouse=True)
def numpy_reference():
    with reference_on_cpu():
        yield


@pytest.fixture(scope="module")
def graphs():
    return sampled_graphs()


def max_degree(g):
    return int(max(np.diff(g["user", "movie"].ind_ptr).max(),
                   np.diff(g["movie", "user"].ind_ptr).max()))


def assert_blocks_equal(a, b, weight_exact=True):
    assert len(a.frontiers) == len(b.frontiers)
    for fa, fb in zip(a.frontiers, b.frontiers):
        for t in ("user", "item"):
            np.testing.assert_array_equal(fa[t], fb[t])
    for la, lb in zip(a.blocks, b.blocks):
        for t in ("user", "item"):
            assert la[t].num_dst_real == lb[t].num_dst_real
            np.testing.assert_array_equal(la[t].nbr_pos, lb[t].nbr_pos)
            np.testing.assert_array_equal(la[t].rating, lb[t].rating)
            np.testing.assert_array_equal(la[t].weight, lb[t].weight)
            assert la[t].nbr_pos.dtype == lb[t].nbr_pos.dtype == np.int32
    for t in ("user", "item"):
        np.testing.assert_array_equal(a.target_pos[t], b.target_pos[t])


def test_host_kernels_equal_reference(graphs):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 9, 40).astype(np.int32)
    for got, want in zip(tk.unique_inverse(arr), jk.unique_inverse(arr)):
        np.testing.assert_array_equal(got, want)
    jg, tg = graphs
    for key in (("user", "movie"), ("movie", "user")):
        j, t = jg[key], tg[key]
        np.testing.assert_array_equal(t.row_degrees, j.row_degrees)
        np.testing.assert_array_equal(t.col_degrees, j.col_degrees)
        for symm in (True, False):
            np.testing.assert_array_equal(t.get_support(symm),
                                          j.get_support(symm))
        sel = rng.randint(0, j.shape[0], 12).astype(np.int32)
        for fanout in (-1, 2, 5):
            seed_planners(11)
            want = jk.random_sample_fix_neighbor(j.ind_ptr, sel, fanout)
            got = tk.random_sample_fix_neighbor(t.ind_ptr, sel, fanout)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    # the stream advances from call to call and restarts with set_seed
    ind_ptr = np.array([0, 20], np.int32)
    sel = np.zeros(1, np.int32)
    tk.set_seed(3)
    first = tk.random_sample_fix_neighbor(ind_ptr, sel, 4)[0]
    second = tk.random_sample_fix_neighbor(ind_ptr, sel, 4)[0]
    tk.set_seed(3)
    again = tk.random_sample_fix_neighbor(ind_ptr, sel, 4)[0]
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(first, again)


@pytest.mark.parametrize("fanout,caps,exclude,symm", [
    (-1, None, False, True),
    (3, None, False, True),
    (3, {"user": 64, "item": 64}, True, True),
    (4, {"user": 64, "item": 64}, True, False),
    (-1, None, True, True),
])
def test_loop_planner_equals_reference(graphs, fanout, caps, exclude, symm):
    jg, tg = graphs
    pairs = tg["user", "movie"].node_pair_ids[:, ::11]
    tu, ti = np.unique(pairs[0]), np.unique(pairs[1])
    out = []
    for cls, g, kw in ((JBlockSampler, jg, {}),
                       (BlockSampler, tg, {"planner": "loop"})):
        sampler = cls(g, num_layers=2, fanout=fanout, symm=symm,
                      node_pad=16, frontier_caps=caps, **kw)
        args = {}
        if exclude:
            keys, rem = sampler.removal_args(pairs[0], pairs[1])
            args = dict(exclude_keys=keys, removal_counts=rem)
        seed_planners(21)
        out.append([sampler.sample(tu, ti, **args) for _ in range(2)])
    for a, b in zip(*out):
        assert_blocks_equal(b, a)
    if exclude:
        # the batch's own edges carry no support
        blk = out[1][0].blocks[-1]["user"]
        assert (blk.weight == 0).any() and blk.weight.sum() > 0


def test_frontier_cap_error(graphs):
    _, tg = graphs
    sampler = BlockSampler(tg, num_layers=1, fanout=8,
                           frontier_caps={"user": 4, "item": 4})
    with pytest.raises(FrontierCapError, match="cap") as e:
        sampler.sample(np.arange(10, dtype=np.int32),
                       np.arange(10, dtype=np.int32))
    (t, needed), = e.value.needed.items()
    assert t in ("user", "item") and needed > 4
    assert isinstance(e.value, ValueError)
    with pytest.raises(ValueError, match="planner"):
        BlockSampler(tg, num_layers=1, planner="gpu")
    with pytest.raises(ValueError, match="positive fanout"):
        BlockSampler(tg, num_layers=1, fanout=-1,
                     frontier_caps={"user": 64, "item": 64}).sample(
            np.arange(3, dtype=np.int32), np.arange(3, dtype=np.int32))


@pytest.mark.parametrize("remove", [False, True])
def test_vectorised_planner_equals_loop_at_full_fanout(graphs, remove):
    """A fanout of at least every degree leaves nothing to chance, so the
    two routes give the same plan: frontiers, ELL blocks, supports
    (removal-adjusted when batch edges are excluded), exclusion zeros and
    target positions."""
    _, tg = graphs
    fanout = max_degree(tg)
    pairs = tg["user", "movie"].node_pair_ids[:, ::11]
    plans = []
    for planner in ("loop", "vectorised"):
        sampler = BlockSampler(tg, num_layers=2, fanout=fanout,
                               frontier_caps={"user": 64, "item": 64},
                               planner=planner)
        args = {}
        if remove:
            keys, rem = sampler.removal_args(pairs[0], pairs[1])
            args = dict(exclude_keys=keys, removal_counts=rem)
        plans.append(sampler.sample(np.unique(pairs[0]),
                                    np.unique(pairs[1]), **args))
    assert_blocks_equal(*plans)
    assert plans[0].blocks[-1]["user"].weight.sum() > 0


def test_vectorised_draws_are_uniform_without_replacement():
    """Rows of degree 10 and 4 under fanout 3: never a repeated edge in a
    row, never more than 3, the short row whole and in order, and over
    4000 draws every edge of the long rows chosen 3/10 of the time (a
    binomial with sigma 0.0072: held to 0.03)."""
    ind_ptr = np.array([0, 10, 14, 24, 24], np.int32)
    sel = np.array([0, 1, 2, 3, 0], np.int32)
    tk.set_seed(1)
    counts = np.zeros(24)
    n = 4000
    for _ in range(n):
        idx, ptr = tk.random_sample_fix_neighbor_vectorised(ind_ptr, sel, 3)
        np.testing.assert_array_equal(ptr, [0, 3, 6, 9, 9, 12])
        rows = [idx[ptr[i]:ptr[i + 1]] for i in range(5)]
        for r, (lo, hi) in zip(rows, ((0, 10), (10, 14), (14, 24), (24, 24),
                                      (0, 10))):
            assert len(set(r.tolist())) == r.size
            assert ((r >= lo) & (r < hi)).all()
        counts[rows[0]] += 1
        counts[rows[2]] += 1
    np.testing.assert_allclose(counts[:10] / n, 0.3, atol=0.03)
    np.testing.assert_allclose(counts[14:] / n, 0.3, atol=0.03)
    # fewer edges than the fanout: all of them, in order; -1 keeps all
    idx, ptr = tk.random_sample_fix_neighbor_vectorised(ind_ptr, sel, 5)
    np.testing.assert_array_equal(idx[ptr[1]:ptr[2]], [10, 11, 12, 13])
    idx, ptr = tk.random_sample_fix_neighbor_vectorised(ind_ptr, sel, -1)
    np.testing.assert_array_equal(
        idx, np.concatenate([np.arange(24), np.arange(10)]))


def test_vectorised_planner_keeps_the_plan_contract(graphs):
    """Below the largest degree the draws differ from the loop's, the
    contract does not: at most K live slots per row, each naming a real
    edge of the graph with its support and rating level."""
    _, tg = graphs
    csr = tg["user", "movie"]
    sampler = BlockSampler(tg, num_layers=1, fanout=3, node_pad=16)
    tk.set_seed(2)
    tu = np.arange(30, dtype=np.int32)
    blocks = sampler.sample(tu, np.arange(22, dtype=np.int32))
    blk = blocks.blocks[0]["user"]
    src_ids = blocks.frontiers[0]["item"]
    support = csr.get_support(True)
    assert blk.nbr_pos.shape == (32, 3)
    assert ((blk.weight != 0).sum(axis=1) <= 3).all()
    deg = np.diff(csr.ind_ptr)
    np.testing.assert_array_equal((blk.weight != 0).sum(axis=1)[:30],
                                  np.minimum(deg, 3))
    for i in range(30):
        cols = csr.end_points[csr.ind_ptr[i]:csr.ind_ptr[i + 1]]
        for k in np.flatnonzero(blk.weight[i]):
            item = src_ids[blk.nbr_pos[i, k]]
            (e,) = np.flatnonzero(cols == item) + csr.ind_ptr[i]
            assert blk.weight[i, k] == support[e]
            assert csr.multi_link[blk.rating[i, k]] == csr.values[e]
