"""The port's host extension (``stargcn_tpu_torch/graph/csrc/
graph_kernels.cpp``, built by ``graph/native.py``) against the JAX
package's own (``stargcn_tpu/native/graph_kernels.cpp``, built here into a
temporary directory with its build script's flags), and the wrappers of
``graph/kernels.py`` against their NumPy versions.

The deterministic functions agree bit for bit, floats included (the two
sources do the same float32 arithmetic).  The random ones draw from
another stream (the port's draws are keyed by seed, call and row), so they
are held to their contract and to uniform marginals: each edge of a row of
degree 10 picked 3/10 of the time at fanout 3 over 4000 draws, within 0.03
(a binomial sigma of 0.0072)."""

import os
import threading

import numpy as np
import pytest

import chip_smoke
from _torch_slice import build_jax_native
from stargcn_tpu_torch.graph import kernels as tk
from stargcn_tpu_torch.graph import native
from stargcn_tpu_torch.ops import bitdense as tbd
from stargcn_tpu_torch.train.__main__ import PREFETCH_OMP_ENV, prefetch_env


@pytest.fixture(scope="module")
def jext(tmp_path_factory):
    return build_jax_native(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(scope="module")
def text():
    return tk.native_module()


def _graph(seed=0, rows=300, cols=200, max_deg=30):
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, max_deg, rows)
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ep = np.concatenate([np.sort(rng.choice(cols, d, replace=False))
                         for d in deg]).astype(np.int32)
    return rng, ptr, ep


def _inputs():
    rng, ptr, ep = _graph()
    nnz = int(ptr[-1])
    levels = np.array([1, 2, 3, 4, 5], np.float32)
    d8, _, s_pad = tbd.pad_dims(300, 200)
    dst = rng.randint(0, 300, 2000).astype(np.int32)
    src = rng.randint(0, 200, 2000).astype(np.int32)
    rat = rng.randint(0, 5, 2000).astype(np.int32)
    return dict(
        rng=rng, ptr=ptr, ep=ep, nnz=nnz,
        vals=rng.randint(-50, 50, 500).astype(np.int32),
        fvals=rng.randn(500).astype(np.float32),
        idx=rng.randint(0, 500, 700).astype(np.int32),
        data=(rng.randn(nnz) * 10.0 ** rng.uniform(-3, 3, nnz)).astype(
            np.float32),
        per_row=rng.randn(300).astype(np.float32),
        rdeg=rng.randint(0, 40, 300).astype(np.int32),
        cdeg=rng.randint(0, 40, 200).astype(np.int32),
        rows=rng.permutation(300)[:120].astype(np.int32),
        cols=rng.permutation(200)[:90].astype(np.int32),
        values=levels[rng.randint(0, 5, nnz)],
        levels=levels,
        rm=rng.choice(nnz, 400, replace=False).astype(np.int64),
        dst=dst, src=src, rat=rat,
        mask=(rng.rand(2000) > 0.3).astype(np.float32),
        d8=d8, s_pad=s_pad)


DETERMINISTIC = {
    "unique_inverse": lambda m, x: m.unique_inverse(x["vals"]),
    "unique_cnt": lambda m, x: m.unique_cnt(x["vals"]),
    "take_1d int32": lambda m, x: m.take_1d(x["vals"], x["idx"]),
    "take_1d float32": lambda m, x: m.take_1d(x["fvals"], x["idx"]),
    "gen_row_indices_by_indptr":
        lambda m, x: m.gen_row_indices_by_indptr(x["ptr"], x["nnz"]),
    "seg_sum": lambda m, x: m.seg_sum(x["data"], x["ptr"]),
    "seg_add": lambda m, x: m.seg_add(x["data"], x["per_row"], x["ptr"]),
    "seg_mul": lambda m, x: m.seg_mul(x["data"], x["per_row"], x["ptr"]),
    "get_support symm": lambda m, x: m.get_support(
        x["rdeg"], x["cdeg"], x["ptr"], x["ep"], 1),
    "get_support": lambda m, x: m.get_support(
        x["rdeg"], x["cdeg"], x["ptr"], x["ep"], 0),
    "csr_submat": lambda m, x: m.csr_submat(
        x["ptr"], x["ep"], x["rows"], x["cols"], 200),
    "multi_link_split":
        lambda m, x: m.multi_link_split(x["values"], x["ptr"], x["levels"]),
    "remove_edges_by_indices":
        lambda m, x: m.remove_edges_by_indices(x["ptr"], x["rm"]),
    "build_chunked_ell": lambda m, x: m.build_chunked_ell(
        x["src"], x["dst"], x["rat"], None, 200, 300, 8, 8),
    "build_chunked_ell masked": lambda m, x: m.build_chunked_ell(
        x["src"], x["dst"], x["rat"], x["mask"], 200, 300, 64, 16),
    "pack_bits": lambda m, x: m.pack_bits(
        x["dst"], x["src"], x["rat"], None, 5, x["d8"], x["s_pad"], 0, 0),
    "pack_bits row_interleave=128 masked": lambda m, x: m.pack_bits(
        x["dst"], x["src"], x["rat"], x["mask"], 5, x["d8"], x["s_pad"], 0,
        128),
    "pack_bits interleave=256 row_interleave=128": lambda m, x: m.pack_bits(
        x["dst"], x["src"], x["rat"], None, 5, x["d8"], x["s_pad"], 256,
        128),
    # The random functions leave nothing to chance at a fanout of at
    # least every degree.
    "random_sample_fix_neighbor all": lambda m, x:
        m.random_sample_fix_neighbor(x["ptr"], x["rows"], -1),
    "random_sample_fix_neighbor full fanout": lambda m, x:
        m.random_sample_fix_neighbor(x["ptr"], x["rows"], 30),
    "random_sel_neighbor_and_merge all": lambda m, x:
        m.random_sel_neighbor_and_merge(
            x["ep"], x["ptr"], np.arange(300, dtype=np.int32) * 7 % 301,
            x["rows"], -1),
    "sample_block_ell full fanout": lambda m, x: m.sample_block_ell(
        x["ptr"], x["ep"], (np.arange(200) * 3 + 5).astype(np.int32),
        (x["ep"] % 5).astype(np.int32),
        np.linspace(0.1, 1, 300).astype(np.float32),
        np.linspace(1, 0.2, 200).astype(np.float32), x["rows"],
        np.array([11, 5, 602], np.int32), np.array([3, 7], np.int64),
        605, 30, 128, 1, 200),
}


def _assert_same(got, want, what):
    if isinstance(got, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8), err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_functions_equal_the_jax_extension(jext, text, name):
    fn = DETERMINISTIC[name]
    _assert_same(fn(text, _inputs()), fn(jext, _inputs()), name)


def test_method_table(jext, text):
    """The same 21 functions (``set_omp_threads`` among them)."""
    names = {n for n in dir(jext) if not n.startswith("_")}
    assert len(names) == 21
    assert names == {n for n in dir(text) if not n.startswith("_")}
    assert text.set_omp_threads(0) == jext.set_omp_threads(0) >= 1


# ------------------------------ the random ones ------------------------------


def _uniform_rows(draw, n=4000):
    """``draw()`` returns the picks (edge positions) of rows 0, 1 and 2 of
    ``ind_ptr = [0, 10, 14, 24, 24]`` at fanout 3: distinct edges of the
    row, and each edge of rows 0 and 2 picked 3/10 of the time."""
    counts = np.zeros(24)
    for _ in range(n):
        for picks, (lo, hi) in zip(draw(), ((0, 10), (10, 14), (14, 24))):
            assert picks.size == 3 and np.unique(picks).size == 3
            assert ((picks >= lo) & (picks < hi)).all()
            counts[picks] += 1
    np.testing.assert_allclose(counts[:10] / n, 0.3, atol=0.03)
    np.testing.assert_allclose(counts[14:] / n, 0.3, atol=0.03)


PTR = np.array([0, 10, 14, 24, 24], np.int32)
SEL = np.array([0, 1, 2, 3, 0], np.int32)


def test_fix_neighbor_draws_are_uniform_without_replacement(text):
    text.set_seed(1)

    def draw():
        idx, ptr = text.random_sample_fix_neighbor(PTR, SEL, 3)
        np.testing.assert_array_equal(ptr, [0, 3, 6, 9, 9, 12])
        assert idx.dtype == np.int64
        return idx[0:3], idx[3:6], idx[6:9]

    _uniform_rows(draw)


def test_sample_and_merge_draws_are_uniform(text):
    text.set_seed(2)
    ep = np.arange(24, dtype=np.int32)
    ids = np.arange(24, dtype=np.int32) + 100

    def draw():
        dst_ep, dst_ptr, merged, sel_pos = text.random_sel_neighbor_and_merge(
            ep, PTR, ids, SEL, 3)
        np.testing.assert_array_equal(dst_ptr, [0, 3, 6, 9, 9, 12])
        assert np.unique(merged).size == merged.size
        assert (merged[sel_pos] == ids[SEL]).all()
        got = merged[dst_ep] - 100
        return got[0:3], got[3:6], got[6:9]

    _uniform_rows(draw)


@pytest.mark.parametrize("deg,fanout", [(10, 3), (100, 40)])
def test_sample_block_ell_draws_are_uniform(text, deg, fanout):
    """One row of degree ``deg``: distinct picks, each slot's weight and
    rating its edge's, and uniform marginals; (100, 40) takes the hash-map
    branch of Floyd's sampling."""
    ptr = np.array([0, deg], np.int32)
    ep = np.arange(deg, dtype=np.int32)
    col_ids = (100 + np.arange(deg)).astype(np.int32)
    rating = (np.arange(deg) % 5).astype(np.int32)
    inv_col = np.linspace(0.1, 1.0, deg).astype(np.float32)
    text.set_seed(7)
    counts = np.zeros(deg)
    n = 4000
    for _ in range(n):
        pos, w, r, merged = text.sample_block_ell(
            ptr, ep, col_ids, rating, np.array([0.5], np.float32), inv_col,
            np.zeros(1, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int64), 200, fanout, 1, 1, 10 ** 6)
        assert np.unique(pos).size == fanout
        locs = merged[pos] - 100
        counts[locs] += 1
        np.testing.assert_array_equal(w, 0.5 * inv_col[locs])
        np.testing.assert_array_equal(r, rating[locs])
    np.testing.assert_allclose(counts / n, fanout / deg, atol=0.03)


CHAIN_EP = np.array([1, 0, 2, 1, 3, 2, 4, 3], np.int32)
CHAIN_PTR = np.array([0, 1, 3, 5, 7, 8], np.int32)


def test_walks_keep_their_contract(text):
    text.set_seed(5)
    for start in (2, 0, -1):
        src, dst = text.random_walk(CHAIN_EP, CHAIN_PTR, start, 200, 0.2, 5,
                                    100)
        assert src.size == dst.size > 0
        for s, d in zip(src, dst):
            assert d in CHAIN_EP[CHAIN_PTR[s]:CHAIN_PTR[s + 1]]
        assert len(set(zip(src.tolist(), dst.tolist()))) == src.size
    src, dst = text.random_walk(CHAIN_EP, CHAIN_PTR, 0, 500, 0.0, 3, 1000)
    assert len(set(src.tolist()) | set(dst.tolist())) <= 3
    nodes = text.get_random_walk_nodes(CHAIN_EP, CHAIN_PTR, 2, 3, 100)
    assert nodes[0] == 2 and np.unique(nodes).size == nodes.size <= 3


@pytest.mark.parametrize("replace", [False, True])
def test_negatives_are_uniform_non_neighbors(text, replace):
    """Node 0 of 23 links to 1 and 2: its negatives are the other 21,
    each drawn about as often (within 25% of uniform over 4000 draws), and
    each target's positives come first with label 1."""
    n = 23
    ep = np.array([1, 2], np.int32)
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = 2
    text.set_seed(1234)
    counts = np.zeros(n)
    for _ in range(4000):
        e, p, label, cnt = text.uniform_neg_sampling(
            ep, ptr, np.array([0, 5], np.int32), n, 1.0, int(replace))
        np.testing.assert_array_equal(p, [0, e.size, e.size])
        np.testing.assert_array_equal(e[:2], [1, 2])
        np.testing.assert_array_equal(label[:2], [1, 1])
        negs = e[label == -1]
        assert np.unique(negs).size == negs.size
        assert not np.isin(negs, [1, 2]).any()
        assert cnt[label == -1].sum() == 2
        counts[negs] += cnt[label == -1]
    got = counts[np.concatenate([[0], np.arange(3, n)])]
    assert np.all(np.abs(got - got.mean()) < 0.25 * got.mean()), got


def test_rows_out_of_range_raise(text):
    """The random kernels index the CSR with their row arguments: one
    outside it raises instead of reading past the arrays."""
    bad = np.array([0, 4], np.int32)
    ids = np.arange(5, dtype=np.int32)
    for call in (
            lambda: text.random_sample_fix_neighbor(CHAIN_PTR, bad + 1, 2),
            lambda: text.random_sel_neighbor_and_merge(CHAIN_EP, CHAIN_PTR,
                                                      ids, bad + 1, 2),
            lambda: text.uniform_neg_sampling(CHAIN_EP, CHAIN_PTR, bad - 1,
                                              5, 1.0, 0),
            lambda: text.random_walk(CHAIN_EP, CHAIN_PTR, 5, 10, 0.1, 5, 9),
            lambda: text.get_random_walk_nodes(CHAIN_EP, CHAIN_PTR, -1, 3,
                                               10),
            lambda: text.sample_block_ell(
                CHAIN_PTR, CHAIN_EP, ids, np.zeros(8, np.int32),
                np.ones(5, np.float32), np.ones(5, np.float32), bad + 1,
                np.zeros(0, np.int32), np.zeros(0, np.int64), 5, 2, 4, 1,
                5)):
        with pytest.raises(IndexError, match="out of range"):
            call()


def test_draws_follow_the_seed_and_the_call_count(text):
    """A draw is a function of the seed and of how many random calls came
    before it: the same after ``set_seed``, another one call later."""
    _, ptr, ep = _graph(1)
    sel = np.arange(300, dtype=np.int32)

    def two():
        return [text.random_sample_fix_neighbor(ptr, sel, 4)[0]
                for _ in range(2)]

    text.set_seed(3)
    a = two()
    text.set_seed(3)
    b = two()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])
    text.set_seed(4)
    assert not np.array_equal(two()[0], a[0])


def test_draws_do_not_depend_on_the_team_or_the_thread(text):
    """3000 rows: more than the 2048 below which a loop runs on the calling
    thread alone."""
    _, ptr, ep = _graph(2, rows=3000, cols=500, max_deg=60)
    sel = np.arange(3000, dtype=np.int32)
    got = {}

    def draw(key, n):
        text.set_omp_threads(n)
        text.set_seed(11)
        got[key] = text.random_sample_fix_neighbor(ptr, sel, 5)[0]

    team = text.set_omp_threads(0)
    try:
        for n in (1, 2, 8):
            draw(("main", n), n)
            t = threading.Thread(target=draw, args=(("thread", n), n))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        text.set_omp_threads(team)
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, got[("main", 1)], err_msg=key)


# ------------------------- the wrappers' two routes -------------------------


def _wrapper_cases():
    x = _inputs()
    return {
        "unique_inverse": ((x["vals"],), {}),
        "unique_cnt": ((x["vals"],), {}),
        "take_1d": ((x["fvals"], x["idx"]), {}),
        "row_indices_from_indptr": ((x["ptr"], x["nnz"]), {}),
        "seg_sum": ((x["data"], x["ptr"]), {}),
        "seg_add": ((x["data"], x["per_row"], x["ptr"]), {}),
        "seg_mul": ((x["data"], x["per_row"], x["ptr"]), {}),
        "csr_submat": ((x["ptr"], x["ep"], x["rows"], x["cols"], 200), {}),
        "multi_link_split": ((x["values"], x["ptr"], x["levels"]), {}),
        "remove_edges_by_indices": ((x["ptr"], x["ep"], x["rm"]), {}),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
def test_native_route_equals_the_plain_version(name):
    args, kw = _wrapper_cases()[name]
    _assert_same(getattr(tk, name)(*args, **kw),
                 getattr(tk, "plain_" + name)(*args, **kw), name)


def test_indices_outside_the_arrays_take_the_plain_route():
    """The C++ checks no index; the wrappers give such input to numpy,
    which wraps negative indices and raises on too large ones."""
    data = np.arange(10, dtype=np.int32)
    np.testing.assert_array_equal(tk.take_1d(data, [-1, 2]), [9, 2])
    with pytest.raises(IndexError):
        tk.take_1d(data, [10])
    ptr = np.array([0, 2, 5], np.int32)
    with pytest.raises(IndexError):
        tk.remove_edges_by_indices(ptr, None, [5])
    _assert_same(tk.remove_edges_by_indices(ptr, None, [-1]),
                 tk.plain_remove_edges_by_indices(ptr, None, [-1]), "rm")
    ep = np.array([0, 1, 1, 2, 3], np.int32)
    with pytest.raises(IndexError):
        tk.csr_submat(ptr, ep, np.array([2], np.int32),
                      np.arange(4, dtype=np.int32), 4)
    with pytest.raises(ValueError, match="nnz"):
        tk.row_indices_from_indptr(ptr, 4)
    with pytest.raises(ValueError):
        tk.seg_sum(np.ones(4, np.float32), ptr)


@pytest.mark.parametrize("ril,masked", [(0, False), (0, True), (128, False),
                                        (128, True)])
def test_pack_bits_equals_its_numpy_version(ril, masked):
    x = _inputs()
    mask = x["mask"] if masked else None
    got, d8 = tbd.pack_bits(x["dst"], x["src"], x["rat"], 5, 300, 200,
                            mask=mask, row_interleave=ril)
    want, wd8 = tbd.plain_pack_bits(x["dst"], x["src"], x["rat"], 5, 300,
                                    200, mask=mask, row_interleave=ril)
    assert d8 == wd8 and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        tbd.pack_bits(x["dst"], x["src"], x["rat"] + 1, 5, 300, 200,
                      mask=mask, row_interleave=ril)


# ------------------------------- the build -------------------------------


def test_the_library_is_named_by_source_flags_and_host():
    path = native.target()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith(native.MODULE_NAME + "-")
    assert native.build() == path and path.exists()
    assert tk.has_native() and tk.native_module() is native.load()


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch):
    """A compiler that does not exist: the build raises with its name, and
    so does every route that needs the extension."""
    monkeypatch.setattr(native, "CXX", "no-such-cxx-for-graph-kernels")
    with pytest.raises(RuntimeError, match="no-such-cxx-for-graph-kernels"):
        native.build()
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(tk, "_native", None)
    for call in (tk.native_module, lambda: tk.unique_inverse([1, 2]),
                 lambda: tk.set_omp_threads(1),
                 lambda: tbd.pack_bits([0], [0], [0], 1, 8, 8)):
        with pytest.raises(RuntimeError, match="no-such-cxx"):
            call()
    assert not tk.has_native()


def test_a_failing_compile_reports_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "graph_kernels.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="graph_kernels.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_concurrent_first_builds_build_once(monkeypatch, tmp_path):
    """Processes that build at once take turns on the lock: the second
    finds the first one's library.  (Two threads stand in for them: the
    lock is a file lock of the open file.)"""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # raised again below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert len(list((tmp_path / "build").glob("*.so"))) == 1


# ------------------------- the CLI and chip_smoke -------------------------


def test_prefetch_environment():
    env = prefetch_env(["--prefetch", "--num_neighbors", "8"], {"A": "1"})
    assert env == {**PREFETCH_OMP_ENV, "A": "1"}
    assert prefetch_env(["--num_neighbors", "8"], {}) is None
    mine = {"OMP_WAIT_POLICY": "ACTIVE", "GOMP_SPINCOUNT": "9"}
    assert prefetch_env(["--prefetch"], mine) is None
    assert prefetch_env(["--prefetch"], {"GOMP_SPINCOUNT": "9"}) == {
        "OMP_WAIT_POLICY": "PASSIVE", "GOMP_SPINCOUNT": "9"}


def test_the_cli_starts_itself_again_with_the_prefetch_environment():
    """``python -m stargcn_tpu_torch.train --prefetch`` (the module run as
    ``__main__``, ``os.execve`` recorded instead of called) starts itself
    again with the variables set, since ``torch`` has loaded OpenMP."""
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in PREFETCH_OMP_ENV}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import os, runpy, sys\n"
        "def execve(path, args, env):\n"
        "    print(args[1:], env['OMP_WAIT_POLICY'], env['GOMP_SPINCOUNT'])\n"
        "    sys.exit(0)\n"
        "os.execve = execve\n"
        "sys.argv = ['train', '--prefetch', '--max_iter', '3']\n"
        "runpy.run_module('stargcn_tpu_torch.train', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == (
        "['-m', 'stargcn_tpu_torch.train', '--prefetch', '--max_iter', '3'] "
        "PASSIVE 0")


def _step(loss, grads):
    import torch

    return ({"loss": torch.tensor(loss, dtype=torch.float64)},
            {k: torch.tensor(v, dtype=torch.float64)
             for k, v in grads.items()})


def test_held_to_repeats():
    """``chip_smoke.held_to_repeats`` (phase 13 (a)): the step against the
    nearest of the repeats, within twice their spread plus eps."""
    reps = [_step(1.0, {"a": [1.0, 2.0], "b": [4.0]}),
            _step(1.0, {"a": [1.0, 2.0001], "b": [4.0]}),
            _step(1.0, {"a": [1.0, 2.0003], "b": [4.0]})]
    spread_a = 0.0003 / 2.0
    ok, fit, tol, spread, i = chip_smoke.held_to_repeats(
        reps, _step(1.0, {"a": [1.0, 2.00035], "b": [4.0]}))
    assert ok and i == 2
    np.testing.assert_allclose(spread[1], spread_a, rtol=1e-3)
    np.testing.assert_allclose(tol[1], 2 * spread_a + 1e-6, rtol=1e-3)
    assert fit[1] < 0.0001
    # beyond twice the spread of every repeat
    ok, fit, *_ = chip_smoke.held_to_repeats(
        reps, _step(1.0, {"a": [1.0, 2.0003 + 0.0007], "b": [4.0]}))
    assert not ok
    ok, *_ = chip_smoke.held_to_repeats(
        reps, _step(1.01, {"a": [1.0, 2.0001], "b": [4.0]}))
    assert not ok
    # equal repeats: only eps remains
    same = [_step(1.0, {"a": [1.0, 2.0]})] * 3
    ok, _, tol, spread, _ = chip_smoke.held_to_repeats(
        same, _step(1.0, {"a": [1.0, 2.0 + 1e-7]}))
    assert spread == [0.0, 0.0, 0.0] and tol[1] == 1e-6 and ok
