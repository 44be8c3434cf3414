"""The slot ordering and the segment sum of ``ops/csrc/ell_spmm_t.cu``, the
port's ``ell_spmm_transpose``, mirrored step by step in numpy.

The card runs the ordering as a counting sort: each live slot takes a rank
in its source's run by an atomic add (in whatever order the card runs
them), the counts are scanned into ``seg_ptr`` tile by tile, each slot is
placed at ``seg_ptr[s] + rank``, and each run is put in ascending slot
order: a thread a slot for runs of at most ``short_run`` slots (its place
is the count of the run's slot ids below its own), a bitmap over the slot
ids, window by window, for longer runs.  The sum then walks the sorted
slots in chunks of 32; a run that crosses a chunk boundary leaves a partial
row per chunk, added in chunk order, in groups of 32 partials.

These tests hold that mirror against ``sort_slots`` (bit for bit, whatever
the order of the atomics) and its sum against the JAX package's
``ell_spmm_transpose`` in interpret mode at ``rtol = atol = 1e-5`` (float32
sums of at most 32 O(1) terms a run here, in another order).  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``; on the CPU every wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stargcn_tpu.ops import pallas_kernels as pk
from stargcn_tpu_torch.ops import ell_kernels as ek

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCKS = dict(block_d=16, block_f=128, block_s=32)
CHUNK = ek.CHUNK            # sorted slots a chunk warp sums
SCAN_TILE = ek.SCAN_TILE    # counts a block scans
WINDOW = 1 << 17            # slot ids a bitmap window covers


def T(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def make_block(seed, num_dst, num_src, K, pad=0.3, out_of_range=0.05,
               dominant=0.0, feat=8):
    """An ELL block: padded slots (weight 0, any index, as the planner pads
    them with row 0 or as a caller might with junk), a few live slots out of
    range, and a share ``dominant`` of slots on source 0."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, num_src, (num_dst, K))
    w = rng.randn(num_dst, K).astype(np.float32)
    w[w == 0] = 1.0
    dead = rng.rand(num_dst, K) < pad
    w[dead] = 0.0
    idx[dead] = np.where(rng.rand(int(dead.sum())) < 0.5, 0,
                         rng.randint(-3 * num_src, 4 * num_src,
                                     int(dead.sum())))
    idx[rng.rand(num_dst, K) < out_of_range] = num_src + 1
    idx[rng.rand(num_dst, K) < dominant] = 0
    g = rng.randn(num_dst, feat).astype(np.float32)
    return idx.astype(np.int32), w, g


def mirror_order(idx, w, num_src, short_run, seed=0, window=WINDOW):
    """The card's ordering, step by step: ``(seg_ptr, dst_sorted[:total],
    w_sorted[:total], run_of)``; ``run_of[pos]`` is the source of sorted
    slot ``pos``."""
    rng = np.random.RandomState(seed)
    K = idx.shape[1]
    flat_i = idx.reshape(-1).astype(np.int64)
    flat_w = w.reshape(-1)
    n = flat_i.size
    live = ((flat_w.view(np.int32) & 0x7FFFFFFF) != 0) \
        & (flat_i >= 0) & (flat_i < num_src)
    # 1. ranks by atomic adds, in an order the card does not fix
    cnt = np.zeros(num_src, np.int64)
    rank = np.full(n, -1)
    for p in rng.permutation(n):
        if live[p]:
            rank[p] = cnt[flat_i[p]]
            cnt[flat_i[p]] += 1
    # 2. the scan: tile sums, their exclusive scan, each tile's own scan
    n_tiles = -(-num_src // SCAN_TILE)
    tile_sum = np.array([cnt[t * SCAN_TILE:(t + 1) * SCAN_TILE].sum()
                         for t in range(n_tiles)], np.int64)
    tile_off = np.concatenate([[0], np.cumsum(tile_sum)[:-1]])
    seg_ptr = np.zeros(num_src + 1, np.int64)
    for t in range(n_tiles):
        part = cnt[t * SCAN_TILE:(t + 1) * SCAN_TILE]
        seg_ptr[t * SCAN_TILE:t * SCAN_TILE + part.size] = \
            tile_off[t] + np.concatenate([[0], np.cumsum(part)[:-1]])
    total = int(cnt.sum())
    seg_ptr[num_src] = total
    long_runs = [s for s in rng.permutation(num_src) if cnt[s] > short_run]
    # 3. placement: (slot id, source) at seg_ptr[s] + rank
    ids = np.full(total, -1, np.int64)
    run_of = np.full(total, -1, np.int64)
    for p in np.nonzero(live)[0]:
        ids[seg_ptr[flat_i[p]] + rank[p]] = p
        run_of[seg_ptr[flat_i[p]] + rank[p]] = flat_i[p]
    assert (ids >= 0).all()
    # 4a. runs of at most short_run slots: a thread a slot counts the ids
    # below its own
    dst = np.full(total, -1, np.int64)
    wout = np.zeros(total, np.float32)
    for pos in range(total):
        b, e = seg_ptr[run_of[pos]], seg_ptr[run_of[pos] + 1]
        if e - b > short_run:
            continue
        r = int((ids[b:e] < ids[pos]).sum())
        dst[b + r] = ids[pos] // K
        wout[b + r] = flat_w[ids[pos]]
    # 4b. longer runs: a bitmap over the slot ids, window by window
    for s in long_runs:
        b, e = seg_ptr[s], seg_ptr[s + 1]
        at = b
        for lo in range(0, n, window):
            bits = np.zeros(window, bool)
            run = ids[b:e]
            bits[run[(run >= lo) & (run < lo + window)] - lo] = True
            for p in np.nonzero(bits)[0] + lo:
                dst[at] = p // K
                wout[at] = flat_w[p]
                at += 1
        assert at == e
    assert (dst >= 0).all()
    return seg_ptr, dst, wout, run_of


def mirror_sum(g, seg_ptr, dst, w, run_of, num_src, combine=32):
    """The card's sum over the sorted slots: chunks of ``CHUNK``, a partial
    row per chunk for a run that crosses a chunk boundary, the partials
    added in chunk order in groups of ``combine``.  float32 throughout."""
    f = g.shape[1]
    out = np.zeros((num_src, f), np.float32)
    total = int(seg_ptr[-1])
    partial = {}
    for c in range(-(-total // CHUNK)):
        pos0 = c * CHUNK
        nv = min(CHUNK, total - pos0)
        r_first, r_last = run_of[pos0], run_of[pos0 + nv - 1]
        head = seg_ptr[r_first] < pos0
        tail = seg_ptr[r_last + 1] > pos0 + CHUNK

        def flush(row, acc, last):
            if row == r_first and head:
                partial[c, 0] = acc
            elif last and tail:
                partial[c, 1] = acc
            else:
                out[row] = acc

        acc = np.zeros(f, np.float32)
        cur = r_first
        for j in range(nv):
            r = run_of[pos0 + j]
            if r != cur:
                flush(cur, acc, False)
                acc = np.zeros(f, np.float32)
                cur = r
            acc = (acc + np.float32(w[pos0 + j]) * g[dst[pos0 + j]]
                   ).astype(np.float32)
        flush(cur, acc, True)
    for s in range(num_src):
        b, e = seg_ptr[s], seg_ptr[s + 1]
        if e == b or b // CHUNK == (e - 1) // CHUNK:
            continue
        c_start, c_end = b // CHUNK, (e - 1) // CHUNK
        acc = np.zeros(f, np.float32)
        for g0 in range(c_start, c_end + 1, combine):
            grp = partial[g0, 1 if g0 == c_start else 0].copy()
            for c in range(g0 + 1, min(c_end, g0 + combine - 1) + 1):
                grp = (grp + partial[c, 0]).astype(np.float32)
            acc = (acc + grp).astype(np.float32)
        out[s] = acc
    return out


def assert_order_equal(got, idx, w, num_src):
    seg_ptr, dst, wout = got[:3]
    want = [t.numpy() for t in ek.sort_slots(*T(idx, w), num_src)]
    total = int(want[0][-1])
    np.testing.assert_array_equal(seg_ptr, want[0])
    np.testing.assert_array_equal(dst, want[1][:total])
    np.testing.assert_array_equal(wout.view(np.int32),
                                  want[2][:total].view(np.int32))


def jax_transpose(g, idx, w, num_src):
    return np.asarray(pk.ell_spmm_transpose(
        jnp.asarray(g), jnp.asarray(idx), jnp.asarray(w), num_src,
        interpret=True, **BLOCKS))


# (num_dst, num_src, K): K from 1 to 32, one source row, more sources
# than slots, a dominant source whose run crosses chunk boundaries.
SHAPES = [(40, 30, 1), (30, 50, 2), (25, 20, 3), (20, 40, 8), (12, 25, 16),
          (6, 30, 32), (9, 1, 8), (10, 300, 4), (64, 12, 8)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("short_run", [1, 3, 256])
def test_mirror_ordering_equals_sort_slots(shape, short_run):
    num_dst, num_src, K = shape
    idx, w, _ = make_block(hash(shape) % 2**16, num_dst, num_src, K,
                           dominant=0.2)
    for seed in range(3):   # three orders of the atomics, one result
        assert_order_equal(mirror_order(idx, w, num_src, short_run, seed),
                           idx, w, num_src)


@pytest.mark.parametrize("window", [32, 64, 1000])
def test_long_runs_over_several_bitmap_windows(window):
    """A run longer than ``short_run`` whose slot ids span windows."""
    idx, w, _ = make_block(5, 50, 7, 8, pad=0.2, dominant=0.5)
    got = mirror_order(idx, w, 7, short_run=2, window=window)
    assert_order_equal(got, idx, w, 7)


@pytest.mark.parametrize("n", [15, 16, 17])
def test_runs_at_the_switch_and_either_side(n):
    """A run of exactly ``short_run`` slots is ordered a thread a slot,
    one more goes to the bitmap; both give sort_slots' order."""
    rng = np.random.RandomState(n)
    idx = rng.randint(1, 30, (20, 4)).astype(np.int32)
    idx.reshape(-1)[rng.choice(80, n, replace=False)] = 0
    w = rng.randn(20, 4).astype(np.float32) + 5.0
    assert_order_equal(mirror_order(idx, w, 30, short_run=16), idx, w, 30)


def test_every_slot_dead_and_empty_blocks():
    idx = np.array([[0, 1, -1], [5, 9, 2]], np.int32)
    w = np.array([[0.0, -0.0, 1.0], [2.0, 0.0, 0.0]], np.float32)
    got = mirror_order(idx, w, 5, short_run=256)
    assert got[0].tolist() == [0] * 6
    assert_order_equal(got, idx, w, 5)
    empty = np.zeros((0, 4), np.int32), np.zeros((0, 4), np.float32)
    got = mirror_order(*empty, 6, short_run=256)
    assert got[0].tolist() == [0] * 7
    out = mirror_sum(np.zeros((0, 3), np.float32), *got, 6)
    assert out.shape == (6, 3) and not out.any()


def test_padded_slots_naming_row_0_are_not_counted():
    """The planner pads with index 0 and weight 0: source 0 must not get
    a run of padded slots."""
    idx = np.zeros((50, 8), np.int32)
    w = np.zeros((50, 8), np.float32)
    idx[:, 0] = np.arange(50) % 7 + 1
    w[:, 0] = 1.0
    seg_ptr = mirror_order(idx, w, 8, short_run=256)[0]
    assert seg_ptr[1] == 0 and seg_ptr[-1] == 50


@settings(max_examples=40, deadline=None, database=None)
@given(num_dst=st.integers(0, 40), num_src=st.integers(1, 60),
       K=st.integers(1, 32), pad=st.floats(0.0, 1.0),
       dominant=st.sampled_from([0.0, 0.3, 0.9]),
       short_run=st.sampled_from([1, 2, 5, 256]),
       seed=st.integers(0, 2**16))
def test_mirror_ordering_over_shapes(num_dst, num_src, K, pad, dominant,
                                     short_run, seed):
    idx, w, _ = make_block(seed, num_dst, num_src, K, pad=pad,
                           dominant=dominant)
    assert_order_equal(mirror_order(idx, w, num_src, short_run, seed),
                       idx, w, num_src)


@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_sum_matches_pallas_interpret(shape):
    num_dst, num_src, K = shape
    idx, w, g = make_block(7 + K, num_dst, num_src, K, dominant=0.2,
                           feat=33)
    order = mirror_order(idx, w, num_src, short_run=4)
    got = mirror_sum(g, *order, num_src)
    np.testing.assert_allclose(got, jax_transpose(g, idx, w, num_src), **TOL)
    np.testing.assert_allclose(
        got, ek.ell_spmm_transpose(*T(g, idx, w), num_src).numpy(), **TOL)


@pytest.mark.parametrize("combine", [1, 2, 3, 32])
def test_runs_across_many_chunks_combine_in_groups(combine):
    """A run of a few hundred slots crosses many chunks; its partial rows
    are added in groups of ``combine`` (32 on the card)."""
    rng = np.random.RandomState(combine)
    idx = np.where(rng.rand(60, 8) < 0.7, 2, rng.randint(0, 9, (60, 8)))
    idx = idx.astype(np.int32)
    w = (rng.rand(60, 8).astype(np.float32) - 0.5)
    g = rng.randn(60, 16).astype(np.float32)
    order = mirror_order(idx, w, 9, short_run=256)
    assert order[0][3] - order[0][2] > 5 * CHUNK
    got = mirror_sum(g, *order, 9, combine=combine)
    np.testing.assert_allclose(got, jax_transpose(g, idx, w, 9), **TOL)


def test_sum_is_the_same_whatever_the_atomics_order():
    idx, w, g = make_block(3, 30, 20, 8, dominant=0.4, feat=12)
    outs = [mirror_sum(g, *mirror_order(idx, w, 20, 4, seed), 20)
            for seed in range(3)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out.view(np.int32),
                                      outs[0].view(np.int32))


@pytest.mark.parametrize("n_slots,num_src,f", [
    (87296 * 8, 174080, 250), (17408 * 8, 872960, 250), (87296 * 8, 174080, 0),
    (1, 1, 1), (100, 3, 7)])
def test_scratch_layout(n_slots, num_src, f):
    """``_order_layout`` mirrors the C ``make_layout``: seg_ptr, dst_sorted
    and w_sorted first and apart, every part on a 256-byte boundary."""
    total, dst, w = ek._order_layout(n_slots, num_src, f, ek.SHORT_RUN)
    assert dst % 64 == 0 and w % 64 == 0
    assert num_src + 1 <= dst and dst + n_slots <= w
    chunks = -(-n_slots // CHUNK)
    # counts, chunk counters, 2 counters; ranks; tile sums; the long-run
    # list; 16-byte entries; two partial rows a chunk
    parts = [num_src + chunks + 2, n_slots, -(-num_src // SCAN_TILE),
             n_slots // (ek.SHORT_RUN + 1) + 1, 4 * n_slots]
    exact = w + n_slots + sum(parts) + 2 * chunks * f
    assert exact <= total <= exact + 64 * (len(parts) + 4)


def test_order_slots_on_the_cpu_is_sort_slots():
    idx, w, _ = make_block(11, 20, 15, 8)
    before = dict(ek.LAUNCHES)
    got = ek.order_slots(*T(idx, w), 15)
    want = ek.sort_slots(*T(idx, w), 15)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ek.LAUNCHES == before


@pytest.mark.parametrize("call", ["order_slots", "ell_spmm_transpose"])
def test_order_slots_and_the_transpose_refuse_what_the_kernels_do_not_take(
        call):
    """Off the CPU the wrappers check before they launch: tensors that do
    not lie on one CUDA device raise (``meta`` tensors stand in for a card
    here), as do mixed devices; nothing falls back to the plain version."""
    cpu_idx, cpu_w, cpu_g = T(*make_block(1, 6, 5, 2))
    idx, w, g = (t.to("meta") for t in (cpu_idx, cpu_w, cpu_g))
    args = {"order_slots": [(idx, w, 5), (cpu_idx, w, 5)],
            "ell_spmm_transpose": [(g, idx, w, 5), (g, cpu_idx, w, 5),
                                   (cpu_g, idx, w, 5)]}[call]
    for a in args:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(ek, call)(*a)
    with pytest.raises((ValueError, TypeError)):
        ek._check(call, {}, *T(*make_block(1, 6, 5, 2)[:2]), True)
    assert sum(ek.LAUNCHES.values()) == 0
