"""The port's ``ell_sddmm`` kernel (``ops/csrc/ell_sddmm.cu``) mirrored
lane by lane in numpy.

A warp owns a destination row and takes its slots 32 at a time (a window):
lane s loads slot s's index; ``__match_any_sync`` finds the slots that name
one source, and only the first of each (its leader) is computed; the live
leaders are packed into lanes 0.. and taken in rounds of ``(32 / W) * G``:
the warp splits into slot groups of W lanes, each lane gathers its columns
of G leaders' rows, and one transposing butterfly sums the G partial dots
over the group; each slot lane then fetches its leader's score with one
shuffle.  Feature widths past one pass (``32 * vec * 4`` columns at W = 32)
take more passes, added in order.

These tests hold that mirror against the JAX package's ``ell_sddmm`` in
interpret mode and its golden ``ref_ell_sddmm`` at ``rtol = atol = 1e-5``
(float32 dot products of up to 600 terms, scaled so that a score is O(1),
summed in another order),
and check the index logic itself: which lane holds which slot after the
butterfly, the leaders and their ranks, the slot windows and rounds at
large K, and the passes at wide F.  The CUDA kernel itself is held against
``plain_ell_sddmm`` on the card by ``chip_smoke.py`` (phases 3 and 9); on
the CPU the wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stargcn_tpu.ops import pallas_kernels as pk
from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.ops import ell_kernels as ek
from stargcn_tpu_torch.probes import ell_sddmm_sweep as sweep

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = np.float32
LANES = np.arange(32)
UNROLL = 4               # ell_row.cuh's kUnroll: loads a lane a pass at W 32
# (width, gathers) pairs the kernel is built for, and those the design
# sweep (probes/ell_sddmm_sweep.py) builds beside them
BUILT = [(4, 4), (8, 8), (16, 8), (32, 1)]
SWEPT = BUILT + [(32, 2), (32, 4), (32, 8)]


def log2(n):
    return n.bit_length() - 1


# --------------------------- the lane-level mirror ---------------------------


def nth_set_bit(m, n):
    """``ell_sddmm.cu:nth_set_bit``: the position of the n-th set bit of the
    32-bit mask ``m`` (n from 0), by halving."""
    pos = 0
    half = 16
    while half:
        low = m & ((1 << half) - 1)
        c = bin(low).count("1")
        if n >= c:
            n -= c
            m >>= half
            pos += half
        else:
            m = low
        half >>= 1
    return pos


def transpose_sum(x, W, G):
    """``ell_sddmm.cu:transpose_sum`` over a warp: ``x`` is (32, G) float32,
    one row a lane; returns each lane's sum (32,)."""
    sub = LANES & (W - 1)
    steps = log2(G)
    for st_ in range(steps):
        half, d = G >> (st_ + 1), W >> (st_ + 1)
        upper = ((sub & d) != 0)[:, None]
        send = np.where(upper, x[:, :half], x[:, half:2 * half])
        keep = np.where(upper, x[:, half:2 * half], x[:, :half])
        x = (keep + send[LANES ^ d]).astype(F32)
    v = x[:, 0]
    d = W >> (steps + 1)
    while d:
        v = (v + v[LANES ^ d]).astype(F32)
        d >>= 1
    return v


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def lane_dot(qr, vr):
    """This lane's part of a dot: an fma chain a load, the loads added
    pairwise.  ``qr``, ``vr`` are (..., U, V)."""
    part = np.zeros(qr.shape[:-1], F32)
    for v in range(qr.shape[-1]):
        part = fma(qr[..., v], vr[..., v], part)
    if part.shape[-1] == 4:
        return ((part[..., 0] + part[..., 1])
                + (part[..., 2] + part[..., 3])).astype(F32)
    assert part.shape[-1] == 1
    return part[..., 0]


def lane_columns(c0, f, vec, width):
    """(32, U, vec) columns each lane loads in the pass at ``c0`` (-1 past
    f) and the number U of loads a lane."""
    u = UNROLL if width == 32 else 1
    sub = LANES & (width - 1)
    c = c0 + ((np.arange(u)[None, :] * width + sub[:, None]) * vec)
    cols = c[:, :, None] + np.arange(vec)
    return np.where(c[:, :, None] < f, cols, -1), u


def window_leaders(src, num_src, dedupe):
    """``(live, leaders mask, rank, lead_src)`` of a window: ``src`` (32,)
    holds slot s's index in lane s (-1 past K)."""
    live = (src >= 0) & (src < num_src)
    first = (np.array([int(np.argmax(src == s)) for s in src]) if dedupe
             else LANES)
    leaders = sum(1 << int(l) for l in LANES[live & (first == LANES)])
    rank = np.array([bin(leaders & ((1 << int(f)) - 1)).count("1")
                     for f in first])
    lead_src = src[[nth_set_bit(leaders, int(l)) for l in LANES]]
    return live, leaders, rank, lead_src


def mirror_sddmm(q, values, idx, plan, dedupe=True, trace=None):
    """The kernel's arithmetic, lane by lane.  ``trace`` (a list) collects
    ``(row, window, pass, round, slot lanes served)``."""
    vec, width, gathers = plan
    G, W = gathers, width
    R = (32 // W) * G
    shift = log2(W) - log2(G)
    grp = LANES // W
    num_dst, K = idx.shape
    f = q.shape[1]
    num_src = values.shape[0]
    out = np.zeros((num_dst, K), F32)
    for i in range(num_dst):
        for w0 in range(0, K, 32):
            slot = w0 + LANES < K
            src = np.where(slot, idx[i, np.minimum(w0 + LANES, K - 1)], -1)
            live, leaders, rank, lead_src = window_leaders(src, num_src,
                                                           dedupe)
            n_lead = bin(leaders).count("1")
            score = np.zeros(32, F32)
            for c0 in range(0, f, W * vec * (UNROLL if W == 32 else 1)):
                cols, _ = lane_columns(c0, f, vec, W)
                qr = np.where(cols >= 0, q[i][np.maximum(cols, 0)], 0)
                got = np.zeros(32, F32)
                for r0 in range(0, n_lead, R):
                    p = r0 + grp[:, None] * G + np.arange(G)   # (32, G)
                    s = lead_src[p & 31]
                    ok = ((p < n_lead)[:, :, None, None]
                          & (cols >= 0)[:, None])
                    vr = np.where(ok, values[np.where(
                        ok, s[:, :, None, None], 0), np.maximum(
                        cols, 0)[:, None]], 0).astype(F32)
                    part = lane_dot(qr[:, None].astype(F32), vr)
                    total = transpose_sum(part, W, G)
                    at = rank - r0
                    here = live & (at >= 0) & (at < R)
                    frm = np.where(here, (at // G) * W
                                   + ((at % G) << shift), LANES)
                    got = np.where(here, total[frm], got)
                    if trace is not None:
                        trace.append((i, w0, c0, r0, LANES[here]))
                score = got if c0 == 0 else (score + got).astype(F32)
            sel = LANES[slot]
            out[i, w0 + sel] = np.where(live[sel], score[sel], 0)
    return out


# ------------------------------- inputs -------------------------------------


def make_case(seed, num_dst, num_src, K, f, pad=0.3, out_of_range=0.1,
              repeat=0.2, empty=0.1):
    """An SDDMM block: padded slots naming row 0 (as the planner pads),
    indices outside [0, num_src) on either side, rows that repeat an index,
    and rows whose every slot is padding or out of range.  Features are
    N(0, 1) times F^(-1/4), so that a score is O(1) at every F: at 1e-5
    absolute, unscaled scores at F = 600 (sums of 600 O(1) terms) differ by
    more than that between two float32 summation orders."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, num_src, (num_dst, K))
    idx[rng.rand(num_dst, K) < pad] = 0
    rep = rng.rand(num_dst) < repeat
    idx[rep] = rng.randint(0, min(num_src, 3), (int(rep.sum()), K))
    bad = rng.rand(num_dst, K) < out_of_range
    idx[bad] = rng.choice([-1, 1], int(bad.sum())) * rng.randint(
        num_src, 2**31 - 1, int(bad.sum()))
    gone = rng.rand(num_dst) < empty
    idx[gone] = np.where(rng.rand(int(gone.sum()), K) < 0.5, 0, -7)
    scale = f ** -0.25
    q = (rng.randn(num_dst, f) * scale).astype(F32)
    values = (rng.randn(num_src, f) * scale).astype(F32)
    return q, values, idx.astype(np.int32)


def golden(q, values, idx):
    """``ref_ell_sddmm`` on the in-range slots, 0 on the others (the golden
    itself indexes with the raw index)."""
    ok = (idx >= 0) & (idx < values.shape[0])
    return pk.ref_ell_sddmm(q, values, np.where(ok, idx, 0)) * ok


def pallas(q, values, idx):
    return np.asarray(pk.ell_sddmm(jnp.asarray(q), jnp.asarray(values),
                                   jnp.asarray(idx), interpret=True,
                                   block_d=16, block_s=32))


# -------------------------------- tests --------------------------------------


@pytest.mark.parametrize("f, want", [
    (250, (2, 32, 1)), (64, (4, 16, 8)), (65, (1, 32, 1)), (1, (1, 4, 4)),
    (600, (4, 32, 1)), (16, (4, 4, 4)), (24, (4, 8, 8)), (128, (4, 32, 1)),
    (30, (2, 16, 8)), (33, (1, 32, 1)), (2, (2, 4, 4))])
def test_plan_picks_vec_width_and_gathers(f, want):
    assert ek.sddmm_plan(f) == want
    vec, width, _ = want
    assert f % vec == 0 and width >= min(f // vec, 32)


def test_plan_builds_only_what_the_kernel_has():
    """Every plan is one the kernel is built for: its widths are the cases
    of ``dispatch`` in ``ell_sddmm.cu``, and the gathers its own."""
    source = (_build._CSRC / "ell_sddmm.cu").read_text()
    assert "constexpr int kWideGathers = 1;" in source
    assert "constexpr int G = W == 32 ? kWideGathers : (W < 8 ? W : 8);" \
        in source
    for width, _ in BUILT:
        assert f"launch<V, {width}>(" in source
    for f in range(1, 700):
        vec, width, gathers = ek.sddmm_plan(f)
        assert (width, gathers) in BUILT and f % vec == 0


@pytest.mark.parametrize("width, gathers", SWEPT)
def test_butterfly_leaves_each_position_in_known_lanes(width, gathers):
    """After the transposing butterfly, lane l of slot group l // W holds
    the group's sum of position (l % W) >> (log2 W - log2 G): exact on small
    integers."""
    rng = np.random.RandomState(width * 10 + gathers)
    x = rng.randint(-50, 50, (32, gathers)).astype(F32)
    got = transpose_sum(x, width, gathers)
    pos = (LANES & (width - 1)) >> (log2(width) - log2(gathers))
    grp = LANES // width
    want = np.array([x[grp == grp[l], pos[l]].sum() for l in LANES])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [4, 8, 16, 32])
def test_butterfly_is_one_tree_whatever_the_gathers(width):
    """Every position is summed in the same pairing order (lane distance
    W/2 first, 1 last) as a plain xor sum of that position alone: so a
    score has the same bits whatever G or its place in the round."""
    rng = np.random.RandomState(width)
    x = rng.randn(32, 8).astype(F32) * np.float32(1e3)
    plain = {}
    for g in range(8):
        plain[g] = transpose_sum(x[:, g:g + 1].copy(), width, 1)
    for gathers in (1, 2, 4, 8):
        if gathers > width:
            continue
        shift = log2(width) - log2(gathers)
        for base in range(0, 8, gathers):
            got = transpose_sum(x[:, base:base + gathers].copy(), width,
                                gathers)
            pos = base + ((LANES & (width - 1)) >> shift)
            want = np.array([plain[p][l] for l, p in enumerate(pos)])
            assert got.tobytes() == want.tobytes()


@settings(max_examples=200, deadline=None, database=None)
@given(mask=st.integers(0, 2**32 - 1), n=st.integers(0, 31))
def test_nth_set_bit(mask, n):
    bits = [b for b in range(32) if mask >> b & 1]
    if n < len(bits):
        assert nth_set_bit(mask, n) == bits[n]
    else:
        assert 0 <= nth_set_bit(mask, n) < 32


@settings(max_examples=60, deadline=None, database=None)
@given(K=st.integers(1, 32), num_src=st.integers(1, 12),
       dedupe=st.booleans(), seed=st.integers(0, 2**16))
def test_leaders_and_ranks(K, num_src, dedupe, seed):
    """Each live slot's leader is the first slot naming its index (itself
    without the reuse), the leaders' ranks are 0.. in slot order, and lane p
    holds the p-th leader's index."""
    rng = np.random.RandomState(seed)
    src = np.full(32, -1)
    src[:K] = rng.randint(-2, num_src + 2, K)
    live, leaders, rank, lead_src = window_leaders(src, num_src, dedupe)
    lead_lanes = [l for l in range(32) if leaders >> l & 1]
    assert all(live[l] for l in lead_lanes)
    for s in range(32):
        if not live[s]:
            continue
        first = int(np.argmax(src == src[s])) if dedupe else s
        assert lead_lanes[rank[s]] == first
    for p, lane in enumerate(lead_lanes):
        assert lead_src[p] == src[lane]
    if dedupe:
        assert len(lead_lanes) == len(set(src[live].tolist()))
    else:
        assert len(lead_lanes) == int(live.sum())


@pytest.mark.parametrize("K", [1, 8, 15, 32, 33, 40, 70])
@pytest.mark.parametrize("f", [64, 250])
def test_every_live_slot_is_served_once(K, f):
    """Windows of 32 slots, rounds of (32 / W) * G leaders: each live slot
    of a window picks its score up in exactly one round of each pass, and
    a window takes ceil(leaders / R) rounds a pass."""
    q, values, idx = make_case(K * 7 + f, 6, 40, K, f, repeat=0.5)
    plan = ek.sddmm_plan(f)
    vec, width, gathers = plan
    rounds_per = (32 // width) * gathers
    trace = []
    mirror_sddmm(q, values, idx, plan, trace=trace)
    passes = -(-f // (width * vec * (UNROLL if width == 32 else 1)))
    for i in range(idx.shape[0]):
        for w0 in range(0, K, 32):
            src = np.full(32, -1)
            n = min(32, K - w0)
            src[:n] = idx[i, w0:w0 + n]
            live, leaders, _, _ = window_leaders(src, 40, True)
            mine = [t for t in trace if t[0] == i and t[1] == w0]
            n_lead = bin(leaders).count("1")
            assert len(mine) == passes * -(-n_lead // rounds_per)
            for c0 in {t[2] for t in mine}:
                served = np.concatenate(
                    [t[4] for t in mine if t[2] == c0] + [[]])
                assert sorted(served.tolist()) == LANES[live].tolist()


@pytest.mark.parametrize("f", [1, 5, 64, 65, 250, 513, 600, 1030])
def test_passes_at_wide_f_cover_every_column_once(f):
    """The lanes' columns over all passes cover [0, F) once each; at the
    narrow plans no lane of a full slot group idles on a load."""
    vec, width, _ = ek.sddmm_plan(f)
    step = width * vec * (UNROLL if width == 32 else 1)
    seen = []
    for c0 in range(0, f, step):
        cols, _ = lane_columns(c0, f, vec, width)
        group = cols[:width]
        seen.extend(group[group >= 0].tolist())
        if width < 32 and (f // vec) == width:
            assert (cols >= 0).all()
    assert sorted(seen) == list(range(f))


@pytest.mark.parametrize("K, f", [(1, 1), (3, 64), (8, 250), (15, 64),
                                  (33, 65), (40, 600), (8, 1030), (5, 30)])
def test_mirror_matches_pallas_and_golden(K, f):
    q, values, idx = make_case(K + f, 20, 50, K, f)
    got = mirror_sddmm(q, values, idx, ek.sddmm_plan(f))
    np.testing.assert_allclose(got, pallas(q, values, idx), **TOL)
    np.testing.assert_allclose(got, golden(q, values, idx), **TOL)


@pytest.mark.parametrize("f", [64, 30, 1])
def test_narrow_plan_and_a_warp_a_slot_agree(f):
    q, values, idx = make_case(f, 12, 30, 15, f)
    narrow = mirror_sddmm(q, values, idx, ek.sddmm_plan(f))
    wide = mirror_sddmm(q, values, idx, (ek.sddmm_plan(f)[0], 32, 1))
    np.testing.assert_allclose(narrow, wide, **TOL)
    np.testing.assert_allclose(narrow, golden(q, values, idx), **TOL)


@pytest.mark.parametrize("f, gathers", [(250, 2), (250, 4), (250, 8),
                                        (600, 0), (64, 0), (65, 0)])
def test_reuse_and_gathers_keep_the_bits(f, gathers):
    """Computing each distinct index once gives the bits of computing every
    slot, at every number of gathers; two slots of a row that name one
    index get bit-equal scores."""
    q, values, idx = make_case(f + gathers, 10, 6, 12, f, repeat=0.5)
    idx[3, 4] = idx[3, 9] = 2
    vec, width, kept_gathers = plan = ek.sddmm_plan(f)
    kept = mirror_sddmm(q, values, idx, plan)
    every = mirror_sddmm(q, values, idx, (vec, width, gathers or kept_gathers),
                         dedupe=False)
    assert kept.tobytes() == every.tobytes()
    assert kept[3, 4].tobytes() == kept[3, 9].tobytes()
    same = idx[:, :, None] == idx[:, None, :]
    assert (kept[:, :, None] == kept[:, None, :])[same].all()


@settings(max_examples=25, deadline=None, database=None)
@given(num_dst=st.integers(1, 10), num_src=st.integers(1, 40),
       K=st.integers(1, 40), f=st.integers(1, 600),
       seed=st.integers(0, 2**16))
def test_mirror_matches_pallas_over_shapes(num_dst, num_src, K, f, seed):
    q, values, idx = make_case(seed, num_dst, num_src, K, f)
    got = mirror_sddmm(q, values, idx, ek.sddmm_plan(f))
    np.testing.assert_allclose(got, pallas(q, values, idx), **TOL)
    np.testing.assert_allclose(got, golden(q, values, idx), **TOL)
    np.testing.assert_allclose(
        ek.ell_sddmm(*(torch.from_numpy(a) for a in (q, values, idx))),
        got, **TOL)


def test_wrapper_on_the_cpu_is_the_plain_version():
    q, values, idx = (torch.from_numpy(a)
                      for a in make_case(3, 9, 20, 8, 250))
    before = dict(ek.LAUNCHES)
    want = ek.plain_ell_sddmm(q, values, idx)
    assert torch.equal(ek.ell_sddmm(q, values, idx), want)
    assert ek.LAUNCHES == before


def test_sddmm_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper checks before it launches: tensors that do
    not lie on one CUDA device raise (``meta`` tensors stand in for a card
    here), as do mixed devices; nothing falls back to the plain version."""
    cpu = [torch.from_numpy(a) for a in make_case(1, 6, 5, 3, 8)]
    meta = [t.to("meta") for t in cpu]
    before = dict(ek.LAUNCHES)
    for args in (meta, [cpu[0], meta[1], meta[2]],
                 [meta[0], meta[1], cpu[2]]):
        with pytest.raises(ValueError, match="CUDA"):
            ek.ell_sddmm(*args)
    assert ek.LAUNCHES == before


@pytest.mark.parametrize("name", list(sweep.VARIANTS))
def test_sweep_variant_is_the_source_with_its_texts_changed(name):
    """Each design of the sweep is ``ell_sddmm.cu`` with its texts found
    once and changed (a design constant or a line of the kernel), or (a
    warp a slot) the kernel as built at another width; the mirror of each keeps the kept design's bits where it sums
    over the same lanes, and its values elsewhere."""
    changes, width = sweep.VARIANTS[name]
    source = (_build._CSRC / "ell_sddmm.cu").read_text()
    got = sweep.variant_source(changes)
    assert (got == source) == (not changes)
    for old, new in changes.items():
        assert got.count(new) == source.count(new) + 1
    q, values, idx = make_case(len(name), 6, 8, 15, 64 if width else 250,
                               repeat=0.5)
    vec, kept_width, kept_gathers = plan = ek.sddmm_plan(q.shape[1])
    assert sweep.applies(name, q.shape[1])
    gathers = int(name.split()[1]) if name.startswith("gathers") else None
    other = mirror_sddmm(
        q, values, idx,
        (vec, width or kept_width, 1 if width else gathers or kept_gathers),
        dedupe=name != "every slot computed")
    kept = mirror_sddmm(q, values, idx, plan)
    if width:
        np.testing.assert_allclose(other, kept, **TOL)
    else:
        assert other.tobytes() == kept.tobytes()


def test_sweep_times_each_design_only_where_it_changes_the_launch():
    everywhere = ["as built", "no minimum of blocks an SM",
                  "at least 5 blocks an SM", "at least 8 blocks an SM"]
    assert [n for n in sweep.VARIANTS if sweep.applies(n, 250)] == [
        *everywhere, "gathers 2", "gathers 4", "gathers 8",
        "every slot computed", "q without evict-first"]
    assert [n for n in sweep.VARIANTS if sweep.applies(n, 64)] == [
        *everywhere, "every slot computed", "q without evict-first",
        "a warp a slot"]
