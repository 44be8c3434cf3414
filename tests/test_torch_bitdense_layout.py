"""Host-side layout of the bit kernels' launch (``ops/bitdense.py``): the
bf16 table the kernels gather from, and the launch plan (column tiles,
stages per row, levels and warps per unit) computed from the shape alone.  The CUDA walk
itself runs only on the card (``chip_smoke.py`` phases 3, 5 and 5b)."""

import numpy as np
import pytest
import torch

from stargcn_tpu_torch.ops import bitdense as tbd

# (S_pad, F): small cases, the edge cases of chip_smoke.py phase 3, and the
# four ML-10M launches (F = 65: 64 embedding columns and the ones column).
SHAPES = [(16, 1), (16, 65), (1040, 8), (4096, 72), (4624, 256),
          (8208, 257), (528, 600), (11264, 65), (70656, 65)]


@pytest.mark.parametrize("f", [1, 7, 8, 65, 72, 256, 257, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_is_bf16_of_x_then_zero(f, dtype):
    rng = np.random.RandomState(f)
    x = torch.from_numpy(rng.randn(37, f).astype(np.float32)).to(dtype)
    tab = tbd.bf16_table(x)
    fp = tbd.walk_plan(37, f)["fp"]
    assert tab.dtype == torch.bfloat16 and tab.shape == (37, fp)
    assert tab.is_contiguous() and fp % 8 == 0 and f <= fp < f + 8
    # Rows of fp bf16 values are 16-byte aligned for the kernel's loads.
    assert tab.stride(0) * tab.element_size() % 16 == 0
    assert torch.equal(tab[:, :f], x.to(torch.bfloat16))
    assert not tab[:, f:].any()


def test_table_rounds_to_nearest_even():
    """The table rounds as the TPU kernels round (bf16 round to nearest,
    ties to even), so the values summed are those of the reference."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)          # bf16 spacing at 1.0
    vals = np.array([one + ulp / 2,      # tie: stays at the even 1.0
                     one + 3 * ulp / 2,  # tie: up to the even 1 + 2 ulp
                     one + ulp * 0.51, -(one + ulp * 0.49)], np.float32)
    tab = tbd.bf16_table(torch.from_numpy(vals)[:, None])
    want = [1.0, 1.0 + 2 * 2.0 ** -7, 1.0 + 2.0 ** -7, -1.0]
    assert tab[:, 0].float().tolist() == want


@pytest.mark.parametrize("view", ["perm", "pad", "skip"])
def test_strided_g_copy_equals_the_view(view):
    """The reduce's cotangent comes as a permuted view (or any rows with a
    contiguous inner dimension); the table is that view, rounded, level
    by level."""
    rng = np.random.RandomState(3)
    R, S, F = 3, 40, 65
    if view == "perm":
        g = torch.from_numpy(rng.randn(S, R, F).astype(np.float32)).permute(
            1, 0, 2)
    elif view == "pad":
        g = torch.from_numpy(rng.randn(R, S, F + 5).astype(np.float32))[
            ..., :F]
    else:
        g = torch.from_numpy(rng.randn(R, 2 * S, F).astype(np.float32))[
            :, ::2]
    assert not g.is_contiguous()
    tab = tbd.bf16_table(g)
    assert tab.shape == (R, S, 72) and tab.is_contiguous()
    assert torch.equal(tab[..., :F], g.to(torch.bfloat16))
    assert not tab[..., F:].any()


@pytest.mark.parametrize("s_pad,f", SHAPES)
def test_plan_covers_every_column_once(s_pad, f):
    plan = tbd.walk_plan(s_pad, f)
    width = plan["k"] * 128
    assert plan["k"] in (1, 2) and width <= 256
    cols = np.concatenate([np.arange(t * width, min((t + 1) * width,
                                                    plan["fp"]))
                           for t in range(plan["tiles"])])
    assert np.array_equal(cols, np.arange(plan["fp"]))
    # One register round where it suffices (the ML-10M F = 65).
    assert plan["k"] == (1 if plan["fp"] <= 128 else 2)


@pytest.mark.parametrize("s_pad,f", SHAPES)
def test_stages_cover_every_byte_of_a_row_once(s_pad, f):
    """The walk cuts a row into stages of 512 bytes, one 16-byte piece per
    lane (``bit_walk.cuh``: piece = stage * 32 + lane, live while piece <
    S_pad / 16); every byte is read exactly once, and the last stage holds
    the row's tail."""
    plan = tbd.walk_plan(s_pad, f)
    seen = np.zeros(s_pad, np.int64)
    for st in range(plan["stages"]):
        for lane in range(32):
            piece = st * 32 + lane
            if piece < s_pad // 16:
                seen[piece * 16:(piece + 1) * 16] += 1
    assert (seen == 1).all()
    assert (plan["stages"] - 1) * 512 < s_pad <= plan["stages"] * 512


@pytest.mark.parametrize("levels,stages", [(1, 1), (1, 22), (1, 138),
                                           (10, 22), (3, 9)])
@pytest.mark.parametrize("np_", [1, 8])
def test_group_warps_take_every_stage_of_a_unit_once(levels, stages, np_):
    """The ``np`` warps of a group take a unit's ``levels * stages`` stages
    in turn (warp p: p, p + np, ...), each in order; together every stage
    once, whatever the count (a warp may have none)."""
    total = levels * stages
    taken = []
    for part in range(np_):
        mine = (total - part + np_ - 1) // np_ if total > part else 0
        own = [part + z * np_ for z in range(mine)]
        assert own == sorted(own)
        taken += own
    assert sorted(taken) == list(range(total))


def test_ml10m_plans():
    """The four main-path launches at ML-10M width (F = 65: one 128-column
    round, one tile).  Expand: a warp per short user-side row, the block
    per long item-side row.  Reduce: the user gradient's whole table (10 x
    11264 x 72 bf16, 16 MB) fits L2, so a unit folds all ten levels; the
    item gradient's (102 MB) does not, so its units take one level (10 MB),
    chained in rating order."""
    base = dict(fp=72, k=1, tiles=1)
    assert tbd.walk_plan(11264, 65, 10) == dict(
        base, stages=22, levels=1, chain=False, np=1)
    assert tbd.walk_plan(70656, 65, 10) == dict(
        base, stages=138, levels=1, chain=False, np=8)
    assert tbd.walk_plan(11264, 65, 10, reduce=True) == dict(
        base, stages=22, levels=10, chain=False, np=8)
    assert tbd.walk_plan(70656, 65, 10, reduce=True) == dict(
        base, stages=138, levels=1, chain=True, np=8)


@pytest.mark.parametrize("s_pad,f", SHAPES)
@pytest.mark.parametrize("R", [1, 2, 10])
def test_plan_levels_and_groups(s_pad, f, R):
    """A reduce folds all R levels into a unit where its whole table fits
    24 MiB, else chains single levels; an expand never does either;
    chained units are the block's."""
    e = tbd.walk_plan(s_pad, f, R)
    assert e["levels"] == 1 and not e["chain"]
    r = tbd.walk_plan(s_pad, f, R, reduce=True)
    fits = R * s_pad * r["fp"] * 2 <= 24 << 20
    assert r["levels"] == (R if fits else 1)
    assert r["chain"] == (r["levels"] < R)
    for plan in (e, r):
        assert plan["np"] in (1, 8)
        assert plan["np"] == 8 or not plan["chain"]
        assert (plan["np"] == 8) == (plan["chain"] or
                                     plan["levels"] * plan["stages"] >= 64)


@pytest.mark.parametrize("R,d8", [(1, 128), (10, 8832), (10, 1408)])
def test_reduce_units_are_rating_major(R, d8):
    """Units u = r * d8 + m are handed out in increasing order; the adds
    into output row m then come in the order r = 0..R-1, and every unit's
    predecessor (u - d8) was handed out before it, so a block's wait for
    its turn always ends."""
    u = np.arange(R * d8)
    r, m = u // d8, u % d8
    assert np.array_equal(r * d8 + m, u)
    for mm in (0, d8 // 2, d8 - 1):
        assert np.array_equal(r[m == mm], np.arange(R))
    assert ((u - d8)[r > 0] < u[r > 0]).all()
