"""The Hopper probes' host side on the CPU: ``probe_mma``'s launch plan (the
pure function its wrapper launches by) and the shape contract it raises on,
the plan against the constants of ``ops/csrc/probe_mma.cu``, the design
sweep's variants against that source, the PyTorch calls that
``chip_smoke.py`` times beside the kernel (held against
``plain_grouped_matmul``: exact on int32, and in bf16 exact only while every
rounded sum stays within 256), and ``plain_row_pair_u16`` against numpy at
odd shapes and an odd storage offset.  The kernels themselves run only on
the card (``chip_smoke.py`` phase 10)."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.probes import probe_bitcast as pb
from stargcn_tpu_torch.probes import probe_int8_mma as pm
from stargcn_tpu_torch.probes import probe_mma_sweep as sweep

# (G, M, K, N): the probe's shape and phase 10's cases.
SHAPES = [(512, 256, 1024, 256), (3, 64, 256, 256), (7, 128, 1024, 512),
          (67, 256, 128, 256), (5, 192, 64, 256), (2, 128, 384, 256),
          (130, 64, 256, 256), (1, 64, 64, 256)]
DTYPES = [torch.bfloat16, torch.int8]


def _source():
    return (_build._CSRC / "probe_mma.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _source())[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_launch_plan_covers_every_group_once_in_chunk_order(shape, dtype,
                                                            sms):
    groups, m, k, n = shape
    k = k // 2 if dtype == torch.bfloat16 and k == 64 else k
    plan = pm.launch_plan(groups, m, k, n, dtype, sms)
    tiles_m, tiles_n, chunks = plan.grid
    assert tiles_m == -(-m // 128) and tiles_n == n // 256
    assert chunks == plan.chunks
    # About one block an SM: never more blocks than SMs where the groups
    # are split at all.
    assert plan.chunks == 1 or tiles_m * tiles_n * plan.chunks <= sms
    order = [g for c in range(plan.chunks) for g in plan.chunk_groups(c)]
    assert order == list(range(groups))
    assert all(len(plan.chunk_groups(c)) > 0 for c in range(plan.chunks))
    esize = 2 if dtype == torch.bfloat16 else 1
    assert plan.ksteps == -(-(k * esize) // 256)
    assert plan.smem_bytes <= pm.SMEM_LIMIT == 232_448
    if plan.chunks > 1:
        assert plan.part_shape == (plan.chunks, m, n)
        assert plan.part_bytes == plan.chunks * m * n * 4
    else:
        assert plan.part_shape is None and plan.part_bytes == 0
    assert plan.bt_offset % 256 == 0 and plan.bt_offset >= plan.part_bytes
    assert plan.workspace_bytes == plan.bt_offset + (
        n * k if dtype == torch.int8 else 0)


@pytest.mark.parametrize("dtype,ksteps", [(torch.bfloat16, 8),
                                          (torch.int8, 4)],
                         ids=["bf16", "int8"])
def test_probe_shape_plan(dtype, ksteps):
    """G = 512 over 2 M-tiles on 132 SMs: 64 chunks of 8 groups, 128
    blocks, 16.8 MB of partials."""
    plan = pm.launch_plan(pm.G, pm.M, pm.K, pm.N, dtype)
    assert plan.grid == (2, 1, 64) and plan.chunk == 8
    assert plan.ksteps == ksteps
    assert plan.part_bytes == 64 * 256 * 256 * 4
    assert plan.smem_bytes == 230_480


@pytest.mark.parametrize("groups,m,k,n,dtype,error", [
    (2, 32, 64, 256, torch.bfloat16, ValueError),     # M % 64
    (2, 96, 64, 256, torch.int8, ValueError),
    (2, 64, 64, 128, torch.bfloat16, ValueError),     # N % 256
    (2, 64, 64, 384, torch.int8, ValueError),
    (2, 64, 16, 256, torch.bfloat16, ValueError),     # K of 32 bytes
    (2, 64, 96, 256, torch.int8, ValueError),         # K of 96 bytes
    (0, 64, 64, 256, torch.bfloat16, ValueError),     # no groups
    (2, 0, 64, 256, torch.int8, ValueError),
    (2**25, 64, 64, 256, torch.int8, ValueError),     # G*M past int32
    (2, 64, 64, 256, torch.float32, TypeError),
    (2, 64, 64, 256, torch.float16, TypeError),
])
def test_launch_plan_refuses_what_the_kernel_does_not_take(groups, m, k, n,
                                                           dtype, error):
    with pytest.raises(error):
        pm.launch_plan(groups, m, k, n, dtype)


def test_launch_plan_matches_the_cuda_source():
    """The plan's tile, stage and shared-memory sizes are the kernel's."""
    assert (_const("kBM"), _const("kBN")) == (pm.TILE_M, pm.TILE_N)
    assert _const("kKB") * _const("kSub") == pm.STEP_BYTES
    assert (_const("kAStages"), _const("kBSlabs")) == (pm.A_STAGES,
                                                       pm.B_SLABS)
    a_stage = 2 * _const("kSub") * 64 * _const("kKB")
    b_slab = _const("kSub") * _const("kBN") * _const("kKB")
    barriers = 2 * _const("kAStages") + 2 * _const("kBSlabs")
    assert pm.SMEM_BYTES == (1024 + _const("kAStages") * a_stage
                             + _const("kBSlabs") * b_slab + 8 * barriers)
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" \
        in _source()
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in _source()
    assert "cp.async.bulk.tensor.2d" in _source()
    assert "mma.sync" not in _source() and "nvcuda" not in _source()


def test_sweep_variants_apply_to_the_source():
    sub, stages = sweep._geometry(_source())
    assert (sub, stages) == (_const("kSub"), _const("kAStages"))
    for changes in sweep.VARIANTS.values():
        for old in changes:
            assert old in _source()
    plan = pm.launch_plan(pm.G, pm.M, pm.K, pm.N, torch.bfloat16)
    assert sweep.variant_plan(plan, sub, stages) == plan
    one_step = sweep.variant_plan(plan, 1, 8)
    assert one_step.ksteps == 16 and one_step.smem_bytes == 197_792


def _small_ints(rng, groups, m, k, n, dtype):
    a = torch.from_numpy(rng.randint(-2, 3, (groups * m, k))).to(dtype)
    b = torch.from_numpy(rng.randint(-2, 3, (k, n))).to(dtype)
    return a, b


@pytest.mark.parametrize("groups", [1, 4, 64])
def test_library_calls_are_exact_on_int8(groups):
    a, b = _small_ints(np.random.RandomState(groups), groups, 32, 64, 32,
                       torch.int8)
    want = pm.plain_grouped_matmul(a, b, groups)
    for call, _ in chip_smoke.mma_library_calls(a, b, groups).values():
        got = call()
        assert got.dtype == torch.int32
        assert torch.equal(got, want)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_library_calls_are_exact_on_bf16_within_256(groups):
    """Exact while every bf16-rounded sum stays within 256: the einsum's
    group sum (|sum_g A| <= 2 G <= 8) and its bf16 result (|out| <= 4 G K
    <= 256 at K = 16); each product block of the every-product call where
    it falls back to a bf16 matmul (|sum_k a b| <= 4 K = 64)."""
    a, b = _small_ints(np.random.RandomState(groups), groups, 16, 16, 24,
                       torch.bfloat16)
    want = pm.plain_grouped_matmul(a, b, groups)
    calls = chip_smoke.mma_library_calls(a, b, groups)
    assert set(calls) == {"library", "every product"}
    assert "einsum" in calls["library"][1]
    for call, _ in calls.values():
        assert torch.equal(call().float(), want)


def test_einsum_yardstick_rounds_its_group_sum():
    """``torch.einsum`` sums A over the groups in bf16 first: 257 ones
    round to 256, so it is not exact past 256, where every product summed
    in float32 is."""
    groups, m, k, n = 257, 1, 8, 8
    a = torch.ones((groups * m, k), dtype=torch.bfloat16)
    b = torch.ones((k, n), dtype=torch.bfloat16)
    want = pm.plain_grouped_matmul(a, b, groups)
    assert float(want[0, 0]) == groups * k
    einsum, _ = chip_smoke.mma_library_calls(a, b, groups)["library"]
    assert float(einsum()[0, 0]) == 256 * k


def test_grouped_matmul_fills_out_on_cpu():
    a, b = _small_ints(np.random.RandomState(3), 3, 64, 64, 256,
                       torch.int8)
    assert pm.buffers(a, b, 3) == (None, None)
    out = torch.full((64, 256), -7, dtype=torch.int32)
    got = pm.grouped_matmul(a, b, 3, out=out)
    assert got is out
    assert torch.equal(out, pm.plain_grouped_matmul(a, b, 3))


def test_call_on_needs_no_card_for_a_device_without_index():
    """``call_on`` calls straight through where the device names no index,
    without asking the CUDA runtime which device is current."""
    assert _build.call_on(torch.device("cuda"), lambda x, y: x + y, 2,
                          3) == 5


@pytest.mark.parametrize("shape", [(2, 1), (6, 13), (4, 12), (10, 7),
                                   (2, 9), (32, 256), (8, 1000)], ids=str)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_plain_row_pair_at_odd_shapes_and_offsets(shape, offset):
    rng = np.random.RandomState(shape[0] * shape[1] + offset)
    flat = rng.randint(0, 256, shape[0] * shape[1] + offset).astype(np.uint8)
    v = torch.from_numpy(flat)[offset:].view(shape)
    assert v.is_contiguous() and v.storage_offset() == offset
    got = pb.as_numpy_u16(pb.plain_row_pair_u16(v))
    vn = flat[offset:].reshape(shape)
    want = vn[0::2].astype(np.uint16) | (vn[1::2].astype(np.uint16) << 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pb.as_numpy_u16(pb.row_pair_u16(v)), want)


@pytest.mark.parametrize("bad", [
    torch.zeros((3, 8), dtype=torch.uint8, device="meta"),   # odd rows
    torch.zeros((4, 8), dtype=torch.int8, device="meta"),    # not uint8
    torch.zeros((4, 8, 2), dtype=torch.uint8, device="meta"),
])
def test_row_pair_check_input_refuses_off_card(bad):
    with pytest.raises(ValueError):
        pb.check_input(bad)
