"""The port's two probes (``stargcn_tpu_torch/probes``) on the CPU: the
row-pair view of ``probe_bitcast`` against the JAX probe's kernel body run
in a ``pallas_call`` in interpret mode, and the plain version of
``probe_int8_mma``'s grouped product against numpy.  Both are exact: bytes
moved, and products of small integers summed in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stargcn_tpu_torch.probes import probe_bitcast as pb
from stargcn_tpu_torch.probes import probe_int8_mma as pm


def _reference_bitcast(v):
    """``scripts/probe_bitcast.py``'s kernel, ``(M/2, S)`` shape, in
    interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kernel(x_ref, o_ref):
        o_ref[...] = pltpu.bitcast(x_ref[...], jnp.uint16)

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((v.shape[0] // 2, v.shape[1]),
                                       jnp.uint16),
        interpret=True)(jnp.asarray(v))
    return np.asarray(out)


def test_row_pair_matches_the_reference_probe_kernel():
    v = pb.probe_input()
    want = _reference_bitcast(v)
    got = pb.as_numpy_u16(pb.row_pair_u16(torch.from_numpy(v)))
    assert got.shape == want.shape == (16, 256)
    np.testing.assert_array_equal(got, want)
    # lo from row 2k, hi from row 2k + 1: the pairing pack_bits'
    # row_interleave undoes.
    assert (int(got[0, 0]) & 0xFF, int(got[0, 0]) >> 8) == (0, 8)


@pytest.mark.parametrize("shape", [(2, 1), (32, 256), (6, 1000)])
def test_row_pair_plain_version(shape):
    v = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(
        np.uint8)
    got = pb.as_numpy_u16(pb.plain_row_pair_u16(torch.from_numpy(v)))
    want = v[0::2].astype(np.uint16) | (v[1::2].astype(np.uint16) << 8)
    np.testing.assert_array_equal(got, want)


def test_probe_bitcast_run_on_cpu(capsys):
    lines = []
    res = pb.run("cpu", log=lines.append)
    v = pb.probe_input()
    np.testing.assert_array_equal(res["row_pair"], _reference_bitcast(v))
    np.testing.assert_array_equal(res["column_pair"], v.view("<u2"))
    assert "  out[0,0] = lo 0 hi 8" in lines
    assert "  out[0,0] = lo 0 hi 0" in lines      # adjacent columns
    assert any(x.startswith("  lane(0,0) lo candidates [[0, 0]") for x in lines)
    pb.main(["--device", "cpu"])
    assert "plain u16 reading" in capsys.readouterr().out


def test_probes_never_fall_back_off_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        pb.row_pair_u16(torch.zeros((4, 8), dtype=torch.uint8,
                                    device="meta"))
    a = torch.zeros((128, 64), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((64, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pm.grouped_matmul(a, b, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("groups,m,k,n", [(1, 64, 64, 256),
                                          (3, 16, 96, 8),
                                          (130, 4, 32, 5)])
def test_grouped_matmul_plain_is_exact(dtype, groups, m, k, n):
    rng = np.random.RandomState(groups + m + k + n)
    a = rng.randint(-2, 3, (groups * m, k))
    b = rng.randint(-2, 3, (k, n))
    want = np.einsum("gmk,kn->mn", a.reshape(groups, m, k), b)
    got = pm.grouped_matmul(torch.from_numpy(a).to(dtype),
                            torch.from_numpy(b).to(dtype), groups)
    assert got.dtype == (torch.float32 if dtype == torch.bfloat16
                         else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_int8_mma_run_on_cpu(capsys, monkeypatch):
    # G = 512 takes minutes in float64 on the CPU; the code is the same.
    monkeypatch.setattr(pm, "G", 2)
    lines = []
    res = pm.run("cpu", reps=1, log=lines.append)
    assert res["bfloat16"]["out00"] == res["int8"]["out00"] == 2 * pm.K
    assert any("not a device time" in x for x in lines)
    monkeypatch.setattr(pm, "G", 1)
    pm.main(["--device", "cpu"])
    assert "out[0,0]=1024" in capsys.readouterr().out


def test_probe_int8_mma_bounds():
    """At the reference's shapes both types are bound by reading A:
    bf16 268 MB and int8 134 MB at 3.35 TB/s, against 68.7 GOP at 989 and
    1,979 TOP/s (69.5 and 34.7 us)."""
    for dtype, lo in ((torch.bfloat16, 0.0801), (torch.int8, 0.0401)):
        ms, by = pm.bound_ms(pm.G, pm.M, pm.K, pm.N, dtype)
        assert by == "bytes" and lo < ms < lo + 0.0005
        ops_ms = 2 * pm.G * pm.M * pm.K * pm.N / pm.PEAK_OPS_PER_S[dtype] * 1e3
        assert ops_ms < ms
