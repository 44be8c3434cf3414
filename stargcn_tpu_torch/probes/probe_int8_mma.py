"""Probe: does the int8 tensor-core path run at twice the bf16 one here?

    python -m stargcn_tpu_torch.probes.probe_int8_mma [--device cuda|cpu]

The port of ``scripts/probe_int8_mxu.py``: the same function at the same
shapes, ``out = sum_g A[g*M:(g+1)*M] @ B`` with G = 512, M = 256,
K = 1024, N = 256, once in bf16 -> f32 and once in int8 -> int32, through
``grouped_matmul`` (the CUDA kernel ``ops/csrc/probe_mma.cu`` for tensors
on the card, ``plain_grouped_matmul`` for tensors on the CPU).  Inputs are
all ones, as in the reference, so ``out[0, 0] = G * K = 524,288``.  For
each type it prints the time of the first call (the kernel's build
included where it was not built yet), ``out[0, 0]``, the median of 10
timed calls, the rate in TOP/s and the least time the card could take
(reading A once at the HBM rate, or the operations at the tensor cores'
peak, whichever is larger).  On the CPU the times are the plain version's
and say nothing about a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from stargcn_tpu_torch.utils.device import resolve_device

G, M, K, N = 512, 256, 1024, 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12}  # dense
# Launches of the kernel wrapper on the card (the plain version is not
# counted).
LAUNCHES = {"probe_mma": 0}

_TILE_M, _TILE_N, _STEP_BYTES = 64, 256, 64   # ops/csrc/probe_mma.cu


def _sum_dtype(dtype):
    return torch.float32 if dtype == torch.bfloat16 else torch.int32


def grouped_matmul(a: torch.Tensor, b: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """``out[m, n] = sum_g sum_k a[g*M + m, k] b[k, n]`` for ``a`` of shape
    ``(groups * M, K)`` and ``b`` of shape ``(K, N)``, both bfloat16 (sum
    and result float32) or both int8 (int32), on the tensor cores.

    A CUDA tensor goes to ``ops/csrc/probe_mma.cu`` (M a multiple of 64,
    N of 256, K of 64 bytes), a CPU tensor to ``plain_grouped_matmul``.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_grouped_matmul(a, b, groups)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("grouped_matmul: a and b must lie on one CUDA "
                         f"device (got {a.device} and {b.device})")
    if a.dtype != b.dtype or a.dtype not in PEAK_OPS_PER_S:
        raise TypeError("grouped_matmul takes a and b both bfloat16 or both "
                        f"int8 (got {a.dtype} and {b.dtype})")
    if a.dim() != 2 or b.dim() != 2 or groups <= 0 \
            or a.shape[0] % groups or a.shape[1] != b.shape[0]:
        raise ValueError(f"grouped_matmul: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not fit groups={groups}")
    m, k, n = a.shape[0] // groups, a.shape[1], b.shape[1]
    if m % _TILE_M or n % _TILE_N or (k * a.element_size()) % _STEP_BYTES:
        raise ValueError(f"grouped_matmul takes M % {_TILE_M} == 0, N % "
                         f"{_TILE_N} == 0 and K of a multiple of "
                         f"{_STEP_BYTES} bytes (got M={m}, K={k}, N={n})")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("grouped_matmul takes contiguous, 16-byte aligned "
                         "a and b")
    if max(a.shape[0], k, n, m * n) >= 2**31:
        raise ValueError("grouped_matmul: dimension exceeds int32")
    # Split the groups over blocks so that about two blocks run on each SM.
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    tiles = (m // _TILE_M) * (n // _TILE_N)
    want = max(1, min(groups, -(-2 * sms // tiles)))
    chunk = -(-groups // want)
    chunks = -(-groups // chunk)
    sum_dtype = _sum_dtype(a.dtype)
    part = torch.empty((chunks, m, n), dtype=sum_dtype, device=a.device)
    out = torch.empty((m, n), dtype=sum_dtype, device=a.device)
    from stargcn_tpu_torch.ops import _build

    fn = _build.load("probe_mma")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), int(a.dtype == torch.int8),
                 part.data_ptr(), out.data_ptr(), groups, m, k, n, chunk,
                 chunks, stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["probe_mma"] += 1
    return out


def plain_grouped_matmul(a: torch.Tensor, b: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """Plain PyTorch version of ``grouped_matmul`` on any device: float64
    products summed over blocks of 64 groups, returned in the kernel's sum
    type.  Exact for inputs of small integers (every partial sum is an
    integer below 2**53)."""
    m = a.shape[0] // groups
    bd = b.double()
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float64, device=a.device)
    for lo in range(0, groups, 64):
        hi = min(lo + 64, groups)
        acc += (a[lo * m:hi * m].double().view(hi - lo, m, -1) @ bd).sum(0)
    sum_dtype = _sum_dtype(a.dtype)
    if sum_dtype == torch.int32:
        acc = acc.round()
    return acc.to(sum_dtype)


def bound_ms(groups, m, k, n, dtype):
    """``(ms, 'bytes' | 'operations')``: the least time for one call on an
    H100 SXM: A, B and out moved once at the HBM rate, or
    ``2 * groups * m * k * n`` operations at the tensor cores' dense peak
    for ``dtype``."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (groups * m * k + k * n) * size + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * groups * m * k * n / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _ms(fn, dev):
    """One call's milliseconds: CUDA events on the card, the host clock on
    the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run(device="cuda", reps=10, log=print):
    """Run the probe on ``device`` for bf16 and int8 at the module's
    ``G, M, K, N``; returns ``{type name: {first_s, out00, median_ms, top_s,
    bound_ms, bound_by}}``."""
    dev = resolve_device(device)
    what = ("" if dev.type == "cuda"
            else " (the plain version on the CPU: not a device time)")
    results = {}
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).split(".")[-1]
        a = torch.ones((G * M, K), dtype=dtype, device=dev)
        b = torch.ones((K, N), dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grouped_matmul(a, b, G)
        out00 = out[0, 0].item()        # synchronises
        first_s = time.perf_counter() - t0
        log(f"{name}: compile+first {first_s:.1f}s, out[0,0]={out00}{what}")
        times = sorted(_ms(lambda: grouped_matmul(a, b, G), dev)
                       for _ in range(reps))
        med = times[len(times) // 2]
        ops = 2 * G * M * K * N
        bms, by = bound_ms(G, M, K, N, dtype)
        if dev.type == "cuda":
            log(f"{name}: median {med:.4f} ms ({ops / med / 1e9:.0f} "
                f"TOP/s); bound {bms:.4f} ms ({by}), the kernel at "
                f"{bms / med:.1%} of it")
        else:
            log(f"{name}: median {med:.2f} ms{what}")
        results[name] = dict(first_s=first_s, out00=out00, median_ms=med,
                             top_s=ops / med / 1e9, bound_ms=bms, bound_by=by)
        del a, b, out
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Probe int8 against bf16 tensor-core rates "
                    "(PyTorch/CUDA).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    run(args.device, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
