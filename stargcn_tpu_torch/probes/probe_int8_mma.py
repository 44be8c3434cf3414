"""Probe: does the int8 tensor-core path run at twice the bf16 one here?

    python -m stargcn_tpu_torch.probes.probe_int8_mma [--device cuda|cpu]

The port of ``scripts/probe_int8_mxu.py``: the same function at the same
shapes, ``out = sum_g A[g*M:(g+1)*M] @ B`` with G = 512, M = 256,
K = 1024, N = 256, once in bf16 -> f32 and once in int8 -> int32, through
``grouped_matmul`` (the CUDA kernel ``ops/csrc/probe_mma.cu``, TMA loads
feeding ``wgmma``, for tensors on the card; ``plain_grouped_matmul`` for
tensors on the CPU).  Inputs are all ones, as in the reference, so
``out[0, 0] = G * K = 524,288``.  For each type it prints the time of the
first call (the kernel's build included where it was not built yet),
``out[0, 0]``, the mean time of 10 calls run back to back (output and
workspace allocated before them), the rate in TOP/s and the least time the
card could take (reading A once at the HBM rate, or the operations at the
tensor cores' peak, whichever is larger); then the int8 : bf16 ratio of the
rates, the probe's answer.  On the CPU the times are the plain version's
and say nothing about a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.utils.device import resolve_device

G, M, K, N = 512, 256, 1024, 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12}  # dense
# Launches of the kernel wrapper on the card (the plain version is not
# counted).
LAUNCHES = {"probe_mma": 0}

# ops/csrc/probe_mma.cu: a block owns 128 x 256 outputs (two consumer
# warpgroups of 64 rows); K moves in stages of 256 bytes (two 128-byte
# swizzle rows; a shorter last stage reads zeros), through a ring of A
# stages and two B slabs.
TILE_M, HALF_M, TILE_N, STEP_BYTES = 128, 64, 256, 256
A_STAGES, B_SLABS = 3, 2
SMEM_BYTES = (1024 + A_STAGES * TILE_M * STEP_BYTES
              + B_SLABS * TILE_N * STEP_BYTES + 8 * 2 * (A_STAGES + B_SLABS))
SMEM_LIMIT = 232_448               # a block's shared memory on Hopper
SMS = 132                          # H100 SXM; the wrapper asks the card
_ALIGN = 256                       # workspace offsets


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``grouped_matmul`` launches ``probe_mma.cu`` for one shape.

    Block ``(i, j, c)`` of the ``grid`` owns output rows ``[128 i, 128 i +
    128)``, columns ``[256 j, 256 j + 256)`` and the groups
    ``chunk_groups(c)``; ``ksteps`` stages of 256 bytes cover K.  With more
    than one chunk the blocks write ``part_shape`` partials that a second
    kernel sums in an order fixed by the chunk count; the int8 route first
    writes B^T (``n * k`` bytes) into the workspace."""

    groups: int
    m: int
    k: int
    n: int
    int8: bool
    chunk: int
    chunks: int
    ksteps: int
    smem_bytes: int = SMEM_BYTES

    @property
    def grid(self):
        return (-(-self.m // TILE_M), self.n // TILE_N, self.chunks)

    @property
    def part_shape(self):
        return (self.chunks, self.m, self.n) if self.chunks > 1 else None

    @property
    def part_bytes(self):
        return 0 if self.chunks == 1 else self.chunks * self.m * self.n * 4

    @property
    def bt_offset(self):
        return -(-self.part_bytes // _ALIGN) * _ALIGN

    @property
    def workspace_bytes(self):
        return self.bt_offset + (self.n * self.k if self.int8 else 0)

    def chunk_groups(self, c):
        return range(c * self.chunk, min(self.groups, (c + 1) * self.chunk))


def launch_plan(groups, m, k, n, dtype, sms=SMS) -> LaunchPlan:
    """The ``LaunchPlan`` of ``grouped_matmul`` for ``groups`` x ``(m, k) @
    (k, n)`` in ``dtype`` on a card of ``sms`` SMs: the groups split into
    chunks so that about one block runs on each SM.  Raises on what the
    kernel does not take: a type other than bfloat16 or int8, M not a
    multiple of 64, N not of 256, K not of 64 bytes, sizes past int32."""
    if dtype not in PEAK_OPS_PER_S:
        raise TypeError(f"grouped_matmul takes bfloat16 or int8 (got "
                        f"{dtype})")
    esize = 2 if dtype == torch.bfloat16 else 1
    if min(groups, m, k, n) <= 0 or m % HALF_M or n % TILE_N \
            or (k * esize) % 64:
        raise ValueError(f"grouped_matmul takes M % {HALF_M} == 0, N % "
                         f"{TILE_N} == 0 and K of a multiple of 64 bytes, "
                         f"all positive (got G={groups}, M={m}, K={k}, "
                         f"N={n})")
    if max(groups * m, k, n, m * n) >= 2**31:
        raise ValueError("grouped_matmul: dimension exceeds int32")
    tiles = -(-m // TILE_M) * (n // TILE_N)
    want = max(1, min(groups, sms // tiles))
    chunk = -(-groups // want)
    return LaunchPlan(groups=groups, m=m, k=k, n=n,
                      int8=dtype == torch.int8, chunk=chunk,
                      chunks=-(-groups // chunk),
                      ksteps=-(-(k * esize) // STEP_BYTES))


def _sum_dtype(dtype):
    return torch.float32 if dtype == torch.bfloat16 else torch.int32


_SMS_BY_DEVICE: dict = {}
_KERNEL = None                     # the C function, held after its load


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = _build.load("probe_mma")
    return _KERNEL


def _plan_for(a, b, groups) -> LaunchPlan:
    """Check ``a`` and ``b`` for the kernel and return their plan."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("grouped_matmul: a and b must lie on one CUDA "
                         f"device (got {a.device} and {b.device})")
    if a.dtype != b.dtype:
        raise TypeError("grouped_matmul takes a and b both bfloat16 or both "
                        f"int8 (got {a.dtype} and {b.dtype})")
    if a.dim() != 2 or b.dim() != 2 or groups <= 0 \
            or a.shape[0] % groups or a.shape[1] != b.shape[0]:
        raise ValueError(f"grouped_matmul: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not fit groups={groups}")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("grouped_matmul takes contiguous, 16-byte aligned "
                         "a and b")
    index = a.device.index
    sms = _SMS_BY_DEVICE.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(
            a.device).multi_processor_count
        _SMS_BY_DEVICE[index] = sms
    return launch_plan(groups, a.shape[0] // groups, a.shape[1], b.shape[1],
                       a.dtype, sms)


def buffers(a, b, groups):
    """``(out, workspace)`` for ``grouped_matmul(a, b, groups, out=,
    workspace=)``: allocate them once before calls that repeat.  ``(None,
    None)`` for tensors on the CPU."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return None, None
    plan = _plan_for(a, b, groups)
    out = torch.empty((plan.m, plan.n), dtype=_sum_dtype(a.dtype),
                      device=a.device)
    return out, torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                            device=a.device)


def grouped_matmul(a: torch.Tensor, b: torch.Tensor, groups: int,
                   out: torch.Tensor | None = None,
                   workspace: torch.Tensor | None = None) -> torch.Tensor:
    """``out[m, n] = sum_g sum_k a[g*M + m, k] b[k, n]`` for ``a`` of shape
    ``(groups * M, K)`` and ``b`` of shape ``(K, N)``, both bfloat16 (sum
    and result float32) or both int8 (int32), every product on the tensor
    cores.

    A CUDA tensor goes to ``ops/csrc/probe_mma.cu`` (M a multiple of 64,
    N of 256, K of 64 bytes), a CPU tensor to ``plain_grouped_matmul``.
    ``out`` and ``workspace`` (from ``buffers``) are allocated here where
    not given.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        res = plain_grouped_matmul(a, b, groups)
        return res if out is None else out.copy_(res)
    plan = _plan_for(a, b, groups)
    sum_dtype = _sum_dtype(a.dtype)
    if out is None:
        out = torch.empty((plan.m, plan.n), dtype=sum_dtype, device=a.device)
    elif out.shape != (plan.m, plan.n) or out.dtype != sum_dtype \
            or out.device != a.device or not out.is_contiguous():
        raise ValueError(f"grouped_matmul: out must be a contiguous "
                         f"{(plan.m, plan.n)} {sum_dtype} tensor on "
                         f"{a.device}")
    if workspace is None:
        workspace = torch.empty(plan.workspace_bytes, dtype=torch.uint8,
                                device=a.device)
    elif workspace.dtype != torch.uint8 or workspace.device != a.device \
            or workspace.numel() < plan.workspace_bytes:
        raise ValueError(f"grouped_matmul: workspace must hold "
                         f"{plan.workspace_bytes} bytes on {a.device}")
    launch(_KERNEL or _kernel(), a, b, plan, out, workspace)
    LAUNCHES["probe_mma"] += 1
    return out


def launch(fn, a, b, plan: LaunchPlan, out, workspace):
    """Call the C function ``fn`` of a ``probe_mma`` build on checked
    tensors by ``plan``; raises where the launch fails."""
    ws = workspace.data_ptr()
    err = _build.call_on(a.device, fn, a.data_ptr(), b.data_ptr(),
                         int(plan.int8), ws + plan.bt_offset, ws,
                         out.data_ptr(), plan.groups, plan.m, plan.k, plan.n,
                         plan.chunk, plan.chunks, plan.smem_bytes,
                         _build.raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"grouped_matmul: kernel launch failed with CUDA "
                           f"error {err}")


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


def _mean_ms(fn, reps, dev):
    """Mean milliseconds of ``reps`` calls run back to back: CUDA events
    around them on the card (the host enqueues ahead of the card wherever
    a call takes the card longer than the host), the host clock on the
    CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run(device="cuda", reps=10, log=print):
    """Run the probe on ``device`` for bf16 and int8 at the module's
    ``G, M, K, N``: one first call, then ``reps`` timed ones.  Returns
    ``{type name: {first_s, out00, ms, top_s, bound_ms, bound_by}}``."""
    dev = resolve_device(device)
    what = ("" if dev.type == "cuda"
            else " (the plain version on the CPU: not a device time)")
    results = {}
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).split(".")[-1]
        a = torch.ones((G * M, K), dtype=dtype, device=dev)
        b = torch.ones((K, N), dtype=dtype, device=dev)
        out, ws = buffers(a, b, G)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grouped_matmul(a, b, G, out=out, workspace=ws)
        out00 = out[0, 0].item()        # synchronises
        first_s = time.perf_counter() - t0
        log(f"{name}: compile+first {first_s:.1f}s, out[0,0]={out00}{what}")
        ms = _mean_ms(lambda: grouped_matmul(a, b, G, out=out, workspace=ws),
                      reps, dev)
        ops = 2 * G * M * K * N
        bms, by = bound_ms(G, M, K, N, dtype)
        if dev.type == "cuda":
            log(f"{name}: {ms:.4f} ms a call, {reps} back to back "
                f"({ops / ms / 1e9:.0f} TOP/s); bound {bms:.4f} ms ({by}), "
                f"the kernel at {bms / ms:.1%} of it")
        else:
            log(f"{name}: {ms:.2f} ms a call{what}")
        results[name] = dict(first_s=first_s, out00=out00, ms=ms,
                             top_s=ops / ms / 1e9, bound_ms=bms, bound_by=by)
        del a, b, out, ws
    if dev.type == "cuda":
        ratio = results["bfloat16"]["ms"] / results["int8"]["ms"]
        log(f"int8 runs {ratio:.2f}x as fast as bf16 through wgmma on this "
            f"card (2x on paper)")
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
