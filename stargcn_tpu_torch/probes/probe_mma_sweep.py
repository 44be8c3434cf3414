"""Design sweep of ``ops/csrc/probe_mma.cu`` on the card.

    python -m stargcn_tpu_torch.probes.probe_mma_sweep

Builds the kernel as it is and with one design constant changed at a
time, holds each build against ``plain_grouped_matmul`` (``torch.equal``
on integers in [-2, 2]) at the probe's shape, and prints each one's time
per call, 50 calls back to back by CUDA events, in bf16 and in int8,
beside a plain read of A (an int64 sum over its bytes).  Needs a card and
``nvcc``; the builds go to ``stargcn_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import subprocess

import numpy as np
import torch

from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.probes import probe_int8_mma as pm

# name -> {text in probe_mma.cu: its replacement}.
VARIANTS = {
    "as built": {},
    "no L2 promotion": {
        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B":
            "CU_TENSOR_MAP_L2_PROMOTION_NONE"},
    "no L2 eviction hints": {
        "kEvictFirst = 0x12F0000000000000ull":
            "kEvictFirst = 0x1000000000000000ull",
        "kEvictLast = 0x14F0000000000000ull":
            "kEvictLast = 0x1000000000000000ull"},
    "stages of one 128-byte k-step, 8 in flight": {
        "kSub = 2;": "kSub = 1;", "kAStages = 3;": "kAStages = 8;"},
    "stages of one 128-byte k-step, 8 in flight, no L2 promotion": {
        "kSub = 2;": "kSub = 1;", "kAStages = 3;": "kAStages = 8;",
        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B":
            "CU_TENSOR_MAP_L2_PROMOTION_NONE"},
    "one thread an output in the partial sum": {
        "kSumSplit = 4;": "kSumSplit = 1;"},
}


def _geometry(source):
    """(k-steps a stage, A stages) as ``source`` sets them."""
    def const(name):
        return int(source.split(f"constexpr int {name} = ")[1].split(";")[0])
    return const("kSub"), const("kAStages")


def build_variant(changes):
    """Build ``probe_mma.cu`` with ``changes``; returns ``(C function,
    (k-steps a stage, A stages))``."""
    source = (_build._CSRC / "probe_mma.cu").read_text()
    for old, new in changes.items():
        if old not in source:
            raise ValueError(f"probe_mma.cu has no {old!r}")
        source = source.replace(old, new)
    digest = hashlib.sha1(source.encode()).hexdigest()[:12]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"probe_mma-sweep-{digest}.cu"
    lib = _build.BUILD_DIR / f"libprobe_mma-sweep-{digest}.so"
    if not lib.exists():
        src.write_text(source)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), _build.SIGNATURES["probe_mma"][0])
    fn.argtypes = _build.SIGNATURES["probe_mma"][1]
    fn.restype = ctypes.c_int
    return fn, _geometry(source)


def variant_plan(plan, sub, stages):
    """``plan`` for a build with ``sub`` k-steps a stage and ``stages`` A
    stages."""
    step = 128 * sub
    esize = 1 if plan.int8 else 2
    smem = (1024 + stages * pm.TILE_M * step + pm.B_SLABS * pm.TILE_N * step
            + 8 * 2 * (stages + pm.B_SLABS))
    return dataclasses.replace(plan, smem_bytes=smem,
                               ksteps=-(-(plan.k * esize) // step))


def run(log=print, reps=50):
    """Time every variant at the probe's shape; returns ``{(variant, type
    name): ms}`` and ``{type name: ms of the plain read of A}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA card")
    builds = {name: build_variant(ch) for name, ch in VARIANTS.items()}
    rng = np.random.RandomState(6)
    times, reads = {}, {}
    for dtype in (torch.bfloat16, torch.int8):
        tname = str(dtype).split(".")[-1]
        a = torch.from_numpy(rng.randint(-2, 3, (pm.G * pm.M, pm.K))).to(
            "cuda", dtype)
        b = torch.from_numpy(rng.randint(-2, 3, (pm.K, pm.N))).to("cuda",
                                                                  dtype)
        want = pm.plain_grouped_matmul(a, b, pm.G)
        words = a.view(torch.int64)
        words.sum()
        reads[tname] = pm._mean_ms(words.sum, reps, a.device)
        log(f"{tname}: plain read of A {reads[tname]:.4f} ms")
        out, ws = pm.buffers(a, b, pm.G)
        base = pm._plan_for(a, b, pm.G)
        for name, (fn, (sub, stages)) in builds.items():
            plan = variant_plan(base, sub, stages)

            def call():
                pm.launch(fn, a, b, plan, out, ws)
                return out

            if not torch.equal(call(), want):
                raise AssertionError(f"variant {name!r} ({tname}) "
                                     f"disagrees with the plain version")
            times[name, tname] = pm._mean_ms(call, reps, a.device)
            log(f"{tname}: {name}: {times[name, tname]:.4f} ms")
        del a, b, out, ws, words
    return times, reads


if __name__ == "__main__":
    run(log=lambda s: print(s, flush=True))
