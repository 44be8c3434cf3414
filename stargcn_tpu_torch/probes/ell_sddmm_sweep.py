"""Design sweep of ``ops/csrc/ell_sddmm.cu`` on the card.

    python -m stargcn_tpu_torch.probes.ell_sddmm_sweep

Builds the kernel as it is and with one design changed at a time (the
blocks an SM that ptxas plans the registers for; leader rows a lane
gathers at once at width 32; every slot computed instead of each distinct
index of a row once; q loaded without the evict-first hint), and launches
the kernel as built with a warp a slot at narrow F.  Each
variant is held against ``plain_ell_sddmm`` (within 1e-5 of the largest
output) and, where it sums over the same lanes, against the kernel as
built bit for bit; then each is timed by the profiler's device time a call
(20 calls under one profiler), the median of three rounds that take the variants in
turn, the order reversed every other round.

The inputs are those of ``chip_smoke.py`` phase 9: both plan blocks of one
sampled step (batch 4096, fanout 8) on the ML-10M-shaped synthetic graph,
at F = 250 with random queries and values, and ``seg_take_k_corr_pallas``'s
case of phase 8 (6000 rows, K = 15, F = 64).  Needs a card and ``nvcc``;
the builds go to ``stargcn_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.ops import ell_kernels as ek
from stargcn_tpu_torch.utils.device import card_line

SEED = 123
ML10M = dict(num_users=69_878, num_items=10_677, num_edges=10_000_000)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# name -> ({text in ell_sddmm.cu: its replacement}, lanes a slot or None
# for the plan's own).
# The gathers take the registers they need (a minimum of one block an SM,
# that is none): under the kept design's minimum they would spill.
FREE = {"kMinBlocks = 6;": "kMinBlocks = 1;"}
VARIANTS = {
    "as built": ({}, None),
    "no minimum of blocks an SM": (FREE, None),
    "at least 5 blocks an SM": ({"kMinBlocks = 6;": "kMinBlocks = 5;"},
                                None),
    "at least 8 blocks an SM": ({"kMinBlocks = 6;": "kMinBlocks = 8;"},
                                None),
    "gathers 2": ({"kWideGathers = 1;": "kWideGathers = 2;", **FREE}, None),
    "gathers 4": ({"kWideGathers = 1;": "kWideGathers = 4;", **FREE}, None),
    "gathers 8": ({"kWideGathers = 1;": "kWideGathers = 8;", **FREE}, None),
    "every slot computed": ({
        "const int first = __ffs(__match_any_sync(kFull, src)) - 1;":
            "const int first = lane;"}, None),
    "q without evict-first": ({
        "load_stream<V>(qrow + c, qr[j]);":
            "load_vec<V>(qrow + c, qr[j]);"}, None),
    "a warp a slot": ({}, 32),
}


def variant_source(changes):
    """``ell_sddmm.cu`` with ``changes`` made; raises where the file no
    longer holds a text to change."""
    source = (_build._CSRC / "ell_sddmm.cu").read_text()
    for old, new in changes.items():
        if source.count(old) != 1:
            raise ValueError(f"ell_sddmm.cu holds {old!r} "
                             f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def registers(ptxas_log):
    """``{kernel instance (mangled): registers}`` from ``ptxas -v``."""
    regs, entry = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m[1]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m[1])
    return regs


def build_variants():
    """``({variant: C function}, {variant: {instance: registers}})``, the
    builds started together."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, libs, regs = {}, {}, {}
    for name, (changes, _) in VARIANTS.items():
        source = variant_source(changes)
        digest = hashlib.sha1(source.encode()).hexdigest()[:12]
        src = _build.BUILD_DIR / f"ell_sddmm-sweep-{digest}.cu"
        libs[name] = _build.BUILD_DIR / f"libell_sddmm-sweep-{digest}.so"
        if src not in [p[1] for p in procs.values()]:
            src.write_text(source)
            procs[name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                 "-o", str(libs[name]), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), src)
    for name, (proc, src) in procs.items():
        text, _ = proc.communicate()
        src.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{text}")
        regs[name] = registers(text)
    fns = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), _build.SIGNATURES["ell_sddmm"][0])
        fn.argtypes = _build.SIGNATURES["ell_sddmm"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def launcher(fn, q, values, idx, width=None):
    """A call of ``fn`` on these inputs with ``sddmm_plan``'s plan (or
    ``width`` lanes a slot); returns the output."""
    (num_src, f), (num_dst, k) = values.shape, idx.shape
    vec, plan_width, _ = ek.sddmm_plan(f)
    out = torch.empty((num_dst, k), dtype=torch.float32, device=q.device)
    stream = _build.raw_stream(q.device)

    def call():
        err = fn(q.data_ptr(), values.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), num_dst, k, num_src, f, vec,
                 width or plan_width, stream)
        if err:
            raise RuntimeError(f"ell_sddmm launch failed with CUDA error "
                               f"{err}")
        return out
    return call


def device_ms(call, calls=20):
    """The profiler's device time a call of ``call``, or None where the
    trace shows none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ms = sum(e.self_device_time_total / 1e3 / e.count
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.count)
    return ms or None


def step_blocks():
    """``({direction: (idx, num_src)}, F)``: one sampled step's first
    plan block each way, as ``chip_smoke.py`` phase 8 builds the step (the
    ML-10M-shaped synthetic graph, seed 123, 10% test, 10% valid; batch
    4096, fanout 8), ``num_src`` the projected frontier's ``R * n_src``
    rows, and the width ``F`` of its first layer."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(os.path.join(ROOT, "configs",
                                     "transductive_ml_10m.yml"))
    cfg.DATASET.NAME = "synthetic"
    g = synthetic_graph(**ML10M, rating_values=tuple(np.arange(0.5, 5.01,
                                                               0.5)),
                        seed=SEED)
    csr = g["user", "movie"]
    pairs = csr.node_pair_ids
    perm = np.random.RandomState(SEED).permutation(pairs.shape[1])
    n_test = pairs.shape[1] // 10
    it = DataIterator(g, "user", "movie",
                      test_node_pairs=pairs[:, perm[:n_test]],
                      valid_node_pairs=pairs[:, perm[n_test:2 * n_test]],
                      embed_P_mask=cfg.EMBED.MASK_PROP,
                      embed_p_zero=cfg.EMBED.P_ZERO,
                      embed_p_self=1.0 - cfg.EMBED.P_ZERO, seed=SEED)
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link))
    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    gk.set_seed(SEED)
    with tempfile.TemporaryDirectory(prefix="ell_sddmm_sweep_") as save_dir:
        trainer = SampledTrainer(model_cfg, it, settings, fanout=8,
                                 backend="pallas", device="cuda",
                                 save_dir=save_dir, save_id=1)
        rs = it.rating_sampler(batch_size=trainer.train_batch,
                               segment="train")
        recon = it.recon_nodes_sampler(
            batch_size=settings.recon_batch_size)
        batch = trainer._build_batch_safe(rs, recon)
        feed = trainer._feed(trainer._pack_batch(batch))
    R, F = model_cfg.num_links, model_cfg.agg_units[0]
    blocks = {}
    for t, src in (("user", "item"), ("item", "user")):
        blk = feed["plan"]["blocks"][0][0][t]
        blocks[t] = (blk["idx"].contiguous(), R * trainer.caps[src])
    return blocks, F


def cases():
    """``{name: (q, values, idx)}``: the step's two blocks at F = 250 and
    ``seg_take_k_corr_pallas``'s case at F = 64 (``chip_smoke.py``'s
    ``seg_take_k_corr_case``, batch entry 0)."""
    from stargcn_tpu_torch.ops.ell import ell_from_csr

    blocks, F = step_blocks()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    out = {}
    for direction, (idx, num_src) in blocks.items():
        values = torch.randn(num_src, F, device="cuda", generator=gen)
        q = torch.randn(idx.shape[0], F, device="cuda", generator=gen)
        out[f"into {direction}"] = (q, values, idx)
    rng = np.random.RandomState(SEED + 5)
    deg = rng.randint(0, 16, 6000)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    nids = rng.randint(0, 4000, int(indptr[-1])).astype(np.int32)
    e1 = rng.randn(2, 6000, 64).astype(np.float32)
    e2 = rng.randn(2, 4000, 64).astype(np.float32)
    ell = ell_from_csr(indptr)
    out["seg_take_k_corr_pallas"] = (
        torch.from_numpy(e1[0]).cuda(), torch.from_numpy(e2[0]).cuda(),
        torch.from_numpy(nids[ell.slot_edge]).cuda())
    return out


def applies(name, f):
    """Whether variant ``name`` changes the launch at width ``f``: the
    gathers only at width 32, a warp a slot only below it."""
    width = ek.sddmm_plan(f)[1]
    if name.startswith("gathers"):
        return width == 32
    if name == "a warp a slot":
        return width < 32
    return True


def run(log=print, rounds=3):
    """Check and time every variant on every case; returns ``{(case,
    variant): device ms a call or None}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA card")
    fns, regs = build_variants()
    for name, by_instance in regs.items():
        log(f"{name}: registers by instance (V, W) " + ", ".join(
            f"{m[1]}x{m[2]} {n}" for inst, n in sorted(by_instance.items())
            if (m := re.search(r"kernelILi(\d+)ELi(\d+)E", inst))))
    times = {}
    for case, (q, values, idx) in cases().items():
        f = values.shape[1]
        want = ek.plain_ell_sddmm(q, values, idx)
        tol = 1e-5 * max(float(want.abs().max()), 1.0)
        calls = {}
        for name, (_, width) in VARIANTS.items():
            if not applies(name, f):
                continue
            calls[name] = launcher(fns[name], q, values, idx, width)
            got = calls[name]().clone()
            err = float((got - want).abs().max())
            if err > tol:
                raise AssertionError(f"variant {name!r} disagrees ({case}): "
                                     f"{err:.3e} > {tol:.3e}")
            if width is None and not torch.equal(got, calls["as built"]()):
                raise AssertionError(f"variant {name!r} changes the bits "
                                     f"({case})")
        names = list(calls)
        runs = {name: [] for name in names}
        for r in range(rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                runs[name].append(device_ms(calls[name]))
        for name in names:
            got = [t for t in runs[name] if t is not None]
            times[case, name] = sorted(got)[len(got) // 2] if got else None
        log(f"{case}: idx {tuple(idx.shape)}, values {tuple(values.shape)}, "
            f"plan {ek.sddmm_plan(f)}; device ms a call: " + ", ".join(
                f"{name} " + ("not measured" if times[case, name] is None
                              else f"{times[case, name]:.5f}")
                for name in names))
    return times


if __name__ == "__main__":
    print(card_line(), flush=True)
    run(log=lambda s: print(s, flush=True))
