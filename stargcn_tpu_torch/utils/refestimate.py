"""Analytical full-step estimate of the reference implementation on a V100.

The reference (MXNet, one V100) records no throughput numbers; its only
perf tooling is a standalone kernel harness
(``seg_ops_cuda/seg_ops.cu:1408-1669``).  A kernel-only roofline cannot
stand for its training step, which also pays backward, optimizer, per-op
launch overhead, host-side graph surgery and PCIe shipping every
iteration: ``REMOVE_RATING: true`` rebuilds the training graph per batch,
so ``remove_edges_by_id`` + ``sample_neighbors`` (support +
``multi_link_split``) re-run on the host each step
(``experiments/STAR-GCN.py:583-707``, ``mxgraph/graph.py:631-748``).

This module models the reference full step per dataset.  Every term is
resolved in the REFERENCE'S favor (lower-bound step time -> upper-bound
reference rate):

``T_step = T_host/HOST_SPEEDUP + T_pcie + max(T_launch, T_device)``

- ``T_host``: measured on the machine that runs ``measure_host_ms`` with
  this package's NumPy host kernels (``graph/kernels.py``) at the
  reference shapes, then divided by ``HOST_SPEEDUP``.
- ``T_pcie``: per-iteration device feed (per-level end_points + support
  + indptr for both directions, batch pairs, ratings) over an ideal
  12 GB/s PCIe gen3 x16.
- ``T_launch``: op-count x 5 us.  5 us is the bare CUDA launch floor;
  published MXNet imperative-mode per-op overheads are 15-50 us.  The
  op count is derived from the reference forward graph
  (``aggregators.py:111-161``: per rating level FC + expand_dims x2 +
  seg_weighted_pool + reshape + ordinal weight/bias adds), backward
  (x2 fwd, NNVM FGradient fan-out), global-norm clip (2 kernels/array)
  and Adam (1 kernel/array).  MXNet's async engine overlaps launch
  with device execution, so T_launch is max()-ed against device time,
  not added — again the reference-favoring choice.
- ``T_device = T_gather + T_gemm + T_adam``:
  - gather: the seg_weighted_pool family moves one PROJECTED row of
    ``agg_units`` floats per edge message (1000 B, FC-then-pool,
    ``aggregators.py:141-151``); backward issues two more passes of
    the same magnitude (data-grad scatter via
    ``_backward_seg_take_k_corr_embed2``, weight-grad via
    ``seg_take_k_corr`` — ``seg_op.cc:656-712``): 3 passes x 1000 B
    per edge message at 80% of the V100's 900 GB/s HBM.
  - gemm: the aggregator FC projects ALL source-node rows once per
    rating level (embed -> agg_units), plus out/decoder layers;
    forward FLOPs x3 for backward, at 70% of the V100's 15.7 TFLOP/s
    fp32 (the reference trains fp32 gluon — no tensor cores).
  - adam: 40 B/param (Adam read/write + global-norm clip traffic).
- Ignored entirely (all would slow the reference further): the >=3
  blocking ``asscalar()`` syncs per iteration (STAR-GCN.py:610-646),
  dropout/activation elementwise traffic, atomic-scatter contention in
  the backward, the amortised full-graph ``evaluate()`` every
  VALID_INTERVAL=10 iterations, and Python loop overhead.

Outputs per dataset: estimated step ms (term breakdown), edge-msgs/s
upper bound, and the same under a REALISTIC mid-estimate (50% HBM
efficiency on random gathers, 15 us/op MXNet engine overhead, host
kernels at face value).

    python -m stargcn_tpu_torch.utils.refestimate   # measures, then prints
"""

from __future__ import annotations

import time

import numpy as np

# ---- V100 machine model (optimistic-for-reference constants) -------------
HBM_BYTES_PER_S = 900e9          # V100 SXM2 peak
HBM_EFF_BOUND = 0.80             # upper bound for random 1000-B row gathers
HBM_EFF_REALISTIC = 0.50         # measured-in-practice gather efficiency
FP32_FLOPS = 15.7e12             # V100 fp32 peak (no tensor cores in gluon fp32)
GEMM_EFF = 0.70
PCIE_BYTES_PER_S = 12e9          # gen3 x16 effective
LAUNCH_S_BOUND = 5e-6            # bare CUDA launch floor
LAUNCH_S_REALISTIC = 15e-6       # MXNet imperative engine per-op dispatch
HOST_SPEEDUP = 2.0               # grant the reference a 2x faster host CPU
ADAM_BYTES_PER_PARAM = 40        # p/m/v/g reads + p/m/v writes + clip traffic

# ---- reference config shapes (experiments/cfg/transductive_*.yml) --------
DATASETS = {
    "ml-100k": dict(nu=943, ni=1682, ratings=100_000, levels=5,
                    embed=32, batch=10_000),
    "ml-1m": dict(nu=6040, ni=3706, ratings=1_000_209, levels=5,
                  embed=64, batch=100_000),
    "ml-10m": dict(nu=69_878, ni=10_677, ratings=10_000_054, levels=10,
                   embed=64, batch=100_000),
}
NBLOCKS = 2
DIRECTIONS = 2          # user->movie and movie->user aggregation
LAYERS = 1              # GCN.AGG.UNITS: [250] — one aggregation hop
AGG_UNITS = 250
OUT_UNITS = 75
MID_MAP = 64            # GEN_RATING.MID_MAP
TRAIN_FRAC = 0.8        # VALID_RATIO 0.1 + TEST_RATIO 0.1

# Medians of ``measure_host_ms`` (iters=3 at ml-100k and ml-1m, 1 at
# ml-10m) read by ``chip_smoke.py --phases 16`` (c) on the host CPU of the
# machine with the H100: GenuineIntel family 6 model 143, 8 logical CPUs
# (PERF.md §6).
RECORDED_HOST_MS = {"ml-100k": 41.43, "ml-1m": 366.66, "ml-10m": 4844.78}


def op_count(levels: int) -> dict:
    """Per-step device op (kernel) count of the reference training
    iteration, from the forward graph at ``aggregators.py:111-161`` /
    ``layers.py`` / ``STAR-GCN.py:602-646``."""
    # per (block, direction): dropout + per-level {2 ordinal adds, FC,
    # 2 expand_dims, seg_weighted_pool, reshape} + add_n + activation
    per_dir = 1 + 6 * levels + 2
    # per block: out dense per node type (FC+act) x2, embedding
    # take/mask ~4, gen_rating decoder ~8 (takes, FCs, inner product,
    # denorm), recon decoders ~6, loss assembly ~13
    per_block = DIRECTIONS * per_dir + 4 + 4 + 8 + 6 + 13
    fwd = NBLOCKS * per_block
    bwd = 2 * fwd                      # NNVM FGradient fan-out (~2x fwd)
    # param arrays: per (block, dir, level) weight+bias, plus out /
    # decoder / embedding arrays (~21)
    arrays = NBLOCKS * DIRECTIONS * levels * 2 + 21
    clip_adam = 3 * arrays             # norm-reduce + scale + adam update
    return {"fwd": fwd, "bwd": bwd, "arrays": arrays,
            "total": fwd + bwd + clip_adam}


def measure_host_ms(shapes: dict, iters: int = 3, seed: int = 0) -> dict:
    """Time the reference's per-iteration host graph surgery at the given
    dataset shapes, with this package's host kernels standing in for the
    reference's.

    Per iteration (STAR-GCN.py:583-607 + layers.py full-graph path):
    ``HeterGraph.remove_edges_by_id`` (both directions), then per
    direction ``CSRMat.sample_neighbors(symm, use_multi_link=True)``
    (= get_support + fanout pass + multi_link_split) on the FRESH
    matrices (caches never hit: the graph changes every iteration).
    """
    from stargcn_tpu_torch.data.synthetic import synthetic_graph

    e_train = int(shapes["ratings"] * TRAIN_FRAC)
    rv = tuple(np.linspace(0.5, 5.0, shapes["levels"])
               if shapes["levels"] == 10 else np.arange(1.0, 6.0))
    g = synthetic_graph(num_users=shapes["nu"], num_items=shapes["ni"],
                        num_edges=e_train, rating_values=rv, seed=seed)
    csr = g["user", "movie"]
    rng = np.random.RandomState(seed)
    pairs = csr.node_pair_ids
    times = []
    for it in range(iters):
        sel = rng.randint(0, pairs.shape[1],
                          min(shapes["batch"], pairs.shape[1]))
        batch_pairs = pairs[:, sel]
        t0 = time.perf_counter()
        g2 = g.remove_edges_by_id("user", "movie", batch_pairs)
        for key in (("user", "movie"), ("movie", "user")):
            g2[key].sample_neighbors(symm=True, use_multi_link=True)
        times.append(time.perf_counter() - t0)
    return {"host_ms_measured": round(sorted(times)[len(times) // 2] * 1e3,
                                      2)}


def estimate(shapes: dict, host_ms_measured: float) -> dict:
    """Full-step estimate (bound + realistic) for one dataset."""
    levels = shapes["levels"]
    embed = shapes["embed"]
    nu, ni = shapes["nu"], shapes["ni"]
    n_nodes = nu + ni
    e_active = int(shapes["ratings"] * TRAIN_FRAC) - shapes["batch"]
    msgs = NBLOCKS * LAYERS * DIRECTIONS * e_active

    # PCIe: per direction per-level end_points(i32) + support(f32) over
    # E edges + indptrs; plus batch pairs/ratings.
    pcie_bytes = (DIRECTIONS * (e_active * 8 + levels * (n_nodes + 1) * 4)
                  + shapes["batch"] * 12)
    t_pcie = pcie_bytes / PCIE_BYTES_PER_S

    # gather tier: 3 passes x agg_units floats per edge message
    gather_bytes = 3 * msgs * AGG_UNITS * 4

    # gemm tier (fwd FLOPs; x3 for backward):
    #   aggregator FC: per block/dir/level projects ALL source rows
    agg_flops = NBLOCKS * levels * 2 * n_nodes * embed * AGG_UNITS
    #   out layer: agg -> out per node type per block
    out_flops = NBLOCKS * 2 * n_nodes * AGG_UNITS * OUT_UNITS
    #   gen_rating: batch rows through out->mid for both endpoints
    dec_flops = NBLOCKS * 2 * shapes["batch"] * 2 * OUT_UNITS * MID_MAP
    #   recon decoders: out -> embed per node type
    rec_flops = NBLOCKS * 2 * n_nodes * OUT_UNITS * embed
    fwd_flops = agg_flops + out_flops + dec_flops + rec_flops
    t_gemm = 3 * fwd_flops / (FP32_FLOPS * GEMM_EFF)

    # optimizer tier
    params = (NBLOCKS * DIRECTIONS * levels * (embed * AGG_UNITS + AGG_UNITS)
              + NBLOCKS * 2 * (AGG_UNITS * OUT_UNITS + OUT_UNITS * embed)
              + NBLOCKS * 2 * OUT_UNITS * MID_MAP
              + n_nodes * embed)
    t_adam = params * ADAM_BYTES_PER_PARAM / (HBM_BYTES_PER_S * HBM_EFF_BOUND)

    ops = op_count(levels)

    def step_s(hbm_eff, launch_s, host_div):
        t_gather = gather_bytes / (HBM_BYTES_PER_S * hbm_eff)
        t_device = t_gather + t_gemm + t_adam
        t_launch = ops["total"] * launch_s
        return (host_ms_measured * 1e-3 / host_div + t_pcie
                + max(t_launch, t_device))

    s_bound = step_s(HBM_EFF_BOUND, LAUNCH_S_BOUND, HOST_SPEEDUP)
    s_real = step_s(HBM_EFF_REALISTIC, LAUNCH_S_REALISTIC, 1.0)
    return {
        "edge_msgs_per_step": msgs,
        "host_ms_measured": round(host_ms_measured, 2),
        "host_ms_credited": round(host_ms_measured / HOST_SPEEDUP, 2),
        "pcie_ms": round(t_pcie * 1e3, 2),
        "launch_ms_bound": round(ops["total"] * LAUNCH_S_BOUND * 1e3, 2),
        "device_ms_bound": round(
            (gather_bytes / (HBM_BYTES_PER_S * HBM_EFF_BOUND)
             + t_gemm + t_adam) * 1e3, 2),
        "gather_ms_bound": round(
            gather_bytes / (HBM_BYTES_PER_S * HBM_EFF_BOUND) * 1e3, 2),
        "gemm_ms": round(t_gemm * 1e3, 2),
        "adam_ms": round(t_adam * 1e3, 3),
        "op_count": ops["total"],
        "step_ms_bound": round(s_bound * 1e3, 2),
        "step_ms_realistic": round(s_real * 1e3, 2),
        "rate_bound": round(msgs / s_bound, 1),
        "rate_realistic": round(msgs / s_real, 1),
    }


def estimate_all(measure: bool = True, datasets=None) -> dict:
    """Estimate every dataset (or those named); ``measure=False`` reuses
    the recorded host medians (``RECORDED_HOST_MS``) to keep fast paths
    fast."""
    out = {}
    for name in (datasets or DATASETS):
        shapes = DATASETS[name]
        host = (measure_host_ms(shapes)["host_ms_measured"] if measure
                else RECORDED_HOST_MS[name])
        out[name] = estimate(shapes, host)
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(estimate_all(measure=True), indent=2))
