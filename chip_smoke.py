#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stargcn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 11,12   # phases 1, 2 and these alone
    python3 chip_smoke.py --phases 4       # the bit packs and pack_bits
    python3 chip_smoke.py --phases 8       # the sampled slice (and phase 9)
    python3 chip_smoke.py --phases 13      # phase 13 on its own ML-10M set-up
    python3 chip_smoke.py --phases 14      # phase 14 on its own ML-10M set-up
    python3 chip_smoke.py --phases 15      # phase 15 on its own ML-10M set-up
    python3 chip_smoke.py --phases 16      # phase 16 on its own ML-10M set-up
    python3 chip_smoke.py --phases 17      # phase 17 on its own ML-10M set-up
    python3 chip_smoke.py --phases 18      # phase 18 on its own ML-10M set-up

Phases, in order; any failure exits non-zero and prints no result:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the port, from ``ops/csrc/``, in parallel,
   and beside them the host extension ``graph/csrc/graph_kernels.cpp``
   with ``g++`` (``graph/native.py``), then loaded: a failed build fails
   the run;
3. kernel check, small cases: ``bit_expand_matmul`` and
   ``bit_reduce_matmul`` on the card against their plain PyTorch versions
   fed the same bf16-rounded input (dense and sparse packs, f32 and bf16
   input, long rows that are split over warps, permuted-view cotangents);
   the same for ``bit_expand_matmul16`` and ``bit_reduce_matmul16`` on
   ``row_interleave=128`` packs (F = 1 to 600), each also equal bit for bit
   to its natural kernel on the natural pack; then the four on the edge
   cases of the walk (full stage lists, non-zeros only in a row's tail,
   S_pad = 16 and off the stage, rows of one warp and of a block, F = 1 to
   600, strided cotangents), each also repeated bit for bit;
4. set-up: ``configs/transductive_ml_10m.yml`` on a synthetic graph of the
   real ML-10M size, one ``DataIterator`` and one ``Trainer`` on the card
   (parameters from seed 123), the train and test bit packs (``pack_bits``
   of the host extension), and ``pack_bits`` timed beside its numpy
   version ``plain_pack_bits`` on the train edges, a layout at a time,
   natural and ``row_interleave=128``, the two equal byte for byte and the
   natural one equal to the trainer's packs;
5. kernel check, full size: both kernels on the ML-10M packs (a few row
   blocks compared with the plain versions; two launches on the same
   input give the same bits), their time per launch at the
   main path's shapes beside their bounds, their share of the bound and
   their time on an all-zero pack of the same shape (the stream's own
   cost), and the adjoint identity
   ``<expand(x), g> = <x, reduce(g)>`` that ties the two kernels and the
   two pack layouts together;
6. training slice: one ``train_iteration`` (launch counts), the same step
   through a plain twin (loss and every gradient compared), ``fit`` for 20
   steps with two validations and checkpoints (and the path's peak memory),
   ``restore_checkpoint``, then ``export_serving(trainer)`` and queries on
   the trained parameters;
5b. run after phase 6, so that phase 6's peak memory holds no tensor of
   another path: a second ``Trainer`` with ``KERNEL.BIT_IMPL: pallas16``
   and its row-interleaved packs, then phase 5 for the 16-bit pair on those
   packs, which must equal the natural packs with their rows permuted, and
   whose kernels must give the natural kernels' bits on the natural packs;
6b. the ``pallas16`` trainer on the same parameters: one
   ``train_iteration`` (4 ``bit_expand_matmul16`` + 4
   ``bit_reduce_matmul16``, no natural bit kernel), the same batch against
   the ``pallas`` trainer (loss and every gradient), ``fit`` for 10 steps
   with one validation, its checkpoint loaded into the ``pallas`` trainer,
   its export (4 ``bit_expand_matmul16``) equal to the ``pallas`` export,
   queries, and ``python -m stargcn_tpu_torch.train``'s entry point on a
   YAML that sets ``KERNEL.BIT_IMPL: pallas16`` (10 steps, 16-bit kernels
   only);
7. serving slice: the export of random parameters from seed 123 through
   the kernel (launch counts), checked against the same export through
   the plain version, then ``predict`` and ``recommend`` on the card;
8. sampled slice: ``SampledTrainer`` (batch 4096, recon 1024, fanout 8,
   ``backend="pallas"``) on the same graph at full width, planning on the
   trainer's default route (``'native'``, the host extension's fused
   planner): the probed caps, one plan by each planner route (native,
   vectorised, loop) side by side; the native plan's contract at fanout 8
   (``native_plan_properties``: every live slot an edge of its row, none
   twice, at most 8, rows of degree at most 8 whole, excluded batch edges
   weighing 0 and the rest the support of the removal-adjusted degrees)
   and the same plan from the same seed at 1, 2 and 16 OpenMP threads; on
   a 3000 x 3000 subgraph at a fanout of its largest degree, the native
   plan equal to the loop planner's, batch edges removed and not; one
   ``train_iteration`` (launch counts:
   4 ``ell_spmm_fwd_only``, 4 ``ell_spmm_transpose``, no ``ell_sddmm``, no
   bit kernel), then, each with launch counts of its own, ``ell_spmm``
   with a weight gradient on one of the step's blocks and
   ``seg_take_k_corr_pallas`` (the two callers of ``ell_sddmm``); the same
   step through a twin on the plain versions (loss and every gradient
   compared); the step's time split into plan, pack, copy and device and
   the memory one step takes above what is held before it, beside the
   ``xla`` backend's, and, in the ``pallas`` step's profiler trace, the
   transpose's ``ell_t_*`` kernels and no sort, scan or search kernel of a
   library; ``fit`` for 10 steps with
   one validation and one test evaluation (the first 16 batches of 4096
   pairs of each segment), checkpoints,
   ``restore_checkpoint``, and the ``.pt`` loaded into the full-graph
   ``Trainer``;
9. ELL kernel check, full size: the transpose's ordering (``order_slots``)
   equal to ``sort_slots`` on one real plan block per direction, with the
   run lengths printed; each of the three kernels on those blocks against
   its plain version, two launches giving the same bits, the adjoint
   identity ``<spmm(v), g> = <v, spmm_t(g)>``, the three results of
   ``ell_spmm`` forward + backward with a weight gradient against plain
   autograd, and times per launch beside the bound and the library call
   (``F.embedding_bag`` and its backward); the transpose's device time
   split by kernel name into the ordering and the sum, and the ordering
   alone at several switches between its two ways of ordering a run;
   ``ell_sddmm``'s share of its bound, its device time by the profiler
   and the row gathers it makes on those blocks, and the kernel at
   ``seg_take_k_corr_pallas``'s shapes (F = 64, K = 15);
10. probes: ``probe_bitcast`` and ``probe_int8_mma`` through their entry
   points (``run``), each with launch counts of its own, then each kernel
   against its plain version with ``torch.equal`` and two launches giving
   the same bits, on edge cases (row pairs: odd S, S % 8 != 0, an odd
   storage offset; grouped products: M = 64, a short last chunk, K of one
   64-byte step, N = 512, an int8 B^T with K != N), then times: kernel and
   library calls alike back to back by ``cuda_ms`` with operands and
   outputs allocated first (bf16 beside ``torch.einsum``, which sums A over
   the groups before its one product, and beside a call that does every
   product), the profiler's device time, the int8 : bf16 ratio, and
   ``row_pair_u16``'s host cost part by part;
11. full-graph ``dense`` and ``xla`` at ML-1M width:
   ``configs/transductive_ml_1m.yml`` as published on a synthetic graph
   of the real ML-1M size (6,040 x 3,706, 1,000,209 edges, seed 123, 10%
   test and 10% valid; ``build_ml1m``, beside ``build_ml10m``), where
   ``KERNEL.BACKEND: auto`` resolves to ``dense``: each variant's bf16
   adjacency built on the card (time, bytes, the float32 scatter's peak;
   the valid variant shares the train variant's); one ``train_iteration``
   (no bit or ELL kernel launched: none lies on this path); the same batch
   on the same parameters and dropout masks through the bf16 adjacency, a
   float32 twin, the ``xla`` backend and ``xla`` in 65,536-edge chunks
   (``KERNEL.XLA_MSG_BUDGET_MB`` 100), loss and every gradient compared;
   ``scaled_dense_aggregate`` on the card against the float32 product of
   the same bf16-rounded operands in both directions, forward and
   gradient, and one ``torch.bmm`` (bf16 in, float32 out) timed beside its
   bounds; step time, device busy with the top device operations, and
   peak memory for ``dense`` and for ``xla``; ``fit`` for 20 steps with
   two validations and checkpoints, ``restore_checkpoint``,
   ``export_serving`` and queries; then ``python -m
   stargcn_tpu_torch.train --cfg configs/transductive_ml_1m.yml`` on the
   CLI's synthetic graph with no ``--backend``, 10 steps;
11b. ``KERNEL.BACKEND: xla`` at ML-10M width, on phase 4's graph and the
   trainer's parameters, in ``resolve_edge_chunk``'s 1,441,792-edge chunks
   (7 over 10M edges): one ``train_iteration`` with its time and peak
   memory, and its loss and gradients on one batch against the
   ``bitdense`` trainer's (kernels) and its plain twin's.
12. inductive ML-1M from an archive on disk: an ML-1M-format archive at
   the real size written by ``write_ml1m_format`` (6,040 users, 3,706
   items, 1,000,209 ratings requested, seed 123; write and ``LoadData``
   parse times, parsed counts beside the published ones), then
   ``configs/inductive_ml_1m_item_10.yml`` as published through
   ``predict.build_dataset`` (20% of the items held out, 90% of their
   edges; train / valid / test node and edge counts).  ``auto`` resolves
   to ``dense``: the three variants' adjacencies (distinct, none shared);
   one ``train_iteration`` (no bit or ELL launch), step time, device busy
   and peak memory with the three adjacencies held; the same batch and
   parameters on ``bitdense`` (4 ``bit_expand_matmul`` + 4
   ``bit_reduce_matmul`` on the inductive masks), its loss and every
   gradient against its plain versions fed bf16-rounded inputs (phase 6's
   tolerance) and against the ``dense`` step (phase 11's tolerance between
   ``dense`` and its float32 twin); ``fit`` for 20 steps with two
   validations and checkpoints, ``export_serving``, queries, and
   predictions on pairs of held-out test items (evaluation noise -1)
   equal to ``Trainer.predict``'s; ``SampledTrainer`` on ``pallas`` with
   phase 8's settings (one step: 4 ``ell_spmm_fwd_only`` + 4
   ``ell_spmm_transpose``; its loss and every gradient on one batch
   against the plain twin's, phase 8's tolerance; the step split into plan, pack, copy and
   device; ``fit`` for 10 steps with one validation); then ``python -m
   stargcn_tpu_torch.train --cfg configs/inductive_ml_1m_user_10.yml
   --data_root <dir> --max_iter 10``, the user-keyed config.

13. batch sampling and plan building on the card, and the prefetch threads
   (after phase 8, on phase 4's trainer): (a) ``TRAIN.DEVICE_SAMPLER`` at
   ML-10M on ``bitdense``: ``train_chunk_dev(10)`` (40 + 40 bit launches),
   a second chunk under the profiler with no host-to-device copy, one draw
   under ``torch.cuda.set_sync_debug_mode("error")`` checked on the host
   (every pair a train edge with its rating, the recon fraction within 5
   standard deviations of ``P_MASK``), the same drawn inputs through the
   host-fed step (loss and every gradient against the nearest of 12
   repeats of that step, within twice their spread, ``held_to_repeats``),
   step time, busy and idle beside the host-fed
   step, ``fit(max_iter=20)`` with the sampler on; (b) the same at ML-1M on
   ``dense`` in a fresh process (``--phases 13b``), with ``fit`` host-fed
   (the prefetch thread) and drawn on the card; (c)
   ``SampledTrainer(plan_device=True)`` at ML-10M (batch 4096, recon 1024,
   fanout 8, ``xla``): the probed caps above both node counts (the identity
   path), one step (no bit or ELL launch), its plan built under sync debug
   mode ``"error"`` and equal, array for array, to the same planner on the
   CPU fed the same uniforms, the step through ``identity_frontiers``
   against the gather path (phase 8's tolerances), device time of the plan
   and of the update, step time, idle share and memory above what is held
   beside phase 8's host-planned ``xla`` step, ``fit(max_iter=10)`` with
   one validation (valid and test cut to 8,192 pairs each), and a forced
   overflow: caps cut below what a batch needs, the update rejected with
   parameters and optimiser bit-equal, ``fit`` growing the caps and going
   on; (d) the dedup path: the largest batch out of 512 down to 16 whose
   probed user cap falls below the user count, its plan on the card equal
   to the CPU's, one step, and the exclusion's keep-mask equal to set
   membership of the batch pairs; (e) ``SampledTrainer.fit(max_iter=10)``
   on ``pallas`` serial and with ``prefetch=True`` (no validation inside:
   4 + 4 ELL launches a step), both timed beside phase 8's ``fit``.

14. the model options (after phase 13, on phase 4's trainer and phase 8's
   sampled trainer): (a) ``MODEL.COMPUTE_DTYPE: bfloat16`` on the ML-10M
   ``bitdense`` trainer's parameters, packs and batches: one step (4 + 4 bit
   launches), its loss and every gradient against the plain versions fed
   bf16-rounded inputs (phase 6's bound), step time, busy, idle and memory
   beside the float32 step in turns, ``fit(max_iter=20)`` (the loss falls),
   the trained parameters' bf16 predictions within 5% of float32's scale,
   the export (4 expands) and queries; then both bit kernels at F = 81 and
   F = 65 on the ML-10M packs (phase 5's checks and times); (b)
   ``MODEL.USE_FEA_PROJ`` (``FEA.MID_MAP`` / ``UNITS`` 16) with
   ``inductive_ml_1m_item_10.yml`` on phase 12's archive: the ``dense`` step
   and its numbers, the same batch on ``bitdense`` (4 + 4 bit launches at F
   = 81, against the plain versions and against ``dense``), ``fit(20)``,
   evaluation, the export and queries, a ``RECON_FEA`` step, a feature-only
   step and export (``USE_EMBED`` false, ``NBLOCKS`` 1, no DAE), and one
   sampled ``pallas`` step (4 + 4 ELL launches) against the plain ELL twin;
   (c) ``GCN.DROPOUT_PER_EDGE`` (forced to ``xla``) on phase 11's ML-1M
   graph beside the per-node ``xla`` step in turns, the eval equal to the
   per-node eval within 1e-5, one step's keep rate within 5 standard
   deviations of 1 - p, then one ML-10M step with its memory; (d) ``remat``
   on phase 8's ``pallas`` trainer and on a ``plan_device`` ``xla`` trainer:
   memory above what is held and time, with and without, in turns, loss and
   gradients from one dropout state within phase 8's bound; (e) bf16 on the
   ``plan_device`` trainer beside float32 in turns, with the top device
   operations; (f) ``python -m stargcn_tpu_torch.train`` on a YAML with
   ``USE_FEA_PROJ`` and bf16 over the ML-1M archive, full-graph, then with
   ``--num_neighbors 8 --remat``.
15. ranking, the ``ell`` backend and resilience (after phase 14, on phase
   4's graph and trainer): (a) ``rank_eval`` on the ML-10M test segment
   (about 1M positives, 100 device negatives, HR@10 / NDCG@10, seconds and
   positives per second) for the export of seed-123 parameters, of the
   trained parameters (phase 6's best checkpoint; alone, a 20-step
   ``fit``) and of i.i.d. Gaussian tables (HR@10 within 0.01 of 10/101),
   equal HR at batch 1000 and 4096, host negatives on 100,000 positives
   through ``rank_eval_from_iterator``, one batch of device negatives
   drawn with every wait an error and checked on the host (no edge,
   inside the items), and ``python -m stargcn_tpu_torch.predict
   --rank_eval`` on ``transductive_ml_1m.yml``; (b) ``recommend(k=10)``
   for 256 users on the trained and the seed artifacts in turns, in two
   fresh processes (``--phases 15b``, each artifact first in one), each
   call's time, whether the stream was idle before it, its parts (rated
   lists, copies, launches, ``.cpu()``, device) and the profiler's device
   time by kernel; (c) ``KERNEL.BACKEND: ell``: the packs (seconds, MB),
   one ``train_iteration`` launching no hand kernel, the same batch,
   parameters and dropout state against the ``xla`` trainer (phase 11's
   float32 bound), the ``bitdense`` trainer (phase 12's bound between
   ``bitdense`` and ``dense``) and an ``ELL_BF16`` twin, step and busy
   time with the top device operations and the memory above what is held
   beside the step's byte bound, ``fit(10)``, the export against the
   ``bitdense`` export, queries, and the train CLI with ``--backend ell``;
   (d) ``device_health_check`` on the card, a ``fit(20)`` whose step 7
   raises once (restored from ``ckpt_last``, one restart), a
   ``HeartbeatMonitor`` of 2 s around a 5 s host stall (its crash file
   holds the main thread's stack), and ``net0.txt``.
16. the profiler, the FLOP count, the reference step estimate and the host
   graph library (after phase 15, on phase 4's trainer, its parameters
   restored after): (a) ``fit(max_iter=VALID_INTERVAL)`` under
   ``utils.profiling.trace`` with one ``annotate`` span: the Chrome trace
   parses, holds the span, and holds 4 + 4 walk kernels of
   ``bit_expand`` / ``bit_reduce`` (their namespaces name them) a step,
   4 more expands an evaluation batch, as many as the wrappers counted;
   the top device operations by name, ``fit`` and 5 steps with and without
   the profiler; (b) 10 steps timed by ``StepTimer``, each ending in a
   synchronise: ``stargcn_step_flops`` at each step's active edges, the
   useful TFLOP/s and ``mfu`` against the H100's dense bf16 peak, inside
   (0, 1); (c) ``refestimate.measure_host_ms`` at the ``ml-100k``,
   ``ml-1m`` (3 iterations) and ``ml-10m`` (1) shapes on this host's CPU
   (named), then ``estimate`` on them and ``estimate_all`` on the
   recorded medians, every ``rate_bound`` inside (1e5, 7.2e8); (d)
   ``python -m stargcn_tpu_torch.train`` on ``transductive_ml_10m.yml``
   with ``--dataset synthetic --backend bitdense --max_iter 20 --profile
   DIR`` in a process of its own: rc 0 and its trace's bit kernels, 4 + 4
   a step; (e) ``sample_neighbors(symm,
   use_multi_link)`` on the ML-10M train CSR in both directions, seconds,
   the per-level counts adding up to the nnz.
17. full-graph training on a device mesh (after phase 16, on phase 4's
   graph and trainer, its state restored after), every step from one
   checkpoint of that trainer and one batch, held against the same step
   without a mesh (loss, ``sq_err``, every gradient and the parameters
   after it; phase 11's float32 tolerances, 1e-4, through the plain
   float32 pools; through the kernels, whose step has a new outcome at
   each repeat, against the nearest of 12 repeats within twice their
   spread, the parameters' worst entry within 5e-3): (a) a 1 x 1 mesh over
   NCCL (a world of one): 4 + 4 bit launches as without a mesh, the
   step's collectives (count, MB, their time alone), its time beside the
   step without a mesh, ``evaluate('valid')`` and ``export_serving`` equal
   to one process's; (b) two processes on this card over gloo
   (``--phases 17b`` twice; NCCL refuses two ranks on one device), on a 1 x
   2 and then a 2 x 1 mesh: each rank's 4 + 4 bit launches on its half of
   the packs (1 x 2), its step against the step without a mesh, its peak
   memory; (c) ``python -m stargcn_tpu_torch.train --mesh 1x1`` on
   ``transductive_ml_10m.yml`` (the CLI's synthetic graph, ``bitdense``, 4
   steps) and ``python -m stargcn_tpu_torch.parallel.multiprocess_train``,
   each in a process of its own.
18. sampled training on a device mesh (after phase 17, on phase 8's
   ``pallas`` trainer, one checkpoint of it and one batch, its state
   restored after), every step held against the same step without a mesh
   by phase 17's rule (the nearest of 12 repeats, within twice their
   spread), its collectives counted (``collectives.counted()``) and equal
   to ``perfmodel.modeled_collectives``: (a) a 1 x 1 mesh over NCCL: 4
   ``ell_spmm_fwd_only`` + 4 ``ell_spmm_transpose`` a step as without a
   mesh, the collectives' MB and their time alone, the step's time beside
   the step without a mesh, ``evaluate('valid')`` of the first 16,384
   valid pairs equal to one process's from the same planner seed, then a
   ``plan_device`` (``xla``) step; (b) two processes on this card over
   gloo (``--phases 18b`` twice), on 1 x 2 and then 2 x 1: each rank's
   step, its 4 + 4 ELL launches, each one's rows held element for element
   against the rank's slice of the whole blocks that the 1 x 2 mesh
   launched on (half of each block's rows on 2 x 1), its collectives, its
   peak memory; (c) in processes of their own, ``python -m
   stargcn_tpu_torch.train --mesh 1x1 --num_neighbors 8 --backend pallas``
   on ``transductive_ml_10m.yml`` (the CLI's synthetic graph, 4 steps),
   ``python -m stargcn_tpu_torch.parallel.scaling --meshes 1x1``, its
   ``--project --sampled`` table fed the step without a mesh and its
   device part (measured here on fresh batches), and ``python -m
   stargcn_tpu_torch.parallel.mesh_scale_check`` ``1 1 1`` (NCCL) beside
   ``2 2 1`` (two ranks on the card over gloo).

Phase 3 also checks the three ELL kernels on small cases (K = 1, 8, 32;
F = 1, 65, 250, 256; padded slots with in-range and out-of-range indices;
rows that repeat a source; a single source row; matrices that start off a
16-byte boundary), the transpose's ordering equal to ``sort_slots`` on
each, and the ordering and the transpose on the cases that stress the
ordering (a run of 100,000 slots; runs at the switch between its two ways
of ordering a run and either side of it; 870,400 sources with 6 live
slots; every slot dead; 1,120,000 slots), each ordering at the switch in
use and at switches that send every run one way, and each transpose
repeated bit for bit; then ``ell_sddmm`` on the cases of its design (K =
1, 3, 8, 15, 33 by F = 1, 64, 65, 250, 600; a row whose slots all name one
index; negative and too-large indices; every slot padded), each within
1e-5 of the largest output of ``plain_ell_sddmm``, repeated bit for bit,
and slots that name one index bit-equal.  Every time printed carries the
card's name and power limit.

Phases 13, 14, 15, 16, 17, 18, 10, 11, 11b and 12 run inside phase 4's
temporary directory, after phase 8, in that order.  The line before the last is the card's name
and power limit, the one before it ``{"kernels": [...]}`` (all nine
kernels: the ``dense``, ``xla`` and ``plan_device`` paths launch none of
them); each row's ``launches_by_path`` holds the count of every path that
launched it, each driven with the counts set to 0 just before it (phase
13 adds ``device_sampler train_chunk_dev(10)`` and ``device_sampler
fit(20)`` to the bit pair, ``sampled fit(10) prefetch=False`` and
``prefetch=True`` to the ELL pair; phase 14 the bf16 step and export and
the ``USE_FEA_PROJ`` step at F = 81 to the bit pair, the ``USE_FEA_PROJ``
sampled step and the ``remat`` step to the ELL pair, and the bit pair's
F = 65 / 81 times as ``walk_by_f``; phase 16 the profiled ``fit(10)``
and the ``StepTimer``'s 10 steps to the bit pair; phase 17 the mesh
paths, ``mesh 1x1 ...``, ``mesh 1x2 rank r ...``, ``mesh 2x1 rank r ...``
and ``mesh 1x1 train CLI``, to the bit pair; phase 18 ``mesh 1x1
sampled ...``, ``mesh 1x2 rank r sampled ...``, ``mesh 2x1 rank r sampled
...`` and ``mesh 1x1 sampled train CLI`` to the ELL pair); the last is ``{"ok":
true, "device": {...}}``.  Needs one card; imports nothing of JAX and
nothing of the JAX package.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
ML10M = dict(num_users=69_878, num_items=10_677, num_edges=10_000_000)
ML1M = dict(num_users=6040, num_items=3706, num_edges=1_000_209)
SEED = 123
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps):
    """Mean time per call on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn):
    """(result, seconds) on the host clock, ending in a synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_events(fn):
    """``[(name, ms, calls), ...]`` of the device-side entries (kernels,
    copies, memsets) of ``torch.profiler``'s trace of one call of ``fn``,
    largest first, names whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side entries only: the host-side operator entries carry their
    # kernels' time a second time.
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return sorted(events, key=lambda e: -e[1])


def device_busy_ms(fn, top=0, events=None):
    """Device time of one call of ``fn`` (the kernels and copies of
    ``torch.profiler``'s trace, summed), or None where the trace shows
    none.  With ``top``, also the ``top`` largest entries by name:
    ``(total, [(name, ms, calls), ...])``.  ``events`` takes a trace
    already made by ``device_events``."""
    events = device_events(fn) if events is None else events
    total_ms = sum(ms for _, ms, _ in events)
    total = total_ms if total_ms > 0 else None
    if not top:
        return total
    return total, [(name[:60], ms, calls) for name, ms, calls in events[:top]]


# ------------------------------ kernel check ------------------------------


def _sub_err(got, want, rel=1e-4):
    """Max abs error, the tolerance (``rel`` of the largest output: kernel
    and plain version sum the same bf16 values in float32, in another
    order) and the scale."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, rel * max(scale, 1.0), scale


def expand_err(bd, P, x, R, d8, rows=None, route="", rel=1e-4):
    """The expand kernel of ``route`` ("" natural, "16" row-interleaved)
    against its plain version fed the bf16-rounded x; ``rows = (r, m0,
    m1)`` compares packed rows r*d8 + [m0, m1) only (m0, m1 multiples of
    128 on the 16-bit route)."""
    import torch

    kernel = getattr(bd, f"bit_expand_matmul{route}")
    plain = getattr(bd, f"xla_expand_matmul{route}")
    got = kernel(P, x, R, d8)
    xr = x.to(torch.bfloat16).float()
    if rows is None:
        want = plain(P, xr, R, d8)
    else:
        r, m0, m1 = rows
        got = got[r:r + 1, :, m0:m1]
        want = plain(P[r * d8 + m0:r * d8 + m1], xr, 1, m1 - m0)
    return _sub_err(got, want, rel)


def reduce_err(bd, P, g, R, d8, rows=None, route="", rel=1e-4):
    """The reduce kernel of ``route`` against its plain version fed the
    bf16-rounded g; ``rows = (m0, m1)`` compares output rows [m0, m1)
    only."""
    import torch

    kernel = getattr(bd, f"bit_reduce_matmul{route}")
    plain = getattr(bd, f"xla_reduce_matmul{route}")
    got = kernel(P, g, R, d8)
    gr = g.to(torch.bfloat16).float()
    if rows is None:
        want = plain(P, gr, R, d8)
    else:
        m0, m1 = rows
        got = got[:, m0:m1]
        sub = torch.cat([P[r * d8 + m0:r * d8 + m1] for r in range(R)])
        want = plain(sub, gr, R, m1 - m0)
    return _sub_err(got, want, rel)


def natural_rows(bd, P16, R, d8):
    """The natural pack whose rows a ``row_interleave=128`` pack permutes:
    ``P[r*d8 + m] = P16[r*d8 + phys(m)]`` (a copy)."""
    import torch

    phys = bd.natural_to_physical(torch.arange(d8, device=P16.device), 128)
    return P16.view(R, d8, -1).index_select(1, phys).reshape(R * d8, -1)


def small_kernel_checks(bd):
    """``{kernel name: worst max abs error}`` over the small cases."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    worst = {"bit_expand_matmul": 0.0, "bit_reduce_matmul": 0.0}
    # (R, F, dense P, input dtype, D, S, g as a permuted view): the long-S
    # cases split each row's walk across several warps, as the ML-10M item
    # direction does.
    for R, F, dense, dtype, D, S, view in (
            (1, 7, False, torch.float32, 2000, 1500, False),
            (3, 65, True, torch.float32, 2000, 1500, True),
            (10, 65, False, torch.float32, 2000, 1500, True),
            (10, 65, True, torch.bfloat16, 2000, 1500, False),
            (2, 300, True, torch.float32, 2000, 1500, True),
            (10, 65, False, torch.float32, 300, 70000, True),
            (3, 65, True, torch.float32, 300, 40000, False),
            # F = 81: MODEL.USE_FEA_PROJ's 64 + 16 columns and the ones
            # column (walk_plan: fp 88, one column tile).
            (10, 81, False, torch.float32, 2000, 1500, True),
            (10, 81, True, torch.bfloat16, 300, 70000, False)):
        e = 40000
        P, d8 = bd.pack_bits(rng.randint(0, D, e), rng.randint(0, S, e),
                             rng.randint(0, R, e), R, D, S)
        if dense:
            P = rng.randint(0, 256, P.shape).astype(np.uint8)
        Pt = torch.from_numpy(P).to(DEVICE)
        s_pad = P.shape[1]
        x = torch.from_numpy(rng.randn(s_pad, F).astype(
            np.float32)).to(DEVICE, dtype)
        g = torch.from_numpy(rng.randn(s_pad, R, F).astype(
            np.float32)).to(DEVICE, dtype).permute(1, 0, 2)
        if not view:
            g = g.contiguous()
        what = (f"R={R} F={F} D={D} S={S} {'dense' if dense else 'sparse'} "
                f"{str(dtype)[6:]}")
        for name, (err, tol, scale) in (
                ("bit_expand_matmul", expand_err(bd, Pt, x, R, d8)),
                ("bit_reduce_matmul", reduce_err(bd, Pt, g, R, d8))):
            log(f"  {name} {what}"
                f"{' g=view' if view and 'reduce' in name else ''}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"{name} disagrees ({what})")
            worst[name] = max(worst[name], err)
    return worst


def small_kernel16_checks(bd):
    """``{kernel name: worst max abs error}`` of the two 16-bit kernels
    over small cases on ``row_interleave=128`` packs: each against its
    plain version (tolerance 1e-5 of the largest output), and each equal
    bit for bit to its natural kernel on the natural pack.  F = 600 is
    where the reference's ``bit_reduce_matmul16`` halves its row block
    (``bitdense.py:424``) and scrambles its output; this one must not."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 7)
    worst = {"bit_expand_matmul16": 0.0, "bit_reduce_matmul16": 0.0}
    # (R, F, dense P, input dtype, D, S, g as a permuted view)
    for R, F, dense, dtype, D, S, view in (
            (1, 1, False, torch.float32, 2000, 1500, False),
            (3, 7, True, torch.float32, 2000, 1500, True),
            (10, 65, False, torch.float32, 2000, 1500, True),
            (10, 65, True, torch.bfloat16, 2000, 1500, False),
            (3, 256, False, torch.float32, 2000, 1500, True),
            (2, 600, True, torch.float32, 2000, 1500, True),
            (10, 600, False, torch.bfloat16, 300, 40000, True),
            (10, 65, False, torch.float32, 300, 70000, True),
            (1, 65, True, torch.float32, 300, 40000, False)):
        e = 40000
        P, d8 = bd.pack_bits(rng.randint(0, D, e), rng.randint(0, S, e),
                             rng.randint(0, R, e), R, D, S,
                             row_interleave=128)
        if dense:
            P = rng.randint(0, 256, P.shape).astype(np.uint8)
        Pt = torch.from_numpy(P).to(DEVICE)
        Pn = natural_rows(bd, Pt, R, d8)
        s_pad = P.shape[1]
        x = torch.from_numpy(rng.randn(s_pad, F).astype(
            np.float32)).to(DEVICE, dtype)
        g = torch.from_numpy(rng.randn(s_pad, R, F).astype(
            np.float32)).to(DEVICE, dtype).permute(1, 0, 2)
        if not view:
            g = g.contiguous()
        what = (f"R={R} F={F} D={D} S={S} {'dense' if dense else 'sparse'} "
                f"{str(dtype)[6:]}")
        for name, (err, tol, scale), same in (
                ("bit_expand_matmul16",
                 expand_err(bd, Pt, x, R, d8, route="16", rel=1e-5),
                 torch.equal(bd.bit_expand_matmul16(Pt, x, R, d8),
                             bd.bit_expand_matmul(Pn, x, R, d8))),
                ("bit_reduce_matmul16",
                 reduce_err(bd, Pt, g, R, d8, route="16", rel=1e-5),
                 torch.equal(bd.bit_reduce_matmul16(Pt, g, R, d8),
                             bd.bit_reduce_matmul(Pn, g, R, d8)))):
            log(f"  {name} {what}"
                f"{' g=view' if view and 'reduce' in name else ''}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}; equal to the natural kernel on the natural "
                f"pack: {same}")
            check(err <= tol, f"{name} disagrees ({what})")
            check(same, f"{name} differs from the natural kernel ({what})")
            worst[name] = max(worst[name], err)
    return worst


def design_pack(rng, kind, rows, s_pad):
    """A (rows, s_pad) uint8 pack for the walk's edge cases: ``sparse``
    (about 1% of the bytes non-zero, one bit each), ``dense`` (every byte
    non-zero, so a stage's list is full), ``random`` (uniform bytes) or
    ``last`` (non-zero bytes only past the last multiple of 4096, the
    row's tail)."""
    import numpy as np

    if kind == "dense":
        return rng.randint(1, 256, (rows, s_pad)).astype(np.uint8)
    if kind == "random":
        return rng.randint(0, 256, (rows, s_pad)).astype(np.uint8)
    P = np.zeros((rows, s_pad), np.uint8)
    lo = (s_pad - 1) // 4096 * 4096 if kind == "last" else 0
    live = rng.rand(rows, s_pad - lo) < (0.2 if kind == "last" else 0.01)
    P[:, lo:] = np.where(live, 1 << rng.randint(0, 8, live.shape), 0)
    return P


def strided_g(rng, R, s_pad, F, dtype, view):
    """A (R, s_pad, F) cotangent on the card with non-default row strides:
    ``perm`` (the permuted (s_pad, R, F) view autograd hands over), ``pad``
    (rows of a wider table) or ``skip`` (every other row of a taller
    one)."""
    import numpy as np
    import torch

    if view == "perm":
        base = rng.randn(s_pad, R, F).astype(np.float32)
        return torch.from_numpy(base).to(DEVICE, dtype).permute(1, 0, 2)
    if view == "pad":
        base = rng.randn(R, s_pad, F + 5).astype(np.float32)
        return torch.from_numpy(base).to(DEVICE, dtype)[..., :F]
    base = rng.randn(R, 2 * s_pad, F).astype(np.float32)
    return torch.from_numpy(base).to(DEVICE, dtype)[:, ::2]


def small_design_checks(bd):
    """``{kernel name: worst max abs error}`` over the walk's edge cases
    (bit_walk.cuh): full stage lists, non-zeros only in a last partial
    stage, S_pad = 16 and S_pad off the 512-byte stage, rows walked by one
    warp and by a block's 8, F = 1 to 600 (one or two register rounds, one
    to three column tiles), f32 and bf16 input, cotangents with non-default
    strides.  Each kernel against its plain
    version fed the same bf16-rounded input (1e-4 of the largest output,
    1e-5 on the 16-bit route), each repeated bit for bit, and the 16-bit
    route on the row-interleaved pack equal bit for bit to the natural
    kernel on the natural pack."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 11)
    names = ("bit_expand_matmul", "bit_reduce_matmul", "bit_expand_matmul16",
             "bit_reduce_matmul16")
    worst = dict.fromkeys(names, 0.0)
    f32, bf16 = torch.float32, torch.bfloat16
    # (R, d8, S_pad, F, input dtype, pack kind, g view)
    for R, d8, s_pad, F, dtype, kind, view in (
            (2, 128, 16, 65, f32, "dense", "perm"),
            (2, 128, 4096, 8, bf16, "dense", "pad"),
            (3, 128, 4624, 65, f32, "last", "skip"),
            (1, 128, 1040, 1, f32, "sparse", "perm"),
            (2, 128, 8208, 72, bf16, "sparse", "pad"),
            (2, 256, 2048, 256, f32, "random", "perm"),
            (2, 128, 1024, 257, f32, "sparse", "skip"),
            (1, 128, 528, 600, bf16, "random", "perm"),
            (10, 128, 12288, 65, f32, "sparse", "perm"),
            (10, 128, 12288, 81, f32, "sparse", "perm"),
            (2, 128, 32784, 65, f32, "last", "pad")):
        Pn = torch.from_numpy(design_pack(rng, kind, R * d8, s_pad)).to(
            DEVICE)
        # The row_interleave=128 pack of the same edges.
        phys = bd.natural_to_physical(torch.arange(d8, device=DEVICE), 128)
        P16 = torch.empty_like(Pn)
        P16.view(R, d8, -1)[:, phys] = Pn.view(R, d8, -1)
        x = torch.from_numpy(rng.randn(s_pad, F).astype(np.float32)).to(
            DEVICE, dtype)
        g = strided_g(rng, R, s_pad, F, dtype, view)
        what = (f"R={R} d8={d8} S_pad={s_pad} F={F} {kind} "
                f"{str(dtype)[6:]} g={view}{tuple(g.stride())}")
        for name, P, v, rel in (
                ("bit_expand_matmul", Pn, x, 1e-4),
                ("bit_reduce_matmul", Pn, g, 1e-4),
                ("bit_expand_matmul16", P16, x, 1e-5),
                ("bit_reduce_matmul16", P16, g, 1e-5)):
            err_fn = expand_err if "expand" in name else reduce_err
            route = "16" if name.endswith("16") else ""
            err, tol, scale = err_fn(bd, P, v, R, d8, route=route, rel=rel)
            kernel = getattr(bd, name)
            out = kernel(P, v, R, d8)
            again = torch.equal(out, kernel(P, v, R, d8))
            same = True
            if route:
                natural = getattr(bd, name[:-2])
                same = torch.equal(out, natural(Pn, v, R, d8))
            log(f"  {name} {what}: max_abs_err={err:.3e} "
                f"rel={err / max(scale, 1e-30):.3e} tol={tol:.3e}; repeats "
                f"bit for bit: {again}"
                + (f"; equal to the natural kernel: {same}" if route else ""))
            check(err <= tol, f"{name} disagrees ({what})")
            check(again, f"{name} does not repeat bit for bit ({what})")
            check(same, f"{name} differs from the natural kernel ({what})")
            worst[name] = max(worst[name], err)
    return worst


def bound_ms(nbytes, set_bits, f):
    """Least time for one launch: its operands and its output moved once
    at the HBM rate, or one f32 add per set bit per column at the f32
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = set_bits * f / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def set_bits(P):
    import torch

    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=P.device)
    total = 0
    for lo in range(0, P.shape[0], 8192):
        total += int(table[P[lo:lo + 8192].long()].sum())
    return total


def full_expand_checks(bd, pack, R, F, card, route="", natural=None):
    """``bit_expand_matmul{route}`` on the full ML-10M packs of the serving
    path: a few row blocks checked against the plain version, two launches
    compared, then timed against the plain version and the bound.  On the
    16-bit route (``natural`` = the natural pack of the same variant) the
    result must also equal the natural kernel's on the natural pack."""
    import torch

    name = f"bit_expand_matmul{route}"
    kernel = getattr(bd, name)
    plain = getattr(bd, f"xla_expand_matmul{route}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes, worst = [], 0.0
    for direction in ("user", "item"):
        P = pack[direction]["pf"]
        d8 = P.shape[0] // R
        s_pad = P.shape[1]
        x = torch.randn(s_pad, F, device=DEVICE, generator=gen)
        w, mid = (256 if d8 >= 512 else 128), d8 // 2 // 128 * 128
        for rows in ((0, 0, w), (R // 2, mid, mid + w), (R - 1, d8 - w, d8)):
            err, tol, scale = expand_err(bd, P, x, R, d8, rows, route)
            log(f"  full-size check {name} {direction} rows {rows}: "
                f"max_abs_err={err:.3e} rel={err / max(scale, 1e-30):.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"{name} disagrees at ML-10M ({direction}, "
                              f"rows {rows})")
            worst = max(worst, err)
        out = kernel(P, x, R, d8)
        check(torch.equal(out, kernel(P, x, R, d8)),
              f"{name} does not repeat bit for bit ({direction})")
        if natural is not None:
            check(torch.equal(out, bd.bit_expand_matmul(
                natural[direction]["pf"], x, R, d8)),
                  f"{name} differs from bit_expand_matmul on the natural "
                  f"pack ({direction})")
            log(f"  {name} {direction}: equal bit for bit to "
                f"bit_expand_matmul on the natural pack")
        del out
        ms = cuda_ms(lambda: kernel(P, x, R, d8), reps=20)
        zero = torch.zeros_like(P)
        zero_ms = cuda_ms(lambda: kernel(zero, x, R, d8), reps=20)
        del zero
        plain_ms = cuda_ms(lambda: plain(P, x, R, d8), reps=2)
        ones = set_bits(P)
        bms, by = bound_ms(P.numel() + s_pad * F * 4 + R * 8 * d8 * F * 4,
                           ones, F)
        shapes.append(dict(direction=direction, P=list(P.shape), F=F,
                           set_bits=ones, ms=ms, zero_pack_ms=zero_ms,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           bound_share=bms / ms))
        log(f"  {name} {direction} P={tuple(P.shape)} F={F}: kernel "
            f"{ms:.4f} ms/launch ({bms / ms:.1%} of the bound), on an "
            f"all-zero pack {zero_ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}), set bits {ones} [{card}]")
    return worst, shapes


def full_reduce_checks(bd, pack, R, F, card, route="", natural=None):
    """``bit_reduce_matmul{route}`` on the full ML-10M train packs, at the
    shapes the training step gives it: the backward of the aggregation into
    ``direction`` reads that direction's ``pb`` and a permuted view of the
    ``(D_pad, R, F)`` cotangent, and gives the gradient for the other
    type.  A few output-row blocks checked, two launches compared (and, on
    the 16-bit route, the natural kernel on ``natural``), then timed."""
    import torch

    name = f"bit_reduce_matmul{route}"
    kernel = getattr(bd, name)
    plain = getattr(bd, f"xla_reduce_matmul{route}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    shapes, worst = [], 0.0
    for direction, grad_for in (("user", "item"), ("item", "user")):
        P = pack[direction]["pb"]
        d8 = P.shape[0] // R
        s_pad = P.shape[1]
        g = torch.randn(s_pad, R, F, device=DEVICE,
                        generator=gen).permute(1, 0, 2)
        w, mid = 128, d8 // 2 // 128 * 128
        for rows in ((0, w), (mid, mid + w), (d8 - w, d8)):
            err, tol, scale = reduce_err(bd, P, g, R, d8, rows, route)
            log(f"  full-size check {name} gradient for {grad_for} rows "
                f"{rows}: max_abs_err={err:.3e} "
                f"rel={err / max(scale, 1e-30):.3e} tol={tol:.3e}")
            check(err <= tol, f"{name} disagrees at ML-10M (gradient for "
                              f"{grad_for}, rows {rows})")
            worst = max(worst, err)
        out = kernel(P, g, R, d8)
        check(torch.equal(out, kernel(P, g, R, d8)),
              f"{name} does not repeat bit for bit (gradient for "
              f"{grad_for})")
        if natural is not None:
            check(torch.equal(out, bd.bit_reduce_matmul(
                natural[direction]["pb"], g, R, d8)),
                  f"{name} differs from bit_reduce_matmul on the natural "
                  f"pack (gradient for {grad_for})")
            log(f"  {name} gradient for {grad_for}: equal bit for bit to "
                f"bit_reduce_matmul on the natural pack")
        del out
        ms = cuda_ms(lambda: kernel(P, g, R, d8), reps=20)
        zero = torch.zeros_like(P)
        zero_ms = cuda_ms(lambda: kernel(zero, g, R, d8), reps=20)
        del zero
        plain_ms = cuda_ms(lambda: plain(P, g, R, d8), reps=2)
        ones = set_bits(P)
        bms, by = bound_ms(P.numel() + R * s_pad * F * 4 + 8 * d8 * F * 4,
                           ones, F)
        shapes.append(dict(gradient_for=grad_for, P=list(P.shape),
                           g=[R, s_pad, F], F=F, set_bits=ones, ms=ms,
                           zero_pack_ms=zero_ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, bound_share=bms / ms))
        log(f"  {name} gradient for {grad_for} P={tuple(P.shape)} "
            f"g=({R}, {s_pad}, {F}) view: kernel {ms:.4f} ms/launch "
            f"({bms / ms:.1%} of the bound), on an all-zero pack "
            f"{zero_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
            f"({by}), set bits {ones} [{card}]")
    return worst, shapes


def pack_bits_check(bd, trainer, packs, card):
    """Phase 4: ``pack_bits`` (the port's C++ extension) beside its numpy
    version ``plain_pack_bits`` on the train variant's edges, a layout
    (both directions) at a time, natural and ``row_interleave=128``
    (``pallas16``), in turns (native, numpy, native): the host seconds of
    each, the two packs equal byte for byte, and the natural ones equal to
    the trainer's packs on the card.  Returns the seconds."""
    import numpy as np

    v, cfg = trainer.variants, trainer.model_cfg
    eu, ei, er, pad = v._edges
    mask = np.ascontiguousarray(v.edge_mask("train") * pad, np.float32)
    dirs = ((eu, ei, cfg.num_users, cfg.num_items),
            (ei, eu, cfg.num_items, cfg.num_users))
    numbers = {}
    for layout, ril in (("natural", 0), ("pallas16", bd._BM)):
        made = {}
        for route, fn in (("native", bd.pack_bits),
                          ("numpy", bd.plain_pack_bits),
                          ("native", bd.pack_bits)):
            t0 = time.perf_counter()
            made[route] = [fn(d, s, er, cfg.num_links, nd, ns, mask=mask,
                              row_interleave=ril)[0]
                           for d, s, nd, ns in dirs]
            numbers.setdefault(f"{layout}_{route}_s", []).append(
                time.perf_counter() - t0)
        same = all(np.array_equal(a, b) for a, b in zip(made["native"],
                                                        made["numpy"]))
        log(f"  pack_bits, {layout} layout (both directions, "
            f"{tuple(made['native'][0].shape)} and "
            f"{tuple(made['native'][1].shape)} u8): native "
            f"{', '.join(f'{x:.3f}' for x in numbers[layout + '_native_s'])}"
            f" s, numpy {numbers[layout + '_numpy_s'][0]:.3f} s; equal byte "
            f"for byte: {same} [{card}]")
        check(same, f"pack_bits ({layout}) differs from plain_pack_bits")
        if ril == 0:
            on_card = (packs["train"]["user"]["pf"].cpu().numpy(),
                       packs["train"]["user"]["pb"].cpu().numpy())
            check(all(np.array_equal(a, b) for a, b in zip(made["native"],
                                                            on_card)),
                  "the trainer's train packs differ from pack_bits'")
        del made
    return numbers


def pack_layout_check(bd, packs16, packs, R):
    """Every ``row_interleave=128`` pack equals its natural pack with the
    rows permuted, byte for byte."""
    import torch

    for variant in packs16:
        check(packs16[variant]["row_interleave"] == 128
              and packs[variant]["row_interleave"] == 0,
              f"{variant}: pack layouts")
        for direction in ("user", "item"):
            P16 = packs16[variant][direction]["pf"]
            check(torch.equal(natural_rows(bd, P16, R, P16.shape[0] // R),
                              packs[variant][direction]["pf"]),
                  f"{variant} {direction}: the interleaved pack is not the "
                  f"natural one with its rows permuted")
        log(f"  {variant}: both row_interleave=128 layouts equal the natural "
            f"ones with rows permuted, byte for byte")


def adjoint_check(bd, pack, R, F, route=""):
    """``<expand(p_fwd, x), g> = <x, reduce(p_bwd, g)>`` on the full packs
    (of ``route``'s layout) with bf16-representable x and g, sums in
    float64, relative 1e-5."""
    import torch

    expand = getattr(bd, f"bit_expand_matmul{route}")
    reduce = getattr(bd, f"bit_reduce_matmul{route}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    for direction in ("user", "item"):
        pf, pb = pack[direction]["pf"], pack[direction]["pb"]
        d8_dst, d8_src = pf.shape[0] // R, pb.shape[0] // R
        x = torch.randn(pf.shape[1], F, device=DEVICE,
                        generator=gen).to(torch.bfloat16).float()
        g = torch.randn(8 * d8_dst, R, F, device=DEVICE,
                        generator=gen).to(torch.bfloat16).float()
        fwd = expand(pf, x, R, d8_dst)
        lhs = float((fwd.permute(1, 2, 0, 3).reshape(8 * d8_dst, R, F)
                     .double() * g.double()).sum())
        bwd = reduce(pb, g.permute(1, 0, 2), R, d8_src)
        rhs = float((x.double() * bwd.reshape(8 * d8_src, F).double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        log(f"  adjoint{route and ' (16-bit route)'}, aggregation into "
            f"{direction}: <expand(x), g> = {lhs:.6f}, <x, reduce(g)> = "
            f"{rhs:.6f}, rel diff {rel:.3e} (tol 1e-5)")
        check(rel <= 1e-5, f"adjoint identity fails ({direction}{route})")


# --------------------------------- set-up ---------------------------------


def build_ml10m():
    """The ML-10M-shaped synthetic graph and its split (seed 123, 10% test,
    10% valid), the config ``transductive_ml_10m.yml`` and its model
    config."""
    import numpy as np

    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import build_model_config
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
    return cfg, it, model_cfg


def build_ml1m():
    """The ML-1M-shaped synthetic graph and its split (seed 123, 10% test,
    10% valid), the config ``transductive_ml_1m.yml`` as published and its
    model config (``KERNEL.BACKEND: auto``)."""
    import numpy as np

    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.data.synthetic import synthetic_graph
    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(os.path.join(ROOT, "configs",
                                     "transductive_ml_1m.yml"))
    cfg.DATASET.NAME = "synthetic"
    g = synthetic_graph(**ML1M, rating_values=(1, 2, 3, 4, 5), seed=SEED)
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
                                   len(csr.multi_link), num_edges=csr.nnz)
    return cfg, it, model_cfg


def plain_twin(owner):
    """The same ``Trainer`` or ``ServingState`` (a shallow copy: same
    operands, same dropout stream) with the model on the plain versions."""
    from stargcn_tpu_torch.models import STARGCN
    from stargcn_tpu_torch.models.stargcn import feature_dims

    twin = copy.copy(owner)
    twin.model = STARGCN(dataclasses.replace(owner.model_cfg,
                                             bit_impl="xla"),
                         feature_dims=feature_dims(owner.data_iter))
    twin.model.load_state_dict(owner.model.state_dict())
    twin.model.to(owner.device)
    return twin


@contextlib.contextmanager
def bf16_fed_plain_versions(bd):
    """While open, the plain versions round their float operand to bf16
    first, as the kernels do."""
    import torch

    expand, reduce = bd.xla_expand_matmul, bd.xla_reduce_matmul

    def rounded(fn):
        return lambda P, v, *args: fn(P, v.to(torch.bfloat16).float(), *args)

    bd.xla_expand_matmul, bd.xla_reduce_matmul = (rounded(expand),
                                                  rounded(reduce))
    try:
        yield
    finally:
        bd.xla_expand_matmul, bd.xla_reduce_matmul = expand, reduce


def rel_err(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bit_counts(expand, reduce, expand16, reduce16):
    """The launch counts of the four bit kernel wrappers, as a dict."""
    return {"bit_expand_matmul": expand, "bit_reduce_matmul": reduce,
            "bit_expand_matmul16": expand16, "bit_reduce_matmul16": reduce16}


def zero_launches(*modules):
    for mod in modules:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def check_queries(art, card, what):
    """``predict`` and ``recommend`` on the card over ``art``."""
    import numpy as np

    from stargcn_tpu_torch.serve import Predictor

    pred = Predictor(art, device=DEVICE)
    rng = np.random.RandomState(SEED)
    uu = rng.randint(0, art.num_users, 4096)
    ii = rng.randint(0, art.num_items, 4096)
    ratings, t_pred = host_s(lambda: pred.predict(uu, ii))
    want = np.clip((art.user_feats[uu] * art.item_feats[ii]).sum(-1)
                   * art.rating_std + art.rating_mean, art.rating_min,
                   art.rating_max)
    check(ratings.shape == (4096,) and np.isfinite(ratings).all(),
          "predict output")
    check(ratings.min() >= 0.5 and ratings.max() <= 5.0,
          "ratings outside [0.5, 5.0]")
    check(np.abs(ratings - want).max() <= 1e-4, "predict disagrees with "
          "the artifact's inner product")
    users = rng.choice(art.num_users, 256, replace=False)
    # The first call of a process pays one-time costs (loading the topk and
    # scatter kernels; PERF.md §6): timed apart from warm calls.
    (idx, vals), t_first = host_s(lambda: pred.recommend(users, k=10))
    t_rec = median([host_s(lambda: pred.recommend(users, k=10))[1]
                    for _ in range(3)])
    check(idx.shape == (256, 10) and np.isfinite(vals).all(),
          "recommend output")
    for r, u in enumerate(users):
        rated = art.rated_items[art.rated_indptr[u]:art.rated_indptr[u + 1]]
        check(not np.isin(idx[r], rated).any(),
              f"user {u} was recommended an item it rated")
    log(f"  {what}: predict 4096 pairs: {t_pred * 1e3:.2f} ms; recommend "
        f"k=10 for 256 users: {t_rec * 1e3:.2f} ms (median of 3 after a "
        f"first call of {t_first * 1e3:.2f} ms) [{card}]")


def check_artifact(art, graph=ML10M):
    import numpy as np

    check(art.user_feats.shape == (graph["num_users"], 64)
          and art.item_feats.shape == (graph["num_items"], 64),
          "artifact shapes")
    check(np.isfinite(art.user_feats).all()
          and np.isfinite(art.item_feats).all(), "non-finite features")


# ----------------------------- training slice -----------------------------


@contextlib.contextmanager
def recorded_losses(trainer, losses):
    """While open, every step of the full-graph ``trainer`` (host-fed or
    drawn on the card, single or in a chunk: ``fit`` takes them all
    through ``_step``) appends its loss to ``losses``.  The class's method
    comes back on exit: a copy of the trainer (the twins of phase 11b)
    must not carry this trainer's bound step."""
    real_step = trainer._step

    def recording_step(*inputs):
        st = real_step(*inputs)
        losses.append(st["loss"])
        return st

    trainer._step = recording_step
    try:
        yield
    finally:
        del trainer._step


def next_batches(trainer, rating_sampler, recon_sampler):
    rb = next(rating_sampler)
    noise_dict, _, recon_ids = next(recon_sampler)
    return rb, trainer.prepare_recon_batch(noise_dict, recon_ids)


def run_training_slice(bd, trainer, card):
    """Phase 6.  Returns the launch counts of one training step."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import export_serving

    it, s = trainer.data_iter, trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    batch = next_batches(trainer, rating_sampler, recon_sampler)
    check(trainer.do_remove and batch[0][1].size == 100_000,
          "the step should remove a batch of 100,000 train edges")
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    # (a) one step through the entry point: counts from 0, then read.
    torch.cuda.reset_peak_memory_stats()
    trainer.seed_dropout(SEED)
    zero_launches(bd)
    stats, t_first = host_s(lambda: trainer.train_iteration(*batch))
    launches = dict(bd.LAUNCHES)
    log(f"  first train_iteration: {t_first * 1e3:.1f} ms (start-up "
        f"included), loss {float(stats['loss']):.4f}, gnorm "
        f"{float(stats['gnorm']):.4f}, launches {launches} [{card}]")
    check(launches == bit_counts(4, 4, 0, 0),
          f"expected 4 + 4 kernel launches in a step, got {launches}")
    check(bool(torch.isfinite(stats["loss"])), "non-finite first loss")

    # (b) the same step, from the same parameters, batch and dropout
    # masks, through the kernels and through a plain twin: once with the
    # plain versions fed bf16-rounded x and g (the kernels' arithmetic in
    # another order), once as they are (what the rounding costs).
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    trainer.seed_dropout(SEED)
    (k_stats, k_grads), t_k = host_s(lambda: trainer.loss_and_grads(*batch))
    repeats = []
    for _ in range(4):
        trainer.seed_dropout(SEED)
        repeats.append(trainer.loss_and_grads(*batch))
    twin = plain_twin(trainer)
    trainer.seed_dropout(SEED)
    with bf16_fed_plain_versions(bd):
        (r_stats, r_grads), _ = host_s(lambda: twin.loss_and_grads(*batch))
    trainer.seed_dropout(SEED)
    (p_stats, p_grads), t_p = host_s(lambda: twin.loss_and_grads(*batch))
    del twin

    def compare(stats, grads):
        loss_rel = abs(float(k_stats["loss"]) - float(stats["loss"])) \
            / abs(float(stats["loss"]))
        worst, worst_name, diff2, norm2 = 0.0, "", 0.0, 0.0
        for name, pg in grads.items():
            scale = float(pg.abs().max())
            check(scale > 0, f"zero gradient for {name}")
            rel = float((k_grads[name] - pg).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, name
            diff2 += float((k_grads[name] - pg).double().pow(2).sum())
            norm2 += float(pg.double().pow(2).sum())
        return loss_rel, worst, worst_name, (diff2 / norm2) ** 0.5

    log(f"  forward+backward through the kernels {t_k * 1e3:.1f} ms, "
        f"through the plain versions {t_p * 1e3:.1f} ms")
    floor = [compare(*rep) for rep in repeats]
    spread = (max(x[3] for x in floor), max(x[1] for x in floor))
    del repeats
    log(f"  the same step 4 more times through the kernels, each against "
        f"the first: all gradients together "
        f"{', '.join(f'{x[3]:.3e}' for x in floor)} relative; worst single "
        f"parameter {', '.join(f'{x[1]:.3e}' for x in floor)} of its "
        f"largest entry ({', '.join(sorted({x[2] for x in floor}))}).  "
        f"That is the floor for what follows: index_add_ and the row "
        f"gather's backward use atomics, the library's matrix products "
        f"may sum in another order from call to call, and at the seed's "
        f"parameters some gradients are sums that nearly cancel")
    loss_rel, worst, worst_name, glob = compare(r_stats, r_grads)
    log(f"  kernels against plain versions fed bf16-rounded x and g: loss "
        f"rel diff {loss_rel:.3e}, all gradients together {glob:.3e} "
        f"relative (tol 1e-3), worst single parameter {worst:.3e} of its "
        f"largest entry ({worst_name}; {len(r_grads)} parameters; tol "
        f"5e-2)")
    check(loss_rel <= 1e-3 and glob <= 1e-3 and worst <= 5e-2,
          "training step through the kernels disagrees with the plain "
          "versions fed the same rounded inputs")
    loss_rel, worst, worst_name, glob = compare(p_stats, p_grads)
    log(f"  kernels against plain versions as they are (no rounding): loss "
        f"rel diff {loss_rel:.3e}, all gradients together {glob:.3e} "
        f"relative (tol 1e-1), worst single parameter {worst:.3e} of its "
        f"largest entry ({worst_name}): at the seed's parameters these "
        f"gradients are sums that nearly cancel, so bf16 rounding of x "
        f"shows in them far above its 4e-3")
    check(loss_rel <= 1e-2 and glob <= 1e-1,
          "training step through the kernels disagrees with the plain twin")
    del k_grads, p_grads, r_grads

    # Steady-state step time: a few steps, host clock ending in a
    # synchronise, kernel time by CUDA events around the wrappers.
    times = []
    for _ in range(5):
        b = next_batches(trainer, rating_sampler, recon_sampler)
        _, t = host_s(lambda: trainer.train_iteration(*b))
        times.append(t * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    b = next_batches(trainer, rating_sampler, recon_sampler)
    t0 = time.perf_counter()
    host_arrays = trainer._prep_host_arrays(*b)
    prep_ms = (time.perf_counter() - t0) * 1e3
    del host_arrays
    log(f"  train_iteration, 5 steps after the first: "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (median {step_ms:.1f} "
        f"ms/step at batch {s.rating_batch_size}); of a step, the host's "
        f"_prep_host_arrays takes {prep_ms:.1f} ms [{card}]")
    busy_ms = device_busy_ms(lambda: trainer.train_iteration(*b))
    if busy_ms is None:
        log("  device busy time of a step: not measured (the profiler "
            "showed no device time)")
    else:
        log(f"  device busy time of one step (torch.profiler, kernels and "
            f"copies summed): {busy_ms:.1f} ms, so the card idles for "
            f"about {max(0.0, 1 - busy_ms / step_ms):.0%} of a "
            f"{step_ms:.1f} ms step [{card}]")

    # (c) fit: 20 steps with the config's intervals -> two validations.
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    trainer.seed_dropout(SEED)
    losses = []
    lines = []
    zero_launches(bd)
    with recorded_losses(trainer, losses):
        summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                    log=lines.append))
    fit_launches = dict(bd.LAUNCHES)
    for line in lines:
        log(f"  fit: {line}")
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  fit(max_iter=20): {t_fit:.2f} s with two validations, two test "
        f"evaluations at most and checkpoints; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; launches {fit_launches};"
        f" peak device memory {peak_gb:.2f} GiB [{card}]")
    check(len(losses) == 20 and np.isfinite(losses).all(),
          "fit should take 20 steps with finite losses")
    check(np.mean(losses[10:]) < losses[0],
          "mean loss of steps 11-20 is not below step 1's")
    eval_batches = -(-it.valid_node_pairs.shape[1] // s.rating_batch_size)
    check(fit_launches["bit_reduce_matmul"] == 80
          and fit_launches["bit_expand_matmul"] >= 80 + 2 * 4 * eval_batches,
          f"fit launch counts {fit_launches}")
    span = trainer.rating_max - trainer.rating_min
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] in (10, 20) and np.isfinite(rmses).all()
          and 0 <= min(rmses) and max(rmses) <= span,
          f"fit summary {summary}")
    check(sum("Val RMSE" in x for x in lines) == 2, "two validations")

    # (d) the best checkpoint gives back the parameters that were saved.
    best = os.path.join(trainer.save_dir, "ckpt_best_0.pt")
    last = os.path.join(trainer.save_dir, "ckpt_last_0.pt")
    check(os.path.exists(best) and os.path.exists(last), "checkpoints")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    trainer.restore_checkpoint(best)
    for name, t in trainer.model.state_dict().items():
        check(torch.equal(t.cpu(), saved["params"][name]),
              f"restored parameter {name} differs from the saved one")
    check(trainer.opt.count == summary["best_iter"],
          "restored optimizer step count")
    moved = max(float((t.cpu() - params0[k].cpu()).abs().max())
                for k, t in trainer.model.state_dict().items())
    check(moved > 0, "training did not move the parameters")
    log(f"  restore_checkpoint({os.path.basename(best)}): parameters equal "
        f"the saved ones, optimizer at step {trainer.opt.count}")

    # (e) export and serve the trained parameters.
    zero_launches(bd)
    art, t_export = host_s(lambda: export_serving(trainer, segment="test"))
    check(bd.LAUNCHES == bit_counts(4, 0, 0, 0),
          f"export launches {bd.LAUNCHES}")
    check_artifact(art)
    log(f"  export_serving(trainer): {t_export:.3f} s [{card}]")
    check_queries(art, card, "trained parameters")
    return launches, dict(step_ms=step_ms, first_step_ms=t_first * 1e3,
                          prep_ms=prep_ms, device_busy_ms=busy_ms,
                          peak_gib=peak_gb, fit_s=t_fit,
                          repeat_spread_all=spread[0],
                          repeat_spread_worst=spread[1])


def compare_grads(ref, other):
    """``(loss rel diff, worst single-parameter diff over its largest
    entry, that parameter, all gradients together relative)`` of
    ``other = (stats, grads)`` against ``ref``."""
    (r_stats, r_grads), (o_stats, o_grads) = ref, other
    loss_rel = abs(float(o_stats["loss"]) - float(r_stats["loss"])) \
        / abs(float(r_stats["loss"]))
    worst, worst_name, diff2, norm2 = 0.0, "", 0.0, 0.0
    for name, rg in r_grads.items():
        scale = float(rg.abs().max())
        check(scale > 0, f"zero gradient for {name}")
        rel = float((o_grads[name] - rg).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, name
        diff2 += float((o_grads[name] - rg).double().pow(2).sum())
        norm2 += float(rg.double().pow(2).sum())
    return loss_rel, worst, worst_name, (diff2 / norm2) ** 0.5


# Phase 13 (a)'s host-fed repeats of one step: the step's ``index_add_``
# adds with atomics, so repeats differ, and two repeats gave too narrow a
# spread (one run read 1.546e-4 against a bound of 7.6e-5).
HOST_FED_REPEATS = 12


def held_to_repeats(reps, got, eps=(1e-7, 1e-6, 1e-7)):
    """Phase 17's rule for a step with more than one outcome: ``got``
    (``(stats, grads)``) against the nearest of the repeats ``reps`` of
    the same step, within twice the largest difference between two of them
    plus ``eps``, for (loss, worst single parameter, all gradients
    together).  Returns ``(ok, compare_grads against the nearest, the
    tolerances, the repeats' spread, the nearest repeat's index)``."""
    pairs = [compare_grads(a, b) for i, a in enumerate(reps)
             for b in reps[i + 1:]]
    spread = [max([x[k] for x in pairs], default=0.0) for k in (0, 1, 3)]
    tol = [2 * w + e for w, e in zip(spread, eps)]
    fits = [compare_grads(r, got) for r in reps]
    i = min(range(len(fits)), key=lambda j: max(
        fits[j][0] / tol[0], fits[j][1] / tol[1], fits[j][3] / tol[2]))
    fit = fits[i]
    ok = fit[0] <= tol[0] and fit[1] <= tol[1] and fit[3] <= tol[2]
    return ok, fit, tol, spread, i


def run_training16_slice(bd, trainer, t16, card, numbers):
    """Phase 6b: the ``KERNEL.BIT_IMPL: pallas16`` trainer ``t16`` (same
    data iterator, row-interleaved packs) on the parameters ``trainer``
    holds.  Returns the launch counts of its step and of its export."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import export_serving

    it, s = trainer.data_iter, trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    batch = next_batches(trainer, rating_sampler, recon_sampler)
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    t16.model.load_state_dict(params0)
    t16.opt.load_state_dict(opt0)

    # (a) one step through the entry point: counts from 0, then read.
    t16.seed_dropout(SEED)
    zero_launches(bd)
    stats, t_first = host_s(lambda: t16.train_iteration(*batch))
    launches = dict(bd.LAUNCHES)
    log(f"  first pallas16 train_iteration: {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, launches {launches} [{card}]")
    check(launches == bit_counts(0, 0, 4, 4),
          f"expected 4 + 4 16-bit launches and no natural bit kernel in a "
          f"pallas16 step, got {launches}")

    # (b) the same batch, parameters and dropout masks through both
    # trainers; the pallas trainer's own repeats give the spread.
    t16.model.load_state_dict(params0)
    runs = {}
    for name, owner in (("pallas", trainer), ("pallas16", t16),
                        ("pallas again", trainer)):
        owner.seed_dropout(SEED)
        runs[name] = owner.loss_and_grads(*batch)
    rep = compare_grads(runs["pallas"], runs["pallas again"])
    loss_rel, worst, worst_name, glob = compare_grads(runs["pallas"],
                                                      runs["pallas16"])
    del runs
    log(f"  pallas16 step against the pallas step (same parameters, batch "
        f"and dropout masks): loss rel diff {loss_rel:.3e} (tol 1e-5), all "
        f"gradients together {glob:.3e} relative (tol 1e-3), worst single "
        f"parameter {worst:.3e} of its largest entry ({worst_name}; tol "
        f"5e-2); the pallas step against itself {rep[3]:.3e} / {rep[1]:.3e}, "
        f"phase 6's repeats up to {numbers['repeat_spread_all']:.3e} / "
        f"{numbers['repeat_spread_worst']:.3e}.  The bit kernels of the two "
        f"routes give the same bits; index_add_ and the row gather's "
        f"backward use atomics")
    check(loss_rel <= 1e-5 and glob <= 1e-3 and worst <= 5e-2,
          "the pallas16 step disagrees with the pallas step")

    # Steady steps of the two routes in turns, host clock.
    times = {"pallas": [], "pallas16": []}
    for _ in range(3):
        for name, owner in (("pallas", trainer), ("pallas16", t16)):
            b = next_batches(owner, rating_sampler, recon_sampler)
            _, t = host_s(lambda: owner.train_iteration(*b))
            times[name].append(t * 1e3)
    step_ms = {k: median(v) for k, v in times.items()}
    log(f"  train_iteration in turns, 3 each: pallas "
        f"{', '.join(f'{t:.1f}' for t in times['pallas'])} ms, pallas16 "
        f"{', '.join(f'{t:.1f}' for t in times['pallas16'])} ms [{card}]")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # (c) fit: 10 steps, one validation, checkpoints (save id 2).
    t16.model.load_state_dict(params0)
    t16.opt.load_state_dict(opt0)
    t16.seed_dropout(SEED)
    lines = []
    zero_launches(bd)
    summary, t_fit = host_s(lambda: t16.fit(max_iter=10, log=lines.append))
    fit_launches = dict(bd.LAUNCHES)
    for line in lines:
        log(f"  fit: {line}")
    log(f"  pallas16 fit(max_iter=10): {t_fit:.2f} s with one validation "
        f"and one test evaluation; launches {fit_launches} [{card}]")
    eval_batches = -(-it.valid_node_pairs.shape[1] // s.rating_batch_size)
    check(fit_launches["bit_reduce_matmul16"] == 40
          and fit_launches["bit_expand_matmul16"] >= 40 + 4 * eval_batches
          and fit_launches["bit_expand_matmul"] == 0
          and fit_launches["bit_reduce_matmul"] == 0,
          f"pallas16 fit launch counts {fit_launches}")
    span = trainer.rating_max - trainer.rating_min
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] == 10 and np.isfinite(rmses).all()
          and 0 <= min(rmses) and max(rmses) <= span,
          f"pallas16 fit summary {summary}")

    # (d) its checkpoint loads into the pallas trainer.
    best = os.path.join(t16.save_dir, "ckpt_best_2.pt")
    check(os.path.exists(best), "pallas16 checkpoint")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    trainer.restore_checkpoint(best)
    for name, t in saved["params"].items():
        check(torch.equal(trainer.model.state_dict()[name].cpu(), t)
              and torch.equal(t16.model.state_dict()[name].cpu(), t),
              f"restored parameter {name} differs")
    check(trainer.opt.count == t16.opt.count, "restored optimizer step count")
    log(f"  restore_checkpoint({os.path.basename(best)}) into the pallas "
        f"trainer: parameters equal the pallas16 trainer's, optimizer at "
        f"step {trainer.opt.count}")

    # (e) export through the 16-bit kernel, against the pallas export of
    # the same parameters, then queries.
    zero_launches(bd)
    art16, t_export = host_s(lambda: export_serving(t16, segment="test"))
    export_launches = dict(bd.LAUNCHES)
    check(export_launches == bit_counts(0, 0, 4, 0),
          f"pallas16 export launches {export_launches}")
    art = export_serving(trainer, segment="test")
    check_artifact(art16)
    same = (np.array_equal(art16.user_feats, art.user_feats)
            and np.array_equal(art16.item_feats, art.item_feats))
    log(f"  export_serving(pallas16 trainer): {t_export:.3f} s, launches "
        f"{export_launches}; equal to the pallas export bit for bit: {same} "
        f"[{card}]")
    check(same, "the pallas16 export differs from the pallas export")
    check_queries(art16, card, "pallas16 export")
    numbers.update(pallas16_first_step_ms=t_first * 1e3,
                   pallas16_fit_s=t_fit,
                   steps_in_turns_ms=step_ms,
                   pallas16_vs_pallas=dict(loss_rel=loss_rel, all=glob,
                                           worst=worst))
    return {"pallas16 train_iteration": launches,
            "pallas16 export": export_launches}


def run_pallas16_cli(bd, card, save_dir):
    """Phase 6b (f): ``python -m stargcn_tpu_torch.train``'s entry point,
    in this process, with a YAML that is ``transductive_ml_10m.yml`` plus
    ``KERNEL.BIT_IMPL: pallas16`` on the CLI's synthetic graph (943 x 1682
    users x items, batch cut to 10,000 ratings), 10 steps and one
    validation.  Returns its launch counts."""
    import logging

    import numpy as np
    import yaml

    from stargcn_tpu_torch.train import __main__ as train_cli

    with open(os.path.join(ROOT, "configs", "transductive_ml_10m.yml")) as f:
        doc = yaml.safe_load(f)
    doc.setdefault("KERNEL", {})["BIT_IMPL"] = "pallas16"
    doc["TRAIN"]["RATING_BATCH_SIZE"] = 10_000
    cfg_path = os.path.join(save_dir, "pallas16.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(doc, f)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    zero_launches(bd)
    try:
        result, t_cli = host_s(lambda: train_cli.main([
            "--cfg", cfg_path, "--dataset", "synthetic", "--backend",
            "bitdense", "--save_dir", os.path.join(save_dir, "cli16"),
            "--max_iter", "10", "--silent", "--device", DEVICE]))
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    launches = dict(bd.LAUNCHES)
    log(f"  python -m stargcn_tpu_torch.train --cfg <transductive_ml_10m.yml "
        f"+ KERNEL.BIT_IMPL: pallas16> --dataset synthetic --max_iter 10: "
        f"{t_cli:.2f} s, best valid RMSE {result['best_valid_rmse']:.4f}, "
        f"launches {launches} [{card}]")
    check(result["best_iter"] == 10
          and np.isfinite(result["best_valid_rmse"]),
          f"pallas16 CLI result {result}")
    check(launches["bit_reduce_matmul16"] == 40
          and launches["bit_expand_matmul16"] >= 44
          and launches["bit_expand_matmul"] == 0
          and launches["bit_reduce_matmul"] == 0,
          f"pallas16 CLI launch counts {launches}")
    return launches


# ------------------------------ ELL kernels ------------------------------

ELL_NAMES = ("ell_spmm_fwd_only", "ell_spmm_transpose", "ell_sddmm")


def ell_errs(ek, values, idx, w, g):
    """Max abs error of each ELL kernel against its plain version on the
    same inputs, and the tolerance: 1e-5 of the largest output (all f32,
    the same products summed in another order)."""
    import torch

    num_src = values.shape[0]
    pairs = {
        "ell_spmm_fwd_only": (ek.ell_spmm_fwd_only(values, idx, w),
                              ek.plain_ell_spmm(values, idx, w)),
        "ell_spmm_transpose": (
            ek.ell_spmm_transpose(g, idx, w, num_src),
            ek.plain_ell_spmm_transpose(g, idx, w, num_src)),
        "ell_sddmm": (ek.ell_sddmm(g, values, idx),
                      ek.plain_ell_sddmm(g, values, idx)),
    }
    torch.cuda.synchronize()
    out = {}
    for name, (got, want) in pairs.items():
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name}: shape or non-finite output")
        scale = max(float(want.abs().max()), 1.0)
        out[name] = (float((got - want).abs().max()), 1e-5 * scale)
    return out


# The kernels of ops/csrc/ell_spmm_t.cu: the ordering, then the sum (the
# output's memset and ell_t_sum).
ORDER_KERNELS = ("ell_t_clear", "ell_t_count", "ell_t_scan_reduce",
                 "ell_t_scan_apply", "ell_t_place", "ell_t_sort_short",
                 "ell_t_sort_long")
SUM_KERNEL = "ell_t_sum"


def transpose_split(ek, g, idx, w, num_src, calls=10, tries=3):
    """The profiler's device time of one ``ell_spmm_transpose`` call, split
    by kernel name into the ordering (``ORDER_KERNELS``), the sum (the
    memset and ``SUM_KERNEL``) and anything else (which should be nothing):
    each entry's time over the records the trace holds of it, as
    ``device_ms_per_call`` counts them.  None where no trace shows device
    time."""
    for _ in range(tries):
        events = device_events(lambda: [
            ek.ell_spmm_transpose(g, idx, w, num_src) for _ in range(calls)])
        if not events:
            continue
        split = {"order": 0.0, "sum": 0.0, "other": 0.0, "other_names": []}
        for name, ms, count in events:
            part = ("sum" if SUM_KERNEL in name or "memset" in name.lower()
                    else "order" if any(k in name for k in ORDER_KERNELS)
                    else "other")
            split[part] += ms / max(count, 1)
            if part == "other":
                split["other_names"].append(name)
        return split
    return None


def order_check(ek, idx, w, num_src, what, short_run=None):
    """``order_slots`` against ``sort_slots`` with ``torch.equal``:
    ``seg_ptr`` whole, ``dst_sorted`` and ``w_sorted`` over the live slots
    (the entries past ``seg_ptr[-1]`` are left unset by the kernels).
    Returns the run lengths."""
    import torch

    kw = {} if short_run is None else {"short_run": short_run}
    got = ek.order_slots(idx, w, num_src, **kw)
    want = ek.sort_slots(idx, w, num_src)
    torch.cuda.synchronize()
    live = int(want[0][-1])
    same = torch.equal(got[0], want[0]) and all(
        torch.equal(a[:live], b[:live]) for a, b in zip(got[1:], want[1:]))
    check(same, f"order_slots differs from sort_slots ({what}, short_run "
                f"{kw.get('short_run', ek.SHORT_RUN)})")
    return want[0][1:] - want[0][:-1]


def transpose_check(ek, g, idx, w, num_src, what):
    """The transpose against its plain version run in float64 (1e-5 of the
    largest output: a run of 100,000 slots sums that many float32 terms,
    and two float32 orders of it differ by more) and against a second
    launch (the same bits).  Returns the error."""
    import torch

    got = ek.ell_spmm_transpose(g, idx, w, num_src)
    again = ek.ell_spmm_transpose(g, idx, w, num_src)
    want = ek.plain_ell_spmm_transpose(g.double(), idx, w.double(),
                                       num_src).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = 1e-5 * max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and err <= tol, f"ell_spmm_transpose disagrees ({what}): "
                          f"{err:.3e} > {tol:.3e}")
    check(torch.equal(got, again),
          f"ell_spmm_transpose does not repeat bit for bit ({what})")
    return err


def small_order_checks(ek):
    """The ordering on the card (``order_slots``) equal to ``sort_slots``,
    at the switch between its two ways of ordering a run, at a switch that
    sends every run of two or more slots to the block-wide way and one
    that sends every run to the thread-wide way, and the transpose against
    its plain version, on the cases that stress the ordering.  Returns the
    transpose's worst error."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 7)
    S = ek.SHORT_RUN
    dev = dict(device=DEVICE)
    cases = []
    # one source holding a run of 100,000 live slots
    idx = rng.randint(0, 50, (12_500, 8))
    idx[:, :] = 7
    cases.append(("a run of 100,000 slots", idx, rng.randn(12_500, 8), 50,
                  65))
    # runs of S - 1, S and S + 1 live slots, beside short runs
    for n in (S - 1, S, S + 1):
        idx = rng.randint(0, 400, (600, 8))
        idx[idx == 3] = 4
        idx.reshape(-1)[rng.choice(4800, n, replace=False)] = 3
        w = rng.randn(600, 8)
        w[w == 0] = 1.0
        cases.append((f"a run of {n} slots", idx, w, 400, 250))
    # 870,400 sources, a handful of live slots
    idx = rng.randint(0, 870_400, (40, 8))
    w = np.zeros((40, 8))
    w.reshape(-1)[rng.choice(320, 6, replace=False)] = rng.randn(6)
    cases.append(("870,400 sources, 6 live slots", idx, w, 870_400, 65))
    # every slot dead: weight 0 or index out of range
    idx = rng.randint(-100, 200, (300, 8))
    w = np.where((idx >= 0) & (idx < 100), 0.0, rng.randn(300, 8))
    cases.append(("every slot dead", idx, w, 100, 250))
    # 1,120,000 slots: the block-wide order's bitmap takes 9 windows
    idx = rng.randint(0, 1000, (140_000, 8))
    idx[rng.rand(140_000, 8) < 0.1] = 5
    cases.append(("1,120,000 slots, 9 bitmap windows", idx,
                  rng.randn(140_000, 8), 1000, 8))
    worst = 0.0
    for what, idx, w, ns, F in cases:
        ti = torch.tensor(idx.astype(np.int32), **dev)
        tw = torch.tensor(w.astype(np.float32), **dev)
        runs = order_check(ek, ti, tw, ns, what)
        longest = int(runs.max())
        order_check(ek, ti, tw, ns, what, short_run=1)
        if longest <= 20_000:   # the thread-wide way is O(n^2) a run
            order_check(ek, ti, tw, ns, what, short_run=2**30)
        g = torch.tensor(rng.randn(idx.shape[0], F).astype(np.float32),
                         **dev)
        err = transpose_check(ek, g, ti, tw, ns, what)
        worst = max(worst, err)
        log(f"  ELL ordering, {what}: nd={idx.shape[0]} K={idx.shape[1]} "
            f"ns={ns}, {int(runs.sum())} live slots, longest run "
            f"{longest}: order_slots equal to sort_slots (short_run "
            f"{S}, 1 and {'2^30' if longest <= 20_000 else '-'}); "
            f"transpose F={F} {err:.2e}, repeats bit for bit")
    return worst


def small_ell_checks(ek):
    """``{kernel name: worst max abs error}`` over the small cases."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 3)
    worst = dict.fromkeys(ELL_NAMES, 0.0)
    cases = [(200, 150, K, F, "padded slots hold any index")
             for K in (1, 8, 32) for F in (1, 65, 250, 256)]
    cases += [(5, 1, 3, 7, "one source row"),
              (3000, 10, 8, 250, "rows repeat a source"),
              (300, 90, 8, 1030, "several column passes"),
              (200, 150, 8, 65, "matrices start off a 16-byte boundary"),
              (200, 150, 8, 250, "matrices start off a 16-byte boundary")]
    for nd, ns, K, F, what in cases:
        idx = rng.randint(0, ns, (nd, K))
        w = rng.randn(nd, K).astype(np.float32)
        pad = rng.rand(nd, K) < 0.3
        w[pad] = 0.0
        if ns > 1:
            # padded slots: any index, in range or far outside it
            idx[pad] = rng.randint(-5 * ns, 6 * ns, int(pad.sum()))
            # and a few live slots out of range: they contribute nothing
            idx[rng.rand(nd, K) < 0.05] = ns + 2
        if "repeat" in what:
            idx[:nd // 2] = 3
        dev = dict(device=DEVICE)
        values = torch.tensor(rng.randn(ns, F).astype(np.float32), **dev)
        g = torch.tensor(rng.randn(nd, F).astype(np.float32), **dev)
        if "boundary" in what:
            # a slice of a batch, F * 4 bytes into its buffer: aligned to
            # the kernels' vector load (4 or 8 bytes here), not to 16
            values = torch.cat([values[:1], values])[1:]
            g = torch.cat([g[:1], g])[1:]
            check(values.data_ptr() % 16 != 0 and values.is_contiguous(),
                  "the case should start off a 16-byte boundary")
        ti = torch.tensor(idx.astype(np.int32), **dev)
        tw = torch.tensor(w, **dev)
        errs = ell_errs(ek, values, ti, tw, g)
        order_check(ek, ti, tw, ns, what)
        order_check(ek, ti, tw, ns, what, short_run=1)
        transpose_check(ek, g, ti, tw, ns, what)
        log(f"  ELL nd={nd} ns={ns} K={K} F={F} ({what}): "
            + ", ".join(f"{n} {e:.2e} (tol {t:.2e})"
                        for n, (e, t) in errs.items()))
        for name, (err, tol) in errs.items():
            check(err <= tol, f"{name} disagrees (nd={nd} ns={ns} K={K} "
                              f"F={F}, {what})")
            worst[name] = max(worst[name], err)
    worst["ell_spmm_transpose"] = max(worst["ell_spmm_transpose"],
                                      small_order_checks(ek))
    return worst


def sddmm_check(ek, q, values, idx, what):
    """``ell_sddmm`` within 1e-5 of the largest output of
    ``plain_ell_sddmm``, repeated bit for bit, and slots of a row that name
    one index bit-equal.  Returns the error."""
    import torch

    got = ek.ell_sddmm(q, values, idx)
    again = ek.ell_sddmm(q, values, idx)
    want = ek.plain_ell_sddmm(q, values, idx)
    torch.cuda.synchronize()
    tol = 1e-5 * max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and err <= tol, f"ell_sddmm disagrees ({what}): {err:.3e} > "
                          f"{tol:.3e}")
    check(torch.equal(got, again),
          f"ell_sddmm does not repeat bit for bit ({what})")
    same = idx[:, :, None] == idx[:, None, :]
    bit_equal = got[:, :, None] == got[:, None, :]
    check(bool((bit_equal | ~same).all()),
          f"ell_sddmm: slots naming one index differ ({what})")
    return err


def small_sddmm_checks(ek):
    """``ell_sddmm`` on the cases of its design (K = 1, 3, 8, 15, 33 and F
    = 1, 64, 65, 250, 600; rows that repeat indices; a row whose slots all
    name one index; negative and too-large indices; every slot padded).
    Returns the worst error."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 8)
    ns = 150
    cases = [(200, K, F, "mixed") for K in (1, 3, 8, 15, 33)
             for F in (1, 64, 65, 250, 600)]
    cases += [(64, 8, 250, "a row's slots all name one index"),
              (64, 33, 64, "a row's slots all name one index"),
              (64, 15, 250, "negative and too-large indices"),
              (64, 8, 250, "every slot padded (row 0)"),
              (64, 15, 65, "every slot out of range")]
    worst = 0.0
    for nd, K, F, what in cases:
        idx = rng.randint(0, ns, (nd, K))
        if what == "mixed":
            idx[rng.rand(nd, K) < 0.3] = 0          # the planner's padding
            idx[::5] = rng.randint(0, 3, idx[::5].shape)  # repeats
            out = rng.rand(nd, K) < 0.1
            idx[out] = rng.choice([-1, 1], int(out.sum())) * rng.randint(
                ns, 2**31 - 1, int(out.sum()))
        elif what.startswith("a row's"):
            idx[1::2] = idx[1::2, :1]
        elif what.startswith("negative"):
            idx[rng.rand(nd, K) < 0.5] = -1
            idx[rng.rand(nd, K) < 0.3] = ns
            idx[rng.rand(nd, K) < 0.1] = 2**31 - 1
            idx[rng.rand(nd, K) < 0.1] = -2**31
        elif what.startswith("every slot padded"):
            idx[:] = 0
        else:
            idx = rng.randint(ns, 4 * ns, (nd, K)) * rng.choice([-1, 1],
                                                               (nd, K))
        dev = dict(device=DEVICE)
        ti = torch.tensor(idx.astype(np.int32), **dev)
        q = torch.tensor(rng.randn(nd, F).astype(np.float32), **dev)
        values = torch.tensor(rng.randn(ns, F).astype(np.float32), **dev)
        err = sddmm_check(ek, q, values, ti, what)
        worst = max(worst, err)
        log(f"  ell_sddmm nd={nd} ns={ns} K={K} F={F} ({what}), plan "
            f"{ek.sddmm_plan(F)}: {err:.2e}, repeats bit for bit, repeated "
            f"indices bit-equal")
    return worst


def sddmm_leaders(idx, num_src):
    """The row gathers ``ell_sddmm`` makes on a block: each row's distinct
    in-range indices (the kernel computes each once), in all and as a count
    of rows by how many a row has."""
    import torch

    ok = (idx >= 0) & (idx < num_src)
    key, _ = torch.sort(torch.where(ok, idx, -1), dim=1)
    first = torch.ones_like(ok)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    per_row = (first & (key >= 0)).sum(dim=1)
    counts = torch.bincount(per_row, minlength=idx.shape[1] + 1)
    return dict(leaders=int(per_row.sum()),
                rows_by_leaders={n: int(c) for n, c in
                                 enumerate(counts.tolist()) if c})


def sddmm_narrow_case(ek, card):
    """``ell_sddmm`` at ``seg_take_k_corr_pallas``'s shapes (phase 8's
    case, batch entry 0: 6000 segments of 0 to 15 neighbors, F = 64):
    checked against its plain version and timed beside its bound."""
    import torch

    from stargcn_tpu_torch.ops.ell import ell_from_csr

    e1, e2, nids, indptr = seg_take_k_corr_case(DEVICE)
    ell = ell_from_csr(indptr)
    idx = torch.from_numpy(nids[ell.slot_edge]).to(DEVICE)
    q, values = e1[0].contiguous(), e2[0].contiguous()
    err = sddmm_check(ek, q, values, idx, "seg_take_k_corr_pallas's case")
    num_dst, K = idx.shape
    F = values.shape[1]
    rows = int(torch.unique(idx).numel())
    bound, by = ell_bound(4 * F * (num_dst + rows) + 8 * num_dst * K,
                          2 * num_dst * K * F)
    ms = cuda_ms(lambda: ek.ell_sddmm(q, values, idx), reps=50)
    device = device_ms_per_call(lambda: ek.ell_sddmm(q, values, idx))
    plain = cuda_ms(lambda: ek.plain_ell_sddmm(q, values, idx), reps=5)
    out = dict(idx=[num_dst, K], values=list(values.shape),
               plan=list(ek.sddmm_plan(F)), max_abs_err=err, ms=ms,
               device_ms=device, plain_ms=plain, bound_ms=bound,
               bound_by=by)
    log(f"  ell_sddmm at seg_take_k_corr_pallas's shapes, idx ({num_dst}, "
        f"{K}), values {tuple(values.shape)}, plan {out['plan']}: "
        f"{ms:.4f} ms a call back to back, device {_ms_or_not(device)} "
        f"(profiler), bound {bound:.4f} ms ({by}), plain {plain:.3f} ms, "
        f"max_abs_err {err:.2e} [{card}]")
    return out


def ell_bound(nbytes, flops):
    """Least time for one launch: the bytes it must move at the HBM rate,
    or its f32 operations at the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def full_ell_checks(ek, blocks, R, F, card):
    """The three ELL kernels on real plan blocks of the sampled step, one
    per direction, at the main path's shapes: ``values`` is a projected
    frontier ``(R * n_src, F)``.  Returns ``(worst errors, shapes)``."""
    import torch
    import torch.nn.functional as Fn

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    worst = dict.fromkeys(ELL_NAMES, 0.0)
    shapes = {n: [] for n in ELL_NAMES}
    for direction, (idx, w, n_src) in blocks.items():
        num_dst, K = idx.shape
        num_src = R * n_src
        values = torch.randn(num_src, F, device=DEVICE, generator=gen)
        g = torch.randn(num_dst, F, device=DEVICE, generator=gen)
        what = (f"into {direction}: idx ({num_dst}, {K}), values "
                f"({num_src}, {F})")
        runs = order_check(ek, idx, w, num_src, what)
        order_check(ek, idx, w, num_src, what, short_run=1)
        lengths = runs[runs > 0]
        edges = (1, 8, 32, 256, 1024, 4096)
        hist = []
        for lo, hi in zip((0,) + edges, edges + (2**31,)):
            sel = lengths[(lengths > lo) & (lengths <= hi)]
            hist.append(f"({lo}, {hi if hi < 2**31 else 'inf'}]: "
                        f"{int(sel.numel())} runs, {int(sel.sum())} slots")
        longest = int(lengths.max()) if lengths.numel() else 0
        log(f"  ordering {what}: order_slots equal to sort_slots (short_run "
            f"{ek.SHORT_RUN} and 1); {int(lengths.numel())} non-empty runs "
            f"of {num_src}, longest {longest}; run lengths "
            + "; ".join(hist))
        for name, (err, tol) in ell_errs(ek, values, idx, w, g).items():
            log(f"  full-size check {name} {what}: max_abs_err={err:.3e} "
                f"tol={tol:.3e}")
            check(err <= tol, f"{name} disagrees at full size ({what})")
            worst[name] = max(worst[name], err)
        for name, call in (
                ("ell_spmm_fwd_only",
                 lambda: ek.ell_spmm_fwd_only(values, idx, w)),
                ("ell_spmm_transpose",
                 lambda: ek.ell_spmm_transpose(g, idx, w, num_src)),
                ("ell_sddmm", lambda: ek.ell_sddmm(g, values, idx))):
            check(torch.equal(call(), call()),
                  f"{name} does not repeat bit for bit ({what})")
        sddmm_check(ek, g, values, idx, what)

        # <spmm(v), g> = <v, spmm_t(g)>, sums in float64.
        lhs = float((ek.ell_spmm_fwd_only(values, idx, w).double()
                     * g.double()).sum())
        rhs = float((ek.ell_spmm_transpose(g, idx, w, num_src).double()
                     * values.double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        log(f"  adjoint {what}: <spmm(v), g> = {lhs:.6f}, <v, spmm_t(g)> = "
            f"{rhs:.6f}, rel diff {rel:.3e} (tol 1e-5)")
        check(rel <= 1e-5, f"ELL adjoint identity fails ({what})")

        # ell_spmm forward + backward with both gradients against plain
        # autograd: the weight gradient launches ell_sddmm at these shapes.
        before = dict(ek.LAUNCHES)
        got, want = [], []
        for fn, dst in ((ek.ell_spmm, got), (ek.plain_ell_spmm, want)):
            v = values.clone().requires_grad_()
            ww = w.clone().requires_grad_()
            out = fn(v, idx, ww)
            dst.extend([out.detach(),
                        *torch.autograd.grad(out, (v, ww), g)])
        check([ek.LAUNCHES[n] - before[n] for n in ELL_NAMES] == [1, 1, 1],
              "ell_spmm with a weight gradient should launch each kernel "
              "once")
        in_range = ((idx >= 0) & (idx < num_src)).float()
        for label, a, b in zip(("out", "d_values", "d_weight"), got, want):
            if label == "d_weight":
                # the kernel scores every slot, plain autograd only those
                # in range (the plan's padded slots all are)
                a = a * in_range
            err = float((a - b).abs().max())
            tol = 1e-5 * max(float(b.abs().max()), 1.0)
            log(f"  ell_spmm autograd {what}: {label} max_abs_err="
                f"{err:.3e} tol={tol:.3e}")
            check(err <= tol, f"ell_spmm {label} disagrees with plain "
                              f"autograd ({what})")
        del got, want

        # Times per launch, bounds and the library call.
        live = (w != 0) & (idx >= 0) & (idx < num_src)
        n_live = int(live.sum())
        src_rows = int(torch.unique(idx[live]).numel())
        src_rows_all = int(torch.unique(
            idx[(idx >= 0) & (idx < num_src)]).numel())
        dst_rows = int(live.any(dim=1).sum())
        slots = num_dst * K
        bounds = {
            # distinct source rows once, indices and weights, the output
            "ell_spmm_fwd_only": ell_bound(
                4 * F * src_rows + 8 * slots + 4 * F * num_dst,
                2 * n_live * F),
            # cotangent rows of destinations with a live slot, indices and
            # weights, every output row (zeros included)
            "ell_spmm_transpose": ell_bound(
                4 * F * dst_rows + 8 * slots + 4 * F * num_src,
                2 * n_live * F),
            # every slot is scored: q once, distinct rows once, indices,
            # the output
            "ell_sddmm": ell_bound(
                4 * F * num_dst + 4 * F * src_rows_all + 4 * slots
                + 4 * slots, 2 * slots * F),
        }
        # The transpose's device time split by kernel name, and the
        # ordering's device time at other switches between its two ways
        # of ordering a run.
        split = transpose_split(ek, g, idx, w, num_src)
        check(split is not None and split["other"] == 0.0,
              f"ell_spmm_transpose ran another kernel: {split}")
        order_by_switch = {
            sr: device_ms_per_call(lambda: ek.order_slots(
                idx, w, num_src, short_run=sr), calls=10)
            for sr in (64, 128, 256, 512, 1024)}
        sort_slots_ms = cuda_ms(lambda: ek.sort_slots(idx, w, num_src),
                                reps=20)
        sddmm_runs = [device_ms_per_call(
            lambda: ek.ell_sddmm(g, values, idx)) for _ in range(3)]
        sddmm_runs = [t for t in sddmm_runs if t is not None]
        sddmm_device = median(sddmm_runs) if sddmm_runs else None
        leaders = sddmm_leaders(idx, num_src)
        kernel_ms = {
            "ell_spmm_fwd_only": cuda_ms(
                lambda: ek.ell_spmm_fwd_only(values, idx, w), reps=20),
            "ell_spmm_transpose": cuda_ms(
                lambda: ek.ell_spmm_transpose(g, idx, w, num_src), reps=20),
            "ell_sddmm": cuda_ms(
                lambda: ek.ell_sddmm(g, values, idx), reps=20),
        }
        plain_ms = {
            "ell_spmm_fwd_only": cuda_ms(
                lambda: ek.plain_ell_spmm(values, idx, w), reps=3),
            "ell_spmm_transpose": cuda_ms(
                lambda: ek.plain_ell_spmm_transpose(g, idx, w, num_src),
                reps=3),
            "ell_sddmm": cuda_ms(
                lambda: ek.plain_ell_sddmm(g, values, idx), reps=3),
        }
        # The library's call for the same function, timed only: the
        # plan's indices are all in range, as embedding_bag needs them.
        check(bool(((idx >= 0) & (idx < num_src)).all()),
              "a plan block holds an out-of-range index")
        idx64 = idx.long()
        v = values.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        bag = Fn.embedding_bag(idx64, v, per_sample_weights=ww, mode="sum")
        library_ms = {
            "ell_spmm_fwd_only": cuda_ms(lambda: Fn.embedding_bag(
                idx64, values, per_sample_weights=w, mode="sum"), reps=10),
            "ell_spmm_transpose": cuda_ms(lambda: torch.autograd.grad(
                bag, v, g, retain_graph=True), reps=5),
            "ell_sddmm": cuda_ms(lambda: torch.autograd.grad(
                bag, ww, g, retain_graph=True), reps=5),
        }
        lib_err = float((bag.detach()
                         - ek.ell_spmm_fwd_only(values, idx, w)).abs().max())
        check(lib_err <= 1e-4, "embedding_bag computes another function")
        del bag, v, ww
        for name in ELL_NAMES:
            bms, by = bounds[name]
            row = dict(direction=direction, idx=[num_dst, K],
                       values=[num_src, F], live_slots=n_live,
                       distinct_source_rows=src_rows, ms=kernel_ms[name],
                       plain_ms=plain_ms[name], bound_ms=bms, bound_by=by,
                       library_ms=library_ms[name])
            extra = ""
            if name == "ell_spmm_transpose":
                row.update(order_ms=split["order"], sum_ms=split["sum"],
                           longest_run=longest,
                           order_slots_ms_by_short_run=order_by_switch,
                           sort_slots_ms=sort_slots_ms)
                extra = (f" (profiler, a call: ordering {split['order']:.4f} "
                         f"ms, sum {split['sum']:.4f} ms; order_slots alone "
                         f"by short_run (profiler) "
                         + ", ".join(f"{k} {_ms_or_not(v)}"
                                     for k, v in order_by_switch.items())
                         + f"; the plain sort_slots {sort_slots_ms:.4f} ms)")
            if name == "ell_sddmm":
                row.update(plan=list(ek.sddmm_plan(F)),
                           device_ms=sddmm_device, **leaders)
                extra = (f", {bms / kernel_ms[name]:.1%} of the bound, plan "
                         f"{row['plan']}, {leaders['leaders']} row gathers "
                         f"(distinct in-range indices of a row; rows by their "
                         f"count {leaders['rows_by_leaders']}); device "
                         f"{_ms_or_not(sddmm_device)} a call by the "
                         f"profiler (median of three)")
            shapes[name].append(row)
            log(f"  {name} {what}, {n_live} live slots over {src_rows} "
                f"distinct source rows: kernel {kernel_ms[name]:.4f} "
                f"ms/launch{extra}, plain {plain_ms[name]:.3f} ms, library "
                f"{library_ms[name]:.3f} ms, bound {bms:.4f} ms ({by}) "
                f"[{card}]")
    return worst, shapes


def seg_take_k_corr_case(device):
    """Inputs of ``seg_take_k_corr_pallas`` at a moderate size: 2 x 6000
    segments of 0 to 15 neighbors over 4000 nodes, 64 features."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 5)
    deg = rng.randint(0, 16, 6000)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    nids = rng.randint(0, 4000, int(indptr[-1])).astype(np.int32)
    e1 = torch.tensor(rng.randn(2, 6000, 64).astype(np.float32),
                      device=device)
    e2 = torch.tensor(rng.randn(2, 4000, 64).astype(np.float32),
                      device=device)
    return e1, e2, nids, indptr


# ----------------------------- sampled slice -----------------------------


@contextlib.contextmanager
def plain_ell_versions(ek):
    """While open, the sampled forward pools through ``plain_ell_spmm``
    (ordinary autograd) instead of the kernels."""
    real = ek.ell_spmm
    ek.ell_spmm = ek.plain_ell_spmm
    try:
        yield
    finally:
        ek.ell_spmm = real


def median(xs):
    return sorted(xs)[len(xs) // 2]


def time_sampled_steps(strainer, rs, recon, n):
    """Median milliseconds of ``n`` steps, split into the host's plan
    build, pack, the two copies, and the device step."""
    import torch

    from stargcn_tpu_torch.train import sampled_loop

    rows = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = strainer._build_batch_safe(rs, recon)
        t1 = time.perf_counter()
        packed = strainer._pack_batch(batch)
        t2 = time.perf_counter()
        feed = strainer._feed(packed)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        sampled_loop._loss_update(strainer, feed)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rows.append([(b - a) * 1e3 for a, b in
                     ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t0, t4))])
    names = ("plan_ms", "pack_ms", "copy_ms", "device_step_ms", "step_ms")
    return {k: median([r[i] for r in rows]) for i, k in enumerate(names)}, \
        packed


def plan_arrays(plan):
    """Every array of a ``SampledBlocks``, in one order: frontiers, each
    block's indices, weights, ratings and real row count, target
    positions."""
    import numpy as np

    out = [f[t] for f in plan.frontiers for t in ("user", "item")]
    for lvl in plan.blocks:
        for t in ("user", "item"):
            b = lvl[t]
            out += [b.nbr_pos, b.weight, b.rating,
                    np.array([b.num_dst_real])]
    return out + [plan.target_pos["user"], plan.target_pos["item"]]


def plans_equal(a, b, weight_rtol=0.0):
    """Whether two plans hold the same arrays: bit for bit, the weights
    within ``weight_rtol`` (and 1e-7 absolute) where it is not 0."""
    import numpy as np

    xa, xb = plan_arrays(a), plan_arrays(b)
    if len(xa) != len(xb):
        return False
    for x, y in zip(xa, xb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if weight_rtol and x.dtype == np.float32:
            if not np.allclose(x, y, rtol=weight_rtol, atol=1e-7):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def native_plan_properties(sampler, plan, exclude_keys, removal_counts):
    """The contract of a plan at a fanout K below the degrees, held without
    a second planner: each real row's first ``min(deg, K)`` slots name
    edges of its row, none twice, with the edge's rating level; a row of
    degree at most K is whole; every other slot and padded row is zero; an
    excluded batch edge weighs 0 and every other edge ``1/sqrt(d_r d_c)``
    (``1/d_r`` without ``symm``) of the removal-adjusted degrees, within
    float32 rounding (rtol 1e-6).  Checks each and returns counts."""
    import numpy as np

    K = sampler.fanout
    ni_g = sampler._num_items_global
    counts = dict(live_slots=0, excluded_slots=0, whole_rows=0,
                  sampled_rows=0)
    for li, lvl in enumerate(plan.blocks):
        for t, other in (("user", "item"), ("item", "user")):
            blk, csr = lvl[t], sampler._csr[t]
            n = blk.num_dst_real
            src = plan.frontiers[li][other]
            rows = csr.rows_of(plan.frontiers[li + 1][t][:n]).astype(
                np.int64)
            deg = np.diff(csr.ind_ptr).astype(np.int64)[rows]
            take = np.minimum(deg, K)
            live = np.arange(K)[None, :] < take[:, None]
            what = f"level {li} {t}"
            for name, arr in (("weight", blk.weight), ("nbr_pos",
                              blk.nbr_pos), ("rating", blk.rating)):
                check(not arr[n:].any() and not arr[:n][~live].any(),
                      f"{what}: {name} of a padded row or slot is not 0")
            pos = blk.nbr_pos[:n][live]
            check(((pos >= 0) & (pos < (src >= 0).sum())).all(),
                  f"{what}: a slot names no real frontier node")
            col_of = np.full(int(csr.col_ids.max()) + 1, -1, np.int64)
            col_of[csr.col_ids] = np.arange(csr.col_ids.size)
            cols = col_of[src[pos]]
            check((cols >= 0).all(), f"{what}: a slot names no column")
            r = np.repeat(rows, take)
            ncols = csr.shape[1]
            keys = r * ncols + cols
            ekeys = (np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                               np.diff(csr.ind_ptr)) * ncols
                     + csr.end_points)
            order = np.argsort(ekeys, kind="stable")
            at = np.minimum(np.searchsorted(ekeys[order], keys),
                            ekeys.size - 1)
            check((ekeys[order][at] == keys).all(),
                  f"{what}: a slot names no edge of its row")
            check(np.unique(keys).size == keys.size,
                  f"{what}: a row takes one edge twice")
            e = order[at]
            check((blk.rating[:n][live] == sampler._rating_idx[t][e]).all(),
                  f"{what}: a slot's rating level is not its edge's")
            dr = sampler._row_deg[t][r].astype(np.float64)
            dc = sampler._col_deg[t][cols].astype(np.float64)
            excluded = np.zeros(keys.size, bool)
            if removal_counts is not None:
                dr = dr - removal_counts[t][r]
                dc = dc - removal_counts[other][cols]
            if exclude_keys is not None and exclude_keys.size:
                bkeys = r * ni_g + cols if t == "user" else cols * ni_g + r
                at = np.minimum(np.searchsorted(exclude_keys, bkeys),
                                exclude_keys.size - 1)
                excluded = exclude_keys[at] == bkeys
            if sampler.symm:
                want = np.where(dr * dc > 0,
                                1 / np.sqrt(np.maximum(dr * dc, 1)), 0.0)
            else:
                want = np.where(dr > 0, 1 / np.maximum(dr, 1), 0.0)
            want[excluded] = 0.0
            w = blk.weight[:n][live]
            check((w[excluded] == 0).all()
                  and np.allclose(w, want, rtol=1e-6, atol=0),
                  f"{what}: a slot's weight is not its edge's support")
            counts["live_slots"] += int(keys.size)
            counts["excluded_slots"] += int(excluded.sum())
            counts["whole_rows"] += int(((deg > 0) & (deg <= K)).sum())
            counts["sampled_rows"] += int((deg > K).sum())
    return counts


def native_plan_checks(it, model_cfg, caps, pairs, card):
    """Phase 8's checks of the native planner: at ML-10M, fanout 8, one
    plan's contract (``native_plan_properties``) and the same plan from
    the same seed at 1, 2 and 16 OpenMP threads; on a subgraph of 3,000
    users and 3,000 items (largest degree at most 3,000), at a fanout of
    its largest degree, the native plan equal to the loop planner's, with
    and without the batch's edges removed; the contract at fanout 8 on the
    first 300 users and every item, where rows of 1 to 8 edges are.
    Returns the numbers."""
    import numpy as np

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.graph.sampling import BlockSampler

    L = len(model_cfg.agg_units)
    g = it.train_graph
    sampler = BlockSampler(g, num_layers=L, fanout=8,
                           symm=model_cfg.agg_norm_symm, frontier_caps=caps,
                           planner="native")
    tu, ti = np.unique(pairs[0]), np.unique(pairs[1])
    keys, rem = sampler.removal_args(pairs[0], pairs[1])
    team0 = gk.set_omp_threads(0)
    plans, secs = {}, {}
    try:
        for n in (1, 2, 16):
            gk.set_omp_threads(n)
            gk.set_seed(SEED + 8)
            t0 = time.perf_counter()
            plans[n] = sampler.sample(tu, ti, exclude_keys=keys,
                                      removal_counts=rem)
            secs[n] = time.perf_counter() - t0
    finally:
        gk.set_omp_threads(team0)
    counts = native_plan_properties(sampler, plans[1], keys, rem)
    same = all(plans_equal(plans[1], plans[n]) for n in (2, 16))
    log(f"  native plan at fanout 8 (one sample, 2 levels): {counts}; the "
        f"same seed at 1 / 2 / 16 OpenMP threads "
        f"{'gives the same plan' if same else 'DIFFERS'} "
        f"({', '.join(f'{secs[n]:.3f}' for n in (1, 2, 16))} s on the host; "
        f"team cap {team0}) [{card}]")
    check(same, "the native plan depends on the OpenMP team size")
    check(counts["sampled_rows"] > 0 and counts["excluded_slots"] > 0,
          "the ML-10M plan should sample rows and exclude batch edges")
    del plans

    # The subgraph: degrees at most 3000, so a fanout of the largest
    # degree leaves nothing to chance.
    csr = g["user", "movie"]
    users = np.asarray(csr.row_ids[:3000], np.int32)
    items = np.asarray(csr.col_ids[:3000], np.int32)
    sub = g.sel_subgraph_by_id("user", users).sel_subgraph_by_id(
        "movie", items)
    ucsr = sub["user", "movie"]
    fan = int(max(np.diff(ucsr.ind_ptr).max(),
                  np.diff(sub["movie", "user"].ind_ptr).max()))
    check(0 < fan <= 4096, f"the subgraph's largest degree {fan}")
    sp = ucsr.node_pair_ids[:, ::max(1, ucsr.nnz // 1024)]
    equal = {}
    for remove in (False, True):
        got = {}
        for planner in ("native", "loop"):
            smp = BlockSampler(sub, num_layers=L, fanout=fan,
                               symm=model_cfg.agg_norm_symm,
                               frontier_caps={"user": users.size,
                                              "item": items.size},
                               planner=planner)
            kw = {}
            if remove:
                k, r = smp.removal_args(sp[0], sp[1])
                kw = dict(exclude_keys=k, removal_counts=r)
            got[planner] = smp.sample(np.unique(sp[0]), np.unique(sp[1]),
                                      **kw)
        equal[remove] = plans_equal(got["native"], got["loop"],
                                    weight_rtol=1e-6)
    log(f"  native plan against the loop planner on a {users.size} x "
        f"{items.size} subgraph "
        f"({ucsr.nnz} edges, {sp.shape[1]} batch pairs) at fanout {fan} "
        f"(its largest degree): equal without removal {equal[False]}, with "
        f"the batch's edges removed {equal[True]} (weights within rtol "
        f"1e-6)")
    check(all(equal.values()), "the native plan differs from the loop "
          "planner's at a fanout of the largest degree")

    # The first 300 users and every item: items rated by a few of them
    # have 1 to 8 edges, the users more; the contract at fanout 8 there
    # covers whole rows too.
    short = g.sel_subgraph_by_id("user", users[:300])
    smp = BlockSampler(short, num_layers=L, fanout=8,
                       symm=model_cfg.agg_norm_symm, planner="native")
    sp = short["user", "movie"].node_pair_ids[:, ::4]
    k, r = smp.removal_args(sp[0], sp[1])
    sub_counts = native_plan_properties(
        smp, smp.sample(np.unique(sp[0]), np.unique(sp[1]), exclude_keys=k,
                        removal_counts=r), k, r)
    log(f"  native plan at fanout 8 on the first 300 users and every item: "
        f"{sub_counts}")
    check(sub_counts["whole_rows"] > 0 and sub_counts["sampled_rows"] > 0,
          "that plan should keep short rows whole and sample the others")
    return dict(plan_s_by_threads={str(n): secs[n] for n in secs},
                properties=counts, subgraph_properties=sub_counts,
                subgraph_fanout=fan,
                subgraph_edges=int(ucsr.nnz))


def run_sampled_slice(bd, ek, cfg, it, model_cfg, full_trainer, save_dir,
                      card):
    """Phases 8 and 9.  Returns ``(launch counts of each driven path,
    worst kernel errors, per-kernel shapes, numbers)``."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.graph.sampling import BlockSampler
    from stargcn_tpu_torch.models.sampled import StackedPlan
    from stargcn_tpu_torch.ops.ell import (ell_from_csr,
                                           seg_take_k_corr_pallas)
    from stargcn_tpu_torch.train import (SampledTrainer, TrainSettings,
                                         sampled_loop)

    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    gk.set_seed(SEED)
    strainer, t_make = host_s(lambda: SampledTrainer(
        model_cfg, it, settings, fanout=8, backend="pallas", device=DEVICE,
        save_dir=save_dir, save_id=1))
    caps = dict(strainer.caps)
    log(f"  SampledTrainer (three samplers, caps probed from 4 plans, "
        f"parameters): {t_make:.2f} s; probed caps {caps}, batch "
        f"{strainer.train_batch}, recon caps {strainer.recon_cap}, "
        f"remove batch edges: {strainer.do_remove} [{card}]")
    check(strainer.do_remove and strainer.train_batch == 4096,
          "the sampled step should remove a batch of 4096 train edges")
    check(strainer.backend == strainer.eval_backend == "pallas",
          "backend")
    rs = it.rating_sampler(batch_size=strainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=settings.recon_batch_size)

    # One plan by each planner route, same pairs; the trainer's is the
    # native route.
    check(all(smp.planner == "native" for smp in strainer.samplers.values()),
          "SampledTrainer's default planner should be 'native'")
    pairs, _ = next(rs)
    plan_s = {}
    routes = ("native", "vectorised", "loop")
    for planner in routes:
        sampler = BlockSampler(
            it.train_graph, num_layers=len(model_cfg.agg_units), fanout=8,
            symm=model_cfg.agg_norm_symm, frontier_caps=caps,
            planner=planner)
        t0 = time.perf_counter()
        plan = StackedPlan.build(it.train_graph, model_cfg, pairs[0],
                                 pairs[1], fanout=8, sampler=sampler,
                                 exclude_pairs=(pairs[0], pairs[1]))
        plan_s[planner] = time.perf_counter() - t0
        sizes = [int((f[t] >= 0).sum()) for c in plan.chains
                 for f in c.frontiers for t in ("user", "item")]
        log(f"  one plan, {planner} planner: {plan_s[planner]:.3f} s on "
            f"the host; real frontier sizes (block, level, type) {sizes}")
    del plan, sampler
    log(f"  one plan (batch 4096, recon none, fanout 8, batch edges removed)"
        f" by route: " + ", ".join(f"{r} {plan_s[r]:.3f} s" for r in routes)
        + f"; vectorised / native {plan_s['vectorised'] / plan_s['native']:.2f}"
        f"x, loop / native {plan_s['loop'] / plan_s['native']:.2f}x "
        f"[{card}]")
    native_numbers = native_plan_checks(it, model_cfg, caps, pairs, card)

    batch = strainer._build_batch_safe(rs, recon)
    params0 = copy.deepcopy(strainer.model.state_dict())
    opt0 = copy.deepcopy(strainer.opt.state_dict())

    # ---- the main path: counts from 0, one step, counts read ----
    feed = strainer._feed(strainer._pack_batch(batch))
    R, F = model_cfg.num_links, model_cfg.agg_units[0]
    blocks = {}
    for t, src in (("user", "item"), ("item", "user")):
        blk = feed["plan"]["blocks"][0][0][t]
        blocks[t] = (blk["idx"].contiguous(), blk["weight"].contiguous(),
                     caps[src])
    strainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: strainer.train_iteration(batch))
    step_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  first sampled train_iteration: {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, gnorm {float(stats['gnorm']):.4f}, "
        f"launches {step_launches} [{card}]")
    check(step_launches == {"ell_spmm_fwd_only": 4, "ell_spmm_transpose": 4,
                            "ell_sddmm": 0, **bit_counts(0, 0, 0, 0)},
          f"expected 4 + 4 + 0 ELL launches and no bit kernel in a step, "
          f"got {step_launches}")

    # ---- ell_sddmm's two callers, each through its entry point with
    # counts from 0 of its own: no training step launches that kernel ----
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    idx_u, w_u, n_src_u = blocks["user"]
    values_u = torch.randn(R * n_src_u, F, device=DEVICE, generator=gen)
    g_u = torch.randn(idx_u.shape[0], F, device=DEVICE, generator=gen)
    w_req = w_u.clone().requires_grad_()
    zero_launches(bd, ek)
    (d_w,) = torch.autograd.grad(ek.ell_spmm(values_u, idx_u, w_req), w_req,
                                 g_u)
    torch.cuda.synchronize()
    wgrad_launches = dict(ek.LAUNCHES)
    e1, e2, nids, indptr = seg_take_k_corr_case(DEVICE)
    ell = ell_from_csr(indptr)
    zero_launches(bd, ek)
    corr = seg_take_k_corr_pallas(e1, e2, nids, ell)
    torch.cuda.synchronize()
    corr_launches = dict(ek.LAUNCHES)
    log(f"  ell_spmm forward and backward for its weights alone: launches "
        f"{wgrad_launches}; seg_take_k_corr_pallas: {corr_launches}")
    check(wgrad_launches == {"ell_spmm_fwd_only": 1, "ell_spmm_transpose": 0,
                             "ell_sddmm": 1},
          "ell_spmm's weight gradient should launch the forward and "
          "ell_sddmm once each")
    check(corr_launches == {"ell_spmm_fwd_only": 0, "ell_spmm_transpose": 0,
                            "ell_sddmm": e1.shape[0]},
          "seg_take_k_corr_pallas should launch ell_sddmm once per batch "
          "entry")
    launches_by_path = {"sampled train_iteration": step_launches,
                        "ell_spmm weight gradient": wgrad_launches,
                        "seg_take_k_corr_pallas": corr_launches}
    check(bool(torch.isfinite(stats["loss"])), "non-finite first loss")
    # what those two callers returned, against their plain versions
    want_dw = ek.plain_ell_sddmm(g_u, values_u, idx_u)
    err = float((d_w - want_dw).abs().max())
    check(err <= 1e-5 * max(float(want_dw.abs().max()), 1.0),
          "ell_spmm's weight gradient disagrees with plain_ell_sddmm")
    seg = torch.from_numpy(np.repeat(np.arange(indptr.size - 1),
                                     np.diff(indptr))).to(DEVICE)
    want_corr = (e1[:, seg] * e2[:, torch.from_numpy(nids).long().to(DEVICE)]
                 ).sum(-1)
    err = float((corr - want_corr).abs().max())
    log(f"  seg_take_k_corr_pallas (2 x {indptr.size - 1} segments, "
        f"{nids.size} edges, 64 features) against plain indexing: "
        f"max_abs_err={err:.3e} (tol 1e-4)")
    check(corr.shape == want_corr.shape and err <= 1e-4,
          "seg_take_k_corr_pallas disagrees")
    del values_u, g_u, d_w, want_dw, corr, want_corr, e1, e2, w_req

    # ---- the same step through the kernels and through a plain twin ----
    def fixed_batch():
        # forward and backward of the first batch, one dropout seed
        strainer.seed_dropout(SEED)
        return sampled_loop._loss_and_grads(
            strainer, strainer._feed(strainer._pack_batch(batch)))

    def one():
        strainer.model.load_state_dict(params0)
        return fixed_batch()

    (k_stats, k_grads), t_k = host_s(one)
    repeats = [one() for _ in range(3)]
    with plain_ell_versions(ek):
        before = dict(ek.LAUNCHES)
        (p_stats, p_grads), t_p = host_s(one)
        check(ek.LAUNCHES == before, "the plain twin launched a kernel")

    def compare(stats, grads):
        loss_rel = abs(float(k_stats["loss"]) - float(stats["loss"])) \
            / abs(float(stats["loss"]))
        worst, worst_name, diff2, norm2 = 0.0, "", 0.0, 0.0
        for name, pg in grads.items():
            scale = float(pg.abs().max())
            check(scale > 0, f"zero gradient for {name}")
            rel = float((k_grads[name] - pg).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, name
            diff2 += float((k_grads[name] - pg).double().pow(2).sum())
            norm2 += float(pg.double().pow(2).sum())
        return loss_rel, worst, worst_name, (diff2 / norm2) ** 0.5

    floor = [compare(*rep) for rep in repeats]
    log(f"  forward+backward through the kernels {t_k * 1e3:.1f} ms, "
        f"through the plain versions {t_p * 1e3:.1f} ms; the same step 3 "
        f"more times through the kernels, each against the first: all "
        f"gradients together {', '.join(f'{x[3]:.3e}' for x in floor)} "
        f"relative, worst single parameter "
        f"{', '.join(f'{x[1]:.3e}' for x in floor)} of its largest entry "
        f"(the ELL kernels repeat bit for bit; the row gathers' backward "
        f"and the library's products do not)")
    loss_rel, worst, worst_name, glob = compare(p_stats, p_grads)
    log(f"  kernels against the plain twin (f32 on both sides): loss rel "
        f"diff {loss_rel:.3e} (tol 1e-5), all gradients together "
        f"{glob:.3e} relative (tol 1e-4), worst single parameter "
        f"{worst:.3e} of its largest entry ({worst_name}; "
        f"{len(p_grads)} parameters; tol 1e-3)")
    check(loss_rel <= 1e-5 and glob <= 1e-4 and worst <= 1e-3,
          "the sampled step through the kernels disagrees with the plain "
          "twin")
    del k_grads, p_grads, repeats

    # ---- the step on the host clock, split; the xla backend beside it ----
    numbers = {"caps": caps, "first_step_ms": t_first * 1e3,
               "plan_native_s": plan_s["native"],
               "plan_vectorised_s": plan_s["vectorised"],
               "plan_loop_s": plan_s["loop"], "native_plan": native_numbers}
    for backend in ("pallas", "xla"):
        twin = copy.copy(strainer)
        twin.backend = backend
        twin.train_iteration(twin._build_batch_safe(rs, recon))   # warm-up
        split, packed = time_sampled_steps(twin, rs, recon, 5)
        feed_bytes = packed[0].nbytes + packed[1].nbytes
        b = twin._build_batch_safe(rs, recon)
        # the step's own peak: what one steady step allocates above what
        # the process already holds
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        twin.train_iteration(b)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - held
        events = device_events(lambda: twin.train_iteration(b))
        busy, by_name = device_busy_ms(None, top=10, events=events)
        if backend == "pallas":
            # No library sort, scan or search: the one scan a step runs
            # is the cumsum of the ordinal weights (models/sampled.py, as
            # in the reference), PyTorch's tensor_kernel_scan_*.
            library = [n for n, _, _ in events if "ell_t_" not in n and any(
                word in n.lower() for word in
                ("sort", "scan", "searchsorted", "radix", "cub::"))
                and "tensor_kernel_scan" not in n]
            sums = [c for n, _, c in events if SUM_KERNEL in n]
            log(f"    ell_spmm_t kernels in the step's trace: "
                + ", ".join(f"{c} x {n.split('::')[-1][:40]}"
                            for n, _, c in events if "ell_t_" in n)
                + "; other scans: "
                + (", ".join(f"{c} x {n[:60]}" for n, _, c in events
                             if "tensor_kernel_scan" in n) or "none")
                + f"; sort, scan or search kernels of a library: "
                  f"{library or 'none'}")
            check(not library and sums == [4],
                  "the step's transpose should run the port's ell_t_ "
                  "kernels only, 4 sums")
            # The step's 4 transposes again, on the step's own operands,
            # each split by the profiler into its ordering and its sum.
            calls, real_t = [], ek.ell_spmm_transpose

            def recording_t(*args):
                calls.append(args)
                return real_t(*args)

            ek.ell_spmm_transpose = recording_t
            try:
                twin.train_iteration(b)
            finally:
                ek.ell_spmm_transpose = real_t
            splits = [transpose_split(ek, *args) for args in calls]
            check(len(calls) == 4 and None not in splits,
                  "the step's 4 transposes")
            numbers["transpose_ms_by_call"] = [
                {"idx": list(args[1].shape), "num_src": args[3],
                 "order_ms": sp["order"], "sum_ms": sp["sum"]}
                for args, sp in zip(calls, splits)]
            log(f"    the step's 4 ell_spmm_transpose calls replayed on "
                f"their operands (profiler, ordering + sum a call): "
                + ", ".join(f"idx {tuple(a[1].shape)} -> {a[3]} rows: "
                            f"{sp['order']:.4f} + {sp['sum']:.4f} ms"
                            for a, sp in zip(calls, splits))
                + f"; {sum(sp['order'] + sp['sum'] for sp in splits):.4f}"
                  f" ms in all [{card}]")
            del calls
        numbers[backend] = {**split, "device_busy_ms": busy,
                            "feed_bytes": feed_bytes,
                            "step_peak_gib": step_peak / 2**30,
                            "held_before_step_gib": held / 2**30,
                            "device_ms_by_name": by_name}
        idle = ("not measured" if busy is None else
                f"{max(0.0, 1 - busy / split['step_ms']):.0%}")
        log(f"  sampled step, backend {backend!r}, median of 5: "
            f"{split['step_ms']:.1f} ms = plan {split['plan_ms']:.1f} + "
            f"pack {split['pack_ms']:.1f} + copy {split['copy_ms']:.1f} "
            f"({feed_bytes / 1e6:.1f} MB in two buffers) + device step "
            f"{split['device_step_ms']:.1f}; device busy "
            f"{'not measured' if busy is None else f'{busy:.1f} ms'} "
            f"(torch.profiler), card idle {idle} of the step [{card}]")
        log(f"    peak device memory of one steady step: "
            f"{step_peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB "
            f"held before it (both trainers' parameters and optimizer "
            f"state, the full-graph trainer's bit packs and pair map, this "
            f"step's blocks) [{card}]")
        for name, ms, calls in by_name:
            log(f"    {ms:8.3f} ms in {calls:3d} x {name}")

    # ---- phase 9: the kernels on the step's own blocks ----
    log("== 9. ELL kernel check (real plan blocks) and times")
    worst_full, shapes = full_ell_checks(ek, blocks, R, F, card)
    numbers["sddmm_seg_take_k_corr"] = sddmm_narrow_case(ek, card)
    del feed, blocks

    # ---- fit: 10 steps, one validation, one test evaluation ----
    log("== 8 (continued). sampled fit")
    strainer.model.load_state_dict(params0)
    strainer.opt.load_state_dict(opt0)
    strainer.seed_dropout(SEED)
    losses = []
    real_step, real_chunk = strainer.train_iteration, strainer.train_chunk

    def recording(fn):
        # fit takes single steps or chunks of TRAIN.SCAN_STEPS steps
        def call(arg):
            st = fn(arg)
            losses.extend(st["loss"].reshape(-1))
            return st
        return call

    strainer.train_iteration = recording(real_step)
    strainer.train_chunk = recording(real_chunk)
    lines = []
    # Evaluation depth: the first 16 batches of the valid and the test
    # pairs (all 244 of each took half of this phase's time).
    cut = cut_eval(it, 16 * 4096)
    strainer.data_iter = cut
    zero_launches(bd, ek)
    try:
        summary, t_fit = host_s(lambda: strainer.fit(max_iter=10,
                                                     log=lines.append))
    finally:
        strainer.data_iter = it
    del strainer.train_iteration, strainer.train_chunk
    fit_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    for line in lines:
        log(f"  fit: {line}")
    losses = [float(x) for x in losses]
    log(f"  sampled fit(max_iter=10): {t_fit:.2f} s with one validation "
        f"and one test evaluation ({cut.valid_node_pairs.shape[1]} and "
        f"{cut.test_node_pairs.shape[1]} pairs in batches of 4096) and "
        f"checkpoints; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"launches {fit_launches}; caps now {strainer.caps} [{card}]")
    check(len(losses) == 10 and np.isfinite(losses).all(),
          "fit should take 10 steps with finite losses")
    # Ten steps at batch 4096 move the loss by less than it varies from
    # batch to batch (about 0.03), so the fall is read on one batch with
    # one dropout seed, before and after.
    after = float(fixed_batch()[0]["loss"])
    log(f"  loss of the first batch (dropout seed {SEED}): "
        f"{float(k_stats['loss']):.6f} at the seed's parameters, "
        f"{after:.6f} after the 10 steps")
    check(after < float(k_stats["loss"]),
          "10 sampled steps did not lower the loss of a fixed batch")
    eval_batches = sum(-(-p.shape[1] // 4096) for p in
                       (cut.valid_node_pairs, cut.test_node_pairs))
    check(fit_launches["ell_spmm_transpose"] == 40
          and fit_launches["ell_spmm_fwd_only"] == 40 + 4 * eval_batches
          and fit_launches["ell_sddmm"] == 0
          and fit_launches["bit_expand_matmul"] == 0,
          f"sampled fit launch counts {fit_launches}")
    span = strainer.rating_max - strainer.rating_min
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] == 10 and np.isfinite(rmses).all()
          and 0 <= min(rmses) and max(rmses) <= span,
          f"sampled fit summary {summary}")
    numbers.update(fit_s=t_fit, losses=losses, summary=summary,
                   fixed_batch_loss=[float(k_stats["loss"]), after])

    # ---- checkpoints: back into the sampled trainer, and into Trainer ----
    best = os.path.join(save_dir, "ckpt_best_1.pt")
    last = os.path.join(save_dir, "ckpt_last_1.pt")
    check(os.path.exists(best) and os.path.exists(last),
          "sampled checkpoints")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    strainer.model.load_state_dict(params0)
    strainer.restore_checkpoint(best)
    full_trainer.restore_checkpoint(best)
    for name, t in saved["params"].items():
        for owner, what in ((strainer, "SampledTrainer"),
                            (full_trainer, "Trainer")):
            check(torch.equal(owner.model.state_dict()[name].cpu(), t),
                  f"{what}: restored parameter {name} differs")
    check(strainer.opt.count == full_trainer.opt.count == 10,
          "restored optimizer step count")
    moved = max(float((t - params0[k].cpu()).abs().max())
                for k, t in saved["params"].items())
    check(moved > 0, "sampled training did not move the parameters")
    log(f"  restore_checkpoint({os.path.basename(best)}): the sampled "
        f"trainer and the full-graph Trainer both hold the saved "
        f"parameters, optimizer at step {strainer.opt.count}")
    return launches_by_path, worst_full, shapes, numbers, strainer


# ----------------------------- serving slice -----------------------------


def run_serving_slice(bd, trainer, card):
    """Phase 7.  Returns the launch counts of one export."""
    from stargcn_tpu_torch.serve import ServingState, export_serving

    state, t_state = host_s(lambda: ServingState(
        trainer.model_cfg, trainer.data_iter, device=DEVICE, seed=SEED,
        variants=trainer.variants))
    log(f"  serving state (parameters from seed {SEED}; operands shared "
        f"with the trainer): {t_state:.2f} s [{card}]")

    # ---- the main path: counts from 0, one export, counts read ----
    zero_launches(bd)
    art, t_export = host_s(lambda: export_serving(state, segment="test"))
    launches = dict(bd.LAUNCHES)
    log(f"  export through the kernel: {t_export:.3f} s, launches "
        f"{launches} [{card}]")
    check(launches == bit_counts(4, 0, 0, 0),
          f"expected 4 bit_expand_matmul launches, got {launches}")

    ref, t_ref = host_s(lambda: export_serving(plain_twin(state),
                                               segment="test"))
    eu = rel_err(art.user_feats, ref.user_feats)
    ei = rel_err(art.item_feats, ref.item_feats)
    log(f"  export through the plain version: {t_ref:.3f} s; U rel err "
        f"{eu:.3e}, I rel err {ei:.3e} (tol 1e-2: the kernel rounds its "
        f"input to bf16, the plain version does not)")
    check_artifact(art)
    check(eu <= 1e-2 and ei <= 1e-2, "kernel export disagrees with plain")
    check_queries(art, card, "parameters from the seed")
    return launches


# ------------------------ full-graph dense and xla ------------------------


def backend_twin(trainer, **changes):
    """The same ``Trainer`` (a shallow copy: same variants, batches and
    dropout stream) with the model config changed by ``changes``, the
    parameters copied into a new model and an optimiser of its own."""
    from stargcn_tpu_torch.models import STARGCN
    from stargcn_tpu_torch.models.stargcn import feature_dims
    from stargcn_tpu_torch.train.loop import make_optimizer

    twin = copy.copy(trainer)
    twin.model_cfg = dataclasses.replace(trainer.model_cfg, **changes)
    twin.model = STARGCN(twin.model_cfg,
                         feature_dims=feature_dims(trainer.data_iter))
    twin.model.load_state_dict(trainer.model.state_dict())
    twin.model.to(trainer.device)
    twin.opt = make_optimizer(twin.s, twin.model.named_parameters())
    return twin


def no_kernel_launched(*modules):
    return all(n == 0 for mod in modules for n in mod.LAUNCHES.values())


@contextlib.contextmanager
def gc_pauses():
    """While open, the host milliseconds and the number of Python's
    cyclic garbage collections, by generation: ``{"ms": t, "runs": [n0,
    n1, n2]}``."""
    import gc

    out, started = {"ms": 0.0, "runs": [0, 0, 0]}, []

    def callback(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out["ms"] += (time.perf_counter() - started.pop()) * 1e3
            out["runs"][info["generation"]] += 1

    gc.callbacks.append(callback)
    try:
        yield out
    finally:
        gc.callbacks.remove(callback)


def step_numbers(trainer, next_batch, card, what):
    """Phase 11 (e): ``train_iteration`` 5 times after a first one, host
    clock ending in a synchronise; the profiler's device time of one more
    with its top device operations; 5 more steps on the host clock after
    that profiler session; the Python garbage collector's pauses in the
    first 5 and the objects it tracks; the memory a step takes above what
    is held before it."""
    import gc

    import torch

    def five_steps():
        times = []
        for _ in range(5):
            b = next_batch()
            _, t = host_s(lambda: trainer.train_iteration(*b))
            times.append(t * 1e3)
        return times

    batch = next_batch()
    trainer.train_iteration(*batch)
    tracked = len(gc.get_objects())
    with gc_pauses() as pauses:
        times = five_steps()
    step_ms = median(times)
    b = next_batch()
    busy, top = device_busy_ms(lambda: trainer.train_iteration(*b), top=6)
    after = five_steps()
    b = next_batch()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_iteration(*b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {what}: train_iteration, 5 steps after the first: "
        f"{', '.join(f'{x:.2f}' for x in times)} ms (median {step_ms:.2f} "
        f"ms at batch {trainer.s.rating_batch_size}); after one profiler "
        f"session, 5 more: {', '.join(f'{x:.2f}' for x in after)} ms "
        f"(median {median(after):.2f} ms); in the first 5, Python's "
        f"garbage collector ran {pauses['runs']} times (by generation) for "
        f"{pauses['ms']:.2f} ms, {tracked:,} objects tracked; peak device "
        f"memory "
        f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the step [{card}]")
    numbers = dict(step_ms=step_ms, step_times_ms=times,
                   step_ms_after_profiler=median(after),
                   step_times_after_profiler_ms=after,
                   gc_ms=pauses["ms"], gc_runs=pauses["runs"],
                   gc_tracked=tracked,
                   peak_gib=peak / 2**30, step_gib=(peak - held) / 2**30)
    numbers["device_busy_ms"] = busy
    if busy is None:
        log(f"  {what}: device busy time not measured (the profiler "
            f"showed no device time)")
        return numbers
    log(f"  {what}: device busy {busy:.2f} ms of one step by the profiler "
        f"(the card idles about {max(0.0, 1 - busy / step_ms):.0%} of the "
        f"{step_ms:.2f} ms step); top device operations: "
        + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top)
        + f" [{card}]")
    numbers["top_device_ops"] = [[n, ms, c] for n, ms, c in top]
    return numbers


def dense_product_checks(adj, card):
    """Phase 11 (d): ``scaled_dense_aggregate`` on the card, in both
    directions at the main path's shapes (units 250), against the float32
    product of the same bf16-rounded operands (TF32 off): the forward
    within 1e-5 of its largest value (the bf16 products are exact in
    float32; only the order of the float32 sums differs), the gradient
    within one bf16 ulp (at most 2^-7 relative) of its largest value (both
    round a float32 product to bf16; the card's from a split of the
    cotangent in two bf16 parts).  Then one ``torch.bmm`` of the adjacency by the bf16 operand,
    float32 out, timed beside its bounds."""
    import torch

    from stargcn_tpu_torch.ops.agg import scaled_dense_aggregate

    R, nu, ni = adj.shape
    U = 250
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for name, transposed, n_src, n_dst in (("into users", False, ni, nu),
                                           ("into items", True, nu, ni)):
        proj = torch.randn(R, n_src, U, device=DEVICE, generator=gen,
                           requires_grad=True)
        src = torch.rand(n_src, device=DEVICE, generator=gen)
        dst = torch.rand(n_dst, device=DEVICE, generator=gen)
        ct = torch.randn(n_dst, R, U, device=DEVICE, generator=gen)
        got = scaled_dense_aggregate(proj, adj, dst, src,
                                     transposed=transposed)
        (g_got,) = torch.autograd.grad(got, proj, ct)
        got = got.detach()
        a32 = (adj.transpose(1, 2) if transposed else adj).float()
        with torch.no_grad():
            x = (proj * src[None, :, None]).bfloat16().float()
            want = torch.bmm(a32, x).permute(1, 0, 2) * dst[:, None, None]
            g_want = torch.bmm(a32.transpose(1, 2), (ct * dst[:, None, None])
                               .permute(1, 0, 2)).bfloat16().float() \
                * src[None, :, None]
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        g_err = float((g_got - g_want).abs().max())
        g_scale = float(g_want.abs().max())
        flips = float((g_got != g_want).float().mean())
        log(f"  scaled_dense_aggregate {name} ({R} x {n_dst} x {n_src} "
            f"adjacency, units {U}): forward max abs err {err:.3e} of "
            f"{scale:.3e} (tol 1e-5 of it); gradient {g_err:.3e} of "
            f"{g_scale:.3e} (tol 2^-7 of it), {flips:.2e} of its entries "
            f"off the float32 product's rounding")
        check(err <= 1e-5 * scale, f"dense product {name} disagrees with "
              "the float32 product of the same bf16 operands")
        check(g_err <= 2.0 ** -7 * g_scale,
              f"dense product gradient {name} disagrees")
        xb = x.bfloat16()
        a_view = adj.transpose(1, 2) if transposed else adj
        ms = cuda_ms(lambda: torch.bmm(a_view, xb,
                                       out_dtype=torch.float32), 20)
        flop = 2.0 * R * n_dst * n_src * U
        nbytes = adj.numel() * 2 + xb.numel() * 2 + R * n_dst * U * 4
        ops_ms = flop / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  torch.bmm {name}, bf16 x bf16 -> float32: {ms:.4f} ms a "
            f"call; {flop / 1e9:.2f} GFLOP ({ops_ms:.4f} ms at 989 TFLOP/s) "
            f"and {nbytes / 1e6:.1f} MB ({bytes_ms:.4f} ms at 3.35 TB/s), "
            f"so bound by {'bytes' if bytes_ms > ops_ms else 'operations'} "
            f"at {max(ops_ms, bytes_ms):.4f} ms ({max(ops_ms, bytes_ms) / ms:.0%}"
            f" of it) [{card}]")
        out[name] = dict(forward_err=err, grad_err=g_err, grad_flips=flips,
                         bmm_ms=ms, gflop=flop / 1e9, mbytes=nbytes / 1e6,
                         ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)
    return out


def run_dense_xla_slice(bd, ek, card, save_dir):
    """Phase 11.  Returns its numbers."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.models import build_model_config
    from stargcn_tpu_torch.serve import export_serving
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    (cfg, it, model_cfg), t_graph = host_s(build_ml1m)
    R = model_cfg.num_links
    entries = R * model_cfg.num_users * model_cfg.num_items
    log(f"  host graph build ({ML1M['num_users']} x {ML1M['num_items']}, "
        f"{it.all_graph['user', 'movie'].nnz} edges): {t_graph:.2f} s; "
        f"R*Nu*Ni = {entries:,} [{card}]")
    check(model_cfg.backend == "dense" and model_cfg.edge_chunk is None,
          f"ML-1M resolved to {model_cfg.backend!r}, not 'dense'")
    trainer, t_trainer = host_s(lambda: Trainer(
        model_cfg, it, TrainSettings.from_cfg(cfg),
        save_dir=os.path.join(save_dir, "ml1m"), device=DEVICE))
    log(f"  trainer: {t_trainer:.2f} s [{card}]")
    numbers = dict(entries=entries)

    # (a) the adjacency of each variant: time, bytes, the scatter's peak.
    adjs = {}
    for variant in ("train", "test"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        adjs[variant], t_adj = host_s(
            lambda: trainer.variants.dense_adj(variant))
        a = adjs[variant]
        scatter = torch.cuda.max_memory_allocated() - before
        log(f"  {variant}-variant adjacency {tuple(a.shape)} {a.dtype}: "
            f"{t_adj * 1e3:.1f} ms, {a.numel() * a.element_size() / 1e6:.1f}"
            f" MB kept, {scatter / 1e6:.1f} MB at the build's peak (the "
            f"float32 scatter) [{card}]")
        numbers[f"adj_{variant}_ms"] = t_adj * 1e3
    numbers["adj_mb"] = adjs["train"].numel() * 2 / 1e6
    check(trainer.variants.dense_adj("valid") is adjs["train"],
          "the valid variant should share the train variant's adjacency")
    check(adjs["test"] is not adjs["train"], "the test adjacency")

    s = trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    next_batch = lambda: next_batches(trainer, rating_sampler,  # noqa: E731
                                      recon_sampler)
    batch = next_batch()
    check(trainer.do_remove and batch[0][1].size == 100_000,
          "the step should remove a batch of 100,000 train edges")
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    # (b) one step through the entry point: no hand kernel launches.
    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: trainer.train_iteration(*batch))
    log(f"  first train_iteration (dense): {t_first * 1e3:.1f} ms (start-up "
        f"included), loss {float(stats['loss']):.4f}, bit and ELL launches "
        f"{dict(bd.LAUNCHES)} {dict(ek.LAUNCHES)} [{card}]")
    check(no_kernel_launched(bd, ek), "a dense step launched a hand kernel")
    check(bool(torch.isfinite(stats["loss"])), "non-finite dense loss")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # (c) the same batch on the same parameters and dropout masks: the
    # bf16 adjacency, a float32 twin, the xla backend, and xla in chunks.
    # KERNEL.XLA_MSG_BUDGET_MB = 100 holds 100,000 messages of 250 floats:
    # the config's own translation gives 65,536-edge chunks.
    chunked_cfg = copy.deepcopy(cfg)
    chunked_cfg.KERNEL.BACKEND = "xla"
    chunked_cfg.KERNEL.XLA_MSG_BUDGET_MB = 100
    csr = it.all_graph["user", "movie"]
    chunk = build_model_config(chunked_cfg, csr.shape[0], csr.shape[1], R,
                               num_edges=csr.nnz).edge_chunk
    check(chunk == 65_536, f"XLA_MSG_BUDGET_MB=100 gives {chunk}")
    f32 = copy.copy(trainer)
    f32._operands = lambda v: trainer.variants.dense_adj(v, torch.float32)
    xla = backend_twin(trainer, backend="xla")
    xla_chunked = backend_twin(trainer, backend="xla", edge_chunk=chunk)
    runs = {}
    for name, owner in (("dense", trainer), ("dense-f32", f32),
                        ("xla", xla), ("xla-chunked", xla_chunked)):
        trainer.seed_dropout(SEED)
        zero_launches(bd, ek)
        runs[name], t = host_s(lambda: owner.loss_and_grads(*batch))
        check(no_kernel_launched(bd, ek), f"{name} launched a hand kernel")
        log(f"  loss_and_grads {name}: loss "
            f"{float(runs[name][0]['loss']):.6f}, {t * 1e3:.1f} ms")
    comparisons = {}
    for name, ref, other, tol in (
            ("xla vs dense-f32", "dense-f32", "xla", (1e-4, 1e-4, 1e-4)),
            ("xla-chunked vs xla", "xla", "xla-chunked", (1e-4, 1e-4, 1e-4)),
            ("dense (bf16) vs dense-f32", "dense-f32", "dense",
             (1e-2, 1e-1, None))):
        loss_rel, worst, worst_name, glob = compare_grads(runs[ref],
                                                          runs[other])
        comparisons[name] = dict(loss_rel=loss_rel, worst=worst,
                                 worst_name=worst_name, all=glob)
        log(f"  {name}: loss rel diff {loss_rel:.3e} (tol {tol[0]:g}), all "
            f"gradients together {glob:.3e} relative (tol {tol[1]:g}), "
            f"worst single parameter {worst:.3e} of its largest entry "
            f"({worst_name}"
            + (f"; tol {tol[2]:g})" if tol[2] else "; printed only)"))
        check(loss_rel <= tol[0] and glob <= tol[1]
              and (tol[2] is None or worst <= tol[2]),
              f"{name}: the step's loss or gradients disagree")
    numbers["comparisons"] = comparisons
    del runs, f32, xla_chunked
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # (d) the bf16 product on the card against its float32 version.
    numbers["dense_product"] = dense_product_checks(adjs["train"], card)

    # (e) step times, device busy, peak memory: dense, then xla.
    numbers["dense_step"] = step_numbers(trainer, next_batch, card,
                                         "dense (bf16 adjacency)")
    numbers["xla_step"] = step_numbers(xla, next_batch, card, "xla")
    del xla
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    log(f"  one dense step takes 4 products forward and 8 backward (two "
        f"bf16 parts of each cotangent), 12 x 55.96 GFLOP [{card}]")

    # (f) fit: 20 steps with the config's intervals -> two validations.
    trainer.seed_dropout(SEED)
    losses = []
    lines = []
    zero_launches(bd, ek)
    with recorded_losses(trainer, losses):
        summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                    log=lines.append))
    for line in lines:
        log(f"  fit: {line}")
    losses = [float(x) for x in losses]
    log(f"  fit(max_iter=20): {t_fit:.2f} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]")
    check(no_kernel_launched(bd, ek), "fit launched a hand kernel")
    check(len(losses) == 20 and np.isfinite(losses).all()
          and np.mean(losses[10:]) < losses[0],
          "fit should take 20 steps with finite, falling losses")
    check(sum("Val RMSE" in x for x in lines) == 2, "two validations")
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] in (10, 20) and np.isfinite(rmses).all()
          and max(rmses) <= trainer.rating_max - trainer.rating_min,
          f"fit summary {summary}")
    numbers["fit_s"] = t_fit
    best = os.path.join(trainer.save_dir, "ckpt_best_0.pt")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    trainer.restore_checkpoint(best)
    for name, tensor in trainer.model.state_dict().items():
        check(torch.equal(tensor.cpu(), saved["params"][name]),
              f"restored parameter {name} differs from the saved one")
    check(trainer.opt.count == summary["best_iter"], "restored step count")
    log(f"  restore_checkpoint: parameters equal the saved ones, optimizer "
        f"at step {trainer.opt.count}")

    # (g) export and serve.
    zero_launches(bd, ek)
    art, t_export = host_s(lambda: export_serving(trainer, segment="test"))
    check(no_kernel_launched(bd, ek), "the export launched a hand kernel")
    check_artifact(art, ML1M)
    log(f"  export_serving(trainer): {t_export:.3f} s [{card}]")
    check_queries(art, card, "ML-1M trained parameters")
    numbers["export_s"] = t_export

    # (h) the train CLI on its synthetic graph, with no --backend.
    numbers["cli_s"] = run_ml1m_cli(bd, ek, card, save_dir)
    return numbers


def run_ml1m_cli(bd, ek, card, save_dir):
    """Phase 11 (h): ``python -m stargcn_tpu_torch.train``'s entry point,
    in this process, on ``transductive_ml_1m.yml`` and the CLI's synthetic
    graph (943 x 1682 users x items), with no ``--backend``: ``auto``
    resolves to ``dense`` there.  10 steps and one validation."""
    import logging

    import numpy as np

    from stargcn_tpu_torch.predict import build_dataset
    from stargcn_tpu_torch.train import __main__ as train_cli
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg_path = os.path.join(ROOT, "configs", "transductive_ml_1m.yml")
    cfg = cfg_from_file(cfg_path)
    cfg.DATASET.NAME = "synthetic"
    backend = build_dataset(cfg)[2].backend
    check(backend == "dense", f"the CLI's graph resolves to {backend!r}")
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    zero_launches(bd, ek)
    try:
        result, t_cli = host_s(lambda: train_cli.main([
            "--cfg", cfg_path,
            "--dataset", "synthetic", "--save_dir",
            os.path.join(save_dir, "cli1m"), "--max_iter", "10", "--silent",
            "--device", DEVICE]))
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    log(f"  python -m stargcn_tpu_torch.train --cfg "
        f"configs/transductive_ml_1m.yml --dataset synthetic --max_iter 10: "
        f"{t_cli:.2f} s, best valid RMSE {result['best_valid_rmse']:.4f}, "
        f"no hand kernel launched: {no_kernel_launched(bd, ek)} [{card}]")
    check(result["best_iter"] == 10
          and np.isfinite(result["best_valid_rmse"]),
          f"ML-1M CLI result {result}")
    check(no_kernel_launched(bd, ek), "the ML-1M CLI launched a hand kernel")
    return t_cli


def run_ml10m_xla_step(bd, ek, trainer, card):
    """Phase 11b: ``KERNEL.BACKEND: xla`` on phase 4's ML-10M graph and the
    trainer's parameters, in ``resolve_edge_chunk``'s chunks: one
    ``train_iteration`` timed with its peak memory, then its loss and
    gradients on one batch against the ``bitdense`` trainer's (the kernels
    round x and g to bf16, xla does not: phase 6's bound for a step against
    unrounded inputs) and against the bitdense plain twin (float32, as
    xla: phase 6's bound for a step fed the same inputs)."""
    import torch

    from stargcn_tpu_torch.models import resolve_edge_chunk

    E = trainer.data_iter.all_graph["user", "movie"].nnz
    chunk = resolve_edge_chunk("xla", E, trainer.model_cfg.agg_units)
    n_chunks = -(-E // chunk) if chunk else 1
    log(f"  resolve_edge_chunk: {chunk}-edge chunks, {n_chunks} over {E:,} "
        f"edges")
    if ML10M["num_edges"] == 10_000_000:
        check(chunk == 1_441_792 and n_chunks == 7, "the ML-10M chunk")
    xla = backend_twin(trainer, backend="xla", edge_chunk=chunk)
    it, s = trainer.data_iter, trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    batch = next_batches(trainer, rating_sampler, recon_sampler)
    params0 = copy.deepcopy(xla.model.state_dict())

    zero_launches(bd, ek)
    xla.seed_dropout(SEED)
    xla.train_iteration(*batch)                  # the first, start-up
    xla.model.load_state_dict(params0)
    check(no_kernel_launched(bd, ek), "an xla step launched a hand kernel")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xla.seed_dropout(SEED)
    stats, t_step = host_s(lambda: xla.train_iteration(*batch))
    peak = torch.cuda.max_memory_allocated()
    xla.model.load_state_dict(params0)
    log(f"  xla train_iteration at ML-10M width: {t_step * 1e3:.1f} ms, "
        f"loss {float(stats['loss']):.4f}; peak device memory "
        f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before the step [{card}]")

    runs = {}
    for name, owner in (("xla", xla), ("bitdense", trainer),
                        ("bitdense-plain", plain_twin(trainer))):
        owner.model.load_state_dict(params0)
        trainer.seed_dropout(SEED)
        runs[name] = owner.loss_and_grads(*batch)
    comparisons = {}
    for name, ref, tol in (("xla vs bitdense-plain", "bitdense-plain",
                            (1e-3, 1e-3, 5e-2)),
                           ("xla vs bitdense", "bitdense",
                            (1e-2, 1e-1, None))):
        loss_rel, worst, worst_name, glob = compare_grads(runs[ref],
                                                          runs["xla"])
        comparisons[name] = dict(loss_rel=loss_rel, worst=worst,
                                 worst_name=worst_name, all=glob)
        log(f"  {name}: loss rel diff {loss_rel:.3e} (tol {tol[0]:g}), all "
            f"gradients together {glob:.3e} relative (tol {tol[1]:g}), "
            f"worst single parameter {worst:.3e} of its largest entry "
            f"({worst_name}"
            + (f"; tol {tol[2]:g})" if tol[2] else "; printed only)"))
        check(loss_rel <= tol[0] and glob <= tol[1]
              and (tol[2] is None or worst <= tol[2]),
              f"{name}: the step's loss or gradients disagree")
    return dict(step_ms=t_step * 1e3, peak_gib=peak / 2**30,
                step_gib=(peak - held) / 2**30, edge_chunk=chunk,
                comparisons=comparisons)


# ---------------------------- inductive ML-1M ----------------------------


def build_inductive_ml1m(cfg, data_root, card):
    """Phase 12 (a): an ML-1M-format archive at the real size, written by
    the port's ``write_ml1m_format`` (``ML1M`` users x items, as many
    ratings requested as the published set has, seed 123), then read once
    by ``build_dataset`` with the config's inductive split: the times (the
    ``LoadData`` parse and split alone, and the whole call), and the parsed
    counts beside the published ones.  Returns ``(build_dataset's result,
    numbers)``."""
    import stargcn_tpu_torch.data as data_pkg
    from stargcn_tpu_torch.data.invariants import PUBLISHED
    from stargcn_tpu_torch.data.synthetic import write_ml1m_format
    from stargcn_tpu_torch.predict import build_dataset

    _, t_write = host_s(lambda: write_ml1m_format(
        os.path.join(data_root, "ml-1m"), num_users=ML1M["num_users"],
        num_items=ML1M["num_items"], num_edges=ML1M["num_edges"],
        seed=SEED))
    # build_dataset takes LoadData from the package at call time: time
    # that one call inside it, so the archive is parsed once.
    real, parse = data_pkg.LoadData, []

    def timed_load(*args, **kwargs):
        loaded, t = host_s(lambda: real(*args, **kwargs))
        parse.append(t)
        return loaded

    data_pkg.LoadData = timed_load
    try:
        built, t_build = host_s(lambda: build_dataset(cfg, data_root))
    finally:
        data_pkg.LoadData = real
    csr = built[1].all_graph["user", "movie"]
    parsed = {"ratings": csr.nnz, "users": csr.shape[0],
              "items": csr.shape[1], "levels": len(csr.multi_link)}
    published = {k: PUBLISHED["ml-1m"][k] for k in parsed}
    log(f"  write_ml1m_format ({ML1M['num_users']} users, "
        f"{ML1M['num_items']} items, {ML1M['num_edges']:,} ratings "
        f"requested, seed {SEED}): {t_write:.2f} s; LoadData parse and "
        f"inductive split: {parse[0]:.2f} s of build_dataset's "
        f"{t_build:.2f} s; parsed {parsed}, published {published} (the "
        f"writer adds an edge for every user and item it would leave "
        f"unrated) [{card}]")
    check(len(parse) == 1, "build_dataset should parse the archive once")
    check(parsed["users"] == ML1M["num_users"]
          and parsed["items"] == ML1M["num_items"]
          and parsed["ratings"] >= ML1M["num_edges"]
          and parsed["levels"] == 5, f"parsed ML-1M counts {parsed}")
    return built, dict(write_s=t_write, parse_s=parse[0], build_s=t_build,
                       parsed=parsed, published=published)


def run_inductive_slice(bd, ek, card, save_dir):
    """Phase 12.  Returns its numbers and the launch counts of its bit and
    ELL paths."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import Predictor, export_serving
    from stargcn_tpu_torch.train import (SampledTrainer, Trainer,
                                         TrainSettings, sampled_loop)
    from stargcn_tpu_torch.utils import cfg_from_file

    # Every archive is written here first: nothing is ever downloaded.
    os.environ["STARGCN_AUTO_DOWNLOAD"] = "0"
    data_root = os.path.join(save_dir, "movielens")
    # (a) the config as published, through build_dataset.
    cfg = cfg_from_file(os.path.join(ROOT, "configs",
                                     "inductive_ml_1m_item_10.yml"))
    (_, it, model_cfg), numbers = build_inductive_ml1m(cfg, data_root, card)
    counts = {}
    for name, g in (("all", it.all_graph), ("train", it.train_graph),
                    ("valid", it.val_graph), ("test", it.test_graph)):
        csr = g["user", "movie"]
        counts[name] = dict(users=int(csr.shape[0]), items=int(csr.shape[1]),
                            edges=int(csr.nnz))
    counts["valid_pairs"] = int(it.valid_node_pairs.shape[1])
    counts["test_pairs"] = int(it.test_node_pairs.shape[1])
    log(f"  build_dataset(configs/inductive_ml_1m_item_10.yml, data_root): "
        f"nodes and edges by graph {counts} [{card}]")
    check(it.is_inductive and model_cfg.backend == "dense",
          f"the inductive ML-1M config resolved to {model_cfg.backend!r}")
    check(counts["train"]["items"] < counts["valid"]["items"]
          < counts["all"]["items"]
          and counts["train"]["users"] == counts["all"]["users"],
          "the held-out items should leave the train and valid graphs")
    numbers["counts"] = counts
    held_out = np.setdiff1d(np.arange(model_cfg.num_items),
                            it.val_graph.node_ids["movie"])
    noise_i = it.evaluate_embed_noise_dict["movie"]
    check(held_out.size > 0 and (noise_i[held_out] == -1).all(),
          "held-out test items must be masked at evaluation")

    # (b) the full-graph trainer on auto (dense): three distinct variants.
    trainer, t_trainer = host_s(lambda: Trainer(
        model_cfg, it, TrainSettings.from_cfg(cfg),
        save_dir=os.path.join(save_dir, "ind1m"), device=DEVICE))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adjs, t_adj = host_s(lambda: [trainer.variants.dense_adj(v)
                                  for v in ("train", "valid", "test")])
    kept = torch.cuda.memory_allocated() - before
    scatter = torch.cuda.max_memory_allocated() - before
    check(adjs[0] is not adjs[1] and adjs[1] is not adjs[2]
          and adjs[0] is not adjs[2],
          "inductive variants must not share an adjacency")
    log(f"  trainer {t_trainer:.2f} s; the three variants' bf16 "
        f"adjacencies {tuple(adjs[0].shape)}: {t_adj * 1e3:.1f} ms, "
        f"{kept / 1e6:.1f} MB kept, {scatter / 1e6:.1f} MB at the builds' "
        f"peak [{card}]")
    numbers.update(adj_ms=t_adj * 1e3, adj_kept_mb=kept / 1e6,
                   adj_peak_mb=scatter / 1e6)
    s = trainer.s
    rating_sampler = it.rating_sampler(batch_size=s.rating_batch_size,
                                       segment="train")
    recon_sampler = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    next_batch = lambda: next_batches(trainer, rating_sampler,  # noqa: E731
                                      recon_sampler)
    batch = next_batch()
    check(trainer.do_remove and batch[0][1].size == 100_000,
          "the step should remove a batch of 100,000 train edges")
    check(np.isin(batch[0][0][1], it.train_graph.node_ids["movie"]).all(),
          "a train batch named a held-out item")
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: trainer.train_iteration(*batch))
    log(f"  first train_iteration (dense): {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, bit and ELL launches "
        f"{dict(bd.LAUNCHES)} {dict(ek.LAUNCHES)} [{card}]")
    check(no_kernel_launched(bd, ek), "a dense step launched a hand kernel")
    check(bool(torch.isfinite(stats["loss"])), "non-finite dense loss")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    numbers["dense_step"] = step_numbers(trainer, next_batch, card,
                                         "inductive dense (three bf16 "
                                         "adjacencies held)")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # (c) the same batch and parameters on bitdense: the bit kernels on
    # the inductive train mask, against the dense step and against their
    # plain versions fed the same bf16-rounded inputs.
    bit = backend_twin(trainer, backend="bitdense")
    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    b_stats, t_bit = host_s(lambda: bit.train_iteration(*batch))
    bit_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  bitdense train_iteration on the inductive train mask (packs "
        f"built in the call): {t_bit * 1e3:.1f} ms, loss "
        f"{float(b_stats['loss']):.4f}, launches {bit_launches} [{card}]")
    check(bit_launches == {**bit_counts(4, 4, 0, 0), "ell_spmm_fwd_only": 0,
                           "ell_spmm_transpose": 0, "ell_sddmm": 0},
          f"expected 4 + 4 bit launches, got {bit_launches}")
    bit.model.load_state_dict(params0)
    runs = {}
    for name, owner in (("dense", trainer), ("bitdense", bit)):
        trainer.seed_dropout(SEED)
        runs[name] = owner.loss_and_grads(*batch)
    twin = plain_twin(bit)
    trainer.seed_dropout(SEED)
    with bf16_fed_plain_versions(bd):
        runs["bitdense-plain"] = twin.loss_and_grads(*batch)
    del twin
    comparisons = {}
    for name, ref, other, tol in (
            ("bitdense vs its plain versions fed bf16-rounded x and g",
             "bitdense-plain", "bitdense", (1e-3, 1e-3, 5e-2)),
            ("bitdense vs dense (bf16)", "dense", "bitdense",
             (1e-2, 1e-1, None))):
        loss_rel, worst, worst_name, glob = compare_grads(runs[ref],
                                                          runs[other])
        comparisons[name] = dict(loss_rel=loss_rel, worst=worst,
                                 worst_name=worst_name, all=glob)
        log(f"  {name}: loss rel diff {loss_rel:.3e} (tol {tol[0]:g}), all "
            f"gradients together {glob:.3e} relative (tol {tol[1]:g}), "
            f"worst single parameter {worst:.3e} of its largest entry "
            f"({worst_name}"
            + (f"; tol {tol[2]:g})" if tol[2] else "; printed only)"))
        check(loss_rel <= tol[0] and glob <= tol[1]
              and (tol[2] is None or worst <= tol[2]),
              f"{name}: the step's loss or gradients disagree")
    numbers["bitdense_comparisons"] = comparisons
    numbers["bitdense_step_ms"] = t_bit * 1e3
    del runs, bit
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # (d) fit: 20 steps with the config's intervals -> two validations.
    trainer.seed_dropout(SEED)
    lines = []
    zero_launches(bd, ek)
    summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                log=lines.append))
    for line in lines:
        log(f"  fit: {line}")
    log(f"  fit(max_iter=20): {t_fit:.2f} s; {summary} [{card}]")
    check(no_kernel_launched(bd, ek), "fit launched a hand kernel")
    check(sum("Val RMSE" in x for x in lines) == 2, "two validations")
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] in (10, 20) and np.isfinite(rmses).all()
          and max(rmses) <= trainer.rating_max - trainer.rating_min,
          f"fit summary {summary}")
    numbers["fit_s"] = t_fit
    numbers["fit"] = summary
    best = os.path.join(trainer.save_dir, "ckpt_best_0.pt")
    trainer.restore_checkpoint(best)
    check(trainer.opt.count == summary["best_iter"], "restored step count")

    # (e) export and cold-start queries on the held-out test items.
    zero_launches(bd, ek)
    art, t_export = host_s(lambda: export_serving(trainer, segment="test"))
    check(no_kernel_launched(bd, ek), "the export launched a hand kernel")
    check_artifact(art, ML1M)
    check_queries(art, card, "inductive ML-1M trained parameters")
    pairs = it.test_node_pairs[:, :4096]
    check(np.isin(pairs[1], held_out).all(),
          "test pairs should name held-out items")
    served = Predictor(art, device=DEVICE).predict(pairs[0], pairs[1])
    direct = trainer.predict(pairs[0], pairs[1], segment="test")
    err = float(np.abs(served - direct).max())
    log(f"  export_serving {t_export:.3f} s; predict on {pairs.shape[1]} "
        f"pairs of held-out test items (their evaluation noise -1): "
        f"ratings in [{served.min():.3f}, {served.max():.3f}], max abs "
        f"diff to Trainer.predict {err:.3e} (tol 1e-4) [{card}]")
    check(np.isfinite(served).all() and err <= 1e-4,
          "cold-start predictions through the export")
    numbers["export_s"] = t_export
    del trainer, adjs, art
    torch.cuda.empty_cache()

    # (f) sampled mode on pallas, phase 8's settings, on the inductive
    # train graph (the planner's id sets are subsets there).
    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    strainer, t_make = host_s(lambda: SampledTrainer(
        model_cfg, it, settings, fanout=8, backend="pallas", device=DEVICE,
        save_dir=os.path.join(save_dir, "ind1m"), save_id=1))
    log(f"  SampledTrainer on the inductive split: {t_make:.2f} s; caps "
        f"{strainer.caps}, recon caps {strainer.recon_cap} [{card}]")
    rs = it.rating_sampler(batch_size=strainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=settings.recon_batch_size)
    sbatch = strainer._build_batch_safe(rs, recon)
    sparams0 = copy.deepcopy(strainer.model.state_dict())
    strainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    s_stats, t_sfirst = host_s(lambda: strainer.train_iteration(sbatch))
    sampled_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  first sampled train_iteration: {t_sfirst * 1e3:.1f} ms, loss "
        f"{float(s_stats['loss']):.4f}, launches {sampled_launches} "
        f"[{card}]")
    check(sampled_launches == {"ell_spmm_fwd_only": 4,
                               "ell_spmm_transpose": 4, "ell_sddmm": 0,
                               **bit_counts(0, 0, 0, 0)},
          f"expected 4 + 4 ELL launches, got {sampled_launches}")
    check(bool(torch.isfinite(s_stats["loss"])), "non-finite sampled loss")

    # The same batch, parameters and dropout seed through the ELL kernels
    # and through their plain versions: the kernels on the inductive
    # masks, whose held-out rows keep part of their slots or none.
    stepped = copy.deepcopy(strainer.model.state_dict())

    def fixed_sbatch():
        strainer.model.load_state_dict(sparams0)
        strainer.seed_dropout(SEED)
        return sampled_loop._loss_and_grads(
            strainer, strainer._feed(strainer._pack_batch(sbatch)))

    k_run = fixed_sbatch()
    with plain_ell_versions(ek):
        before = dict(ek.LAUNCHES)
        p_run = fixed_sbatch()
        check(ek.LAUNCHES == before, "the plain twin launched a kernel")
    strainer.model.load_state_dict(stepped)
    loss_rel, worst, worst_name, glob = compare_grads(p_run, k_run)
    log(f"  sampled step on the inductive masks, kernels against the plain "
        f"twin (f32 on both sides): loss rel diff {loss_rel:.3e} (tol "
        f"1e-5), all gradients together {glob:.3e} relative (tol 1e-4), "
        f"worst single parameter {worst:.3e} of its largest entry "
        f"({worst_name}; {len(p_run[1])} parameters; tol 1e-3)")
    check(loss_rel <= 1e-5 and glob <= 1e-4 and worst <= 1e-3,
          "the inductive sampled step through the kernels disagrees with "
          "the plain twin")
    numbers["sampled_vs_plain"] = dict(loss_rel=loss_rel, worst=worst,
                                       worst_name=worst_name, all=glob)
    del k_run, p_run, stepped, sparams0
    split, _ = time_sampled_steps(strainer, rs, recon, 5)
    log(f"  sampled step split (median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" [{card}]")
    numbers["sampled_step"] = split
    lines = []
    summary, t_sfit = host_s(lambda: strainer.fit(max_iter=10,
                                                  log=lines.append))
    for line in lines:
        log(f"  sampled fit: {line}")
    log(f"  sampled fit(max_iter=10): {t_sfit:.2f} s; {summary} [{card}]")
    check(sum("Val RMSE" in x for x in lines) == 1, "one validation")
    check(np.isfinite(summary["best_valid_rmse"]),
          f"sampled fit summary {summary}")
    numbers["sampled_fit_s"] = t_sfit
    del strainer
    torch.cuda.empty_cache()

    # (g) the train CLI on the user-keyed config and the same archive.
    import logging

    from stargcn_tpu_torch.train import __main__ as train_cli

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    zero_launches(bd, ek)
    try:
        result, t_cli = host_s(lambda: train_cli.main([
            "--cfg", os.path.join(ROOT, "configs",
                                  "inductive_ml_1m_user_10.yml"),
            "--data_root", data_root, "--save_dir",
            os.path.join(save_dir, "cli_ind1m"), "--max_iter", "10",
            "--silent", "--device", DEVICE]))
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    log(f"  python -m stargcn_tpu_torch.train --cfg "
        f"configs/inductive_ml_1m_user_10.yml --data_root <dir> --max_iter "
        f"10: {t_cli:.2f} s (parse included), best valid RMSE "
        f"{result['best_valid_rmse']:.4f}, no hand kernel launched: "
        f"{no_kernel_launched(bd, ek)} [{card}]")
    check(result["best_iter"] == 10
          and np.isfinite(result["best_valid_rmse"]),
          f"inductive CLI result {result}")
    check(no_kernel_launched(bd, ek), "the CLI launched a hand kernel")
    numbers["cli_s"] = t_cli
    launches = {"inductive bitdense train_iteration": bit_launches,
                "inductive sampled train_iteration": sampled_launches}
    return numbers, launches


# --------------------------------- probes ---------------------------------


def mma_library_calls(a, b, groups):
    """The PyTorch calls timed beside ``probe_mma`` on ``a`` (groups * M,
    K) and ``b`` (K, N): ``{"library" | "every product": (call, what)}``.
    bf16: ``torch.einsum`` (it sums A over the groups first, in bf16, then
    runs one bmm: 1/G of the products; its result is bf16) and a call that
    does every product, ``torch.mm(..., out_dtype=float32)`` where the
    installed torch takes it on this device, else ``torch.matmul`` in bf16
    (each product block rounded to bf16), then the sum over groups.  int8:
    ``torch._int_mm`` (every product, int32) and the sum over groups, as
    both."""
    import torch

    m, n = a.shape[0] // groups, b.shape[1]
    if a.dtype == torch.int8:
        b_cols = b.t().contiguous().t()     # the layout cuBLASLt takes
        call = (lambda: torch._int_mm(a, b_cols).view(groups, m, n).sum(
            0, dtype=torch.int32), "torch._int_mm + sum over groups")
        return {"library": call, "every product": call}
    a3 = a.view(groups, m, -1)
    calls = {"library": (lambda: torch.einsum("gmk,kn->mn", a3, b),
                         'torch.einsum("gmk,kn->mn") (sums A over the '
                         'groups first, then one bmm)')}
    try:
        torch.mm(a[:16], b, out_dtype=torch.float32)
        calls["every product"] = (
            lambda: torch.mm(a, b, out_dtype=torch.float32).view(
                groups, m, n).sum(0),
            "torch.mm(out_dtype=float32) + sum over groups")
    except (RuntimeError, TypeError):
        calls["every product"] = (
            lambda: torch.matmul(a, b).view(groups, m, n).sum(
                0, dtype=torch.float32),
            "torch.matmul in bf16 (rounds each product block) + sum over "
            "groups in float32")
    return calls


def device_ms_per_call(fn, calls=20, tries=3):
    """The profiler's device time of one call of ``fn``, whose kernels each
    launch once a call: ``calls`` calls in one session, each kernel's time
    over the records the trace holds of it (late in a long process a trace
    can hold fewer records than launches), summed over the kernels; a new
    session where a trace shows no device time, None after ``tries``."""
    for _ in range(tries):
        total, kernels = device_busy_ms(
            lambda: [fn() for _ in range(calls)], top=16)
        if total is not None:
            return sum(ms / count for _, ms, count in kernels if count)
    return None


def bitcast_launch_costs(pb, v, n=10_000):
    """Host microseconds a call of each part of ``row_pair_u16``'s launch
    path, of the path it replaced and of the transposing copy, each over
    ``n`` calls back to back with the card synchronised after them."""
    import torch

    from stargcn_tpu_torch.ops import _build

    dev = v.device
    fn = _build.load("probe_bitcast")
    out = pb.row_pair_u16(v)
    half, cols = out.shape
    vp, op = v.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def import_build():
        from stargcn_tpu_torch.ops import _build as build  # noqa: F401

    def device_context():
        with torch.cuda.device(dev):
            pass

    def replaced_path():
        # The replaced wrapper without its checks: the import and the
        # locked load on every call, the device context and a Stream
        # object.
        from stargcn_tpu_torch.ops import _build as build
        o = torch.empty((half, cols), dtype=torch.uint16, device=dev)
        f = build.load("probe_bitcast")
        with torch.cuda.device(dev):
            s = torch.cuda.current_stream(dev).cuda_stream
            f(v.data_ptr(), o.data_ptr(), half, cols, s)

    parts = {
        "an empty Python call": lambda: None,
        "the checks (check_input)": lambda: pb.check_input(v),
        "from ... import _build": import_build,
        "_build.load (lock, dict)": lambda: _build.load("probe_bitcast"),
        "torch.cuda.device(dev) context": device_context,
        "_build.call_on an empty call (device current)":
            lambda: _build.call_on(dev, lambda: None),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_build.raw_stream(dev)": lambda: _build.raw_stream(dev),
        "torch.empty of the output": lambda: torch.empty(
            (half, cols), dtype=torch.uint16, device=dev),
        "two data_ptr()": lambda: (v.data_ptr(), out.data_ptr()),
        "the ctypes call (the launch)": lambda: fn(vp, op, half, cols,
                                                   stream),
        "the replaced path, checks left out": replaced_path,
        "row_pair_u16": lambda: pb.row_pair_u16(v),
        "the transposing copy": lambda: v.view(half, 2, cols).transpose(
            1, 2).contiguous(),
    }
    costs = {}
    for name, f in parts.items():
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        costs[name] = (time.perf_counter() - t0) / n * 1e6
    return costs


def _ms_or_not(ms):
    return "not measured (no device time in the trace)" if ms is None \
        else f"{ms:.5f} ms"


def run_probes(card):
    """Phase 10.  Each probe's entry point with counts of its own, then its
    kernel against its plain version on edge cases (each launched twice,
    the same bits), then times: kernel and library calls alike back to back
    by ``cuda_ms`` with operands and outputs allocated first, the
    profiler's device time, and the bitcast wrapper's host costs part by
    part.  Returns ``(launches by probe, worst errors, shapes by
    kernel)``."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.probes import probe_bitcast as pb
    from stargcn_tpu_torch.probes import probe_int8_mma as pm

    # ---- probe_bitcast ----
    zero_launches(pb, pm)
    res = pb.run(DEVICE, log=lambda line: log(f"  {line}"))
    bitcast_launches = {**pb.LAUNCHES, **pm.LAUNCHES}
    v = pb.probe_input()
    check(np.array_equal(res["row_pair"], v[0::2].astype(np.uint16)
                         | (v[1::2].astype(np.uint16) << 8)),
          "probe_bitcast: the row-pair view is not v[2k] | v[2k+1] << 8")
    check(np.array_equal(res["column_pair"], v.view("<u2")),
          "probe_bitcast: a u16 reading on the card is not little-endian "
          "adjacent columns")
    rng = np.random.RandomState(SEED + 8)
    worst = {"probe_bitcast": 0.0, "probe_mma": 0.0}
    # (shape, storage offset): eight outputs a thread where S % 8 == 0 and
    # v is 8-byte aligned, one a thread otherwise (odd S, S % 8 != 0, an
    # odd offset).
    for shape, offset in (((32, 256), 0), ((2, 1), 0), ((4096, 1000), 0),
                          ((6, 13), 0), ((4, 12), 0), ((32, 256), 1)):
        flat = torch.from_numpy(rng.randint(
            0, 256, shape[0] * shape[1] + offset).astype(np.uint8)).to(DEVICE)
        vv = flat[offset:].view(shape)
        got = pb.row_pair_u16(vv).view(torch.int16)
        again = pb.row_pair_u16(vv).view(torch.int16)
        want = pb.plain_row_pair_u16(vv).view(torch.int16)
        worst["probe_bitcast"] = max(worst["probe_bitcast"], float(
            ((got.int() & 0xFFFF) - (want.int() & 0xFFFF)).abs().max()))
        check(torch.equal(got, want) and torch.equal(got, again),
              f"probe_bitcast disagrees (or does not repeat) at {shape}, "
              f"offset {offset}")
    log("  row_pair_u16 equal to its plain version and repeated bit for bit "
        "at (32, 256), (2, 1), (4096, 1000), (6, 13), (4, 12) and (32, 256) "
        "at storage offset 1")
    vt = torch.from_numpy(v).to(DEVICE)
    library = lambda: vt.view(pb.M // 2, 2, pb.S).transpose(  # noqa: E731
        1, 2).contiguous().view(torch.int16)
    check(torch.equal(library().squeeze(-1),
                      pb.row_pair_u16(vt).view(torch.int16)),
          "the library yardstick computes another function")
    nbytes = 2 * v.size
    costs = bitcast_launch_costs(pb, vt)
    bshape = dict(v=list(v.shape), ms=cuda_ms(lambda: pb.row_pair_u16(vt),
                                              reps=2000),
                  plain_ms=cuda_ms(lambda: pb.plain_row_pair_u16(vt),
                                   reps=200),
                  library_ms=cuda_ms(library, reps=2000),
                  device_ms=device_ms_per_call(
                      lambda: pb.row_pair_u16(vt)),
                  bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                  host_us_by_part=costs)
    log(f"  probe_bitcast (32, 256): kernel {bshape['ms']:.4f} ms a call "
        f"back to back, plain {bshape['plain_ms']:.4f} ms, library (a "
        f"transposing copy) {bshape['library_ms']:.4f} ms, the kernel's "
        f"device time {_ms_or_not(bshape['device_ms'])} (profiler), bound "
        f"{bshape['bound_ms']:.2e} ms (bytes): launch-bound [{card}]")
    for name, us in costs.items():
        log(f"    host cost, {name}: {us:.2f} us a call [{card}]")

    # ---- probe_int8_mma ----
    zero_launches(pb, pm)
    mma = pm.run(DEVICE, log=lambda line: log(f"  {line}"))
    mma_launches = {**pb.LAUNCHES, **pm.LAUNCHES}
    want00 = pm.G * pm.K
    for name, r in mma.items():
        check(r["out00"] == want00, f"probe_int8_mma {name}: out[0,0] = "
                                    f"{r['out00']}, not {want00}")
    shapes = []
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).split(".")[-1]
        esize = 2 if dtype == torch.bfloat16 else 1
        # (G, M, K, N): M = 64 leaves one consumer warpgroup idle; N = 512
        # takes two N-tiles; 67 groups make 34 chunks of 2, the last
        # holding one; K of one 64-byte step (zeros read past it) with a
        # last M-tile of 64 rows; K = 384 ends off a 256-byte stage and
        # (int8) transposes a B whose K differs from N; then the probe's
        # shape, whose operands are timed below.
        for groups, m, k, n in ((3, 64, 256, 256), (7, 128, 1024, 512),
                                (67, 256, 128, 256), (5, 192, 64 // esize,
                                                      256),
                                (2, 128, 384, 256),
                                (pm.G, pm.M, pm.K, pm.N)):
            a = torch.from_numpy(rng.randint(-2, 3, (groups * m, k))).to(
                DEVICE, dtype)
            b = torch.from_numpy(rng.randint(-2, 3, (k, n))).to(DEVICE,
                                                                dtype)
            got = pm.grouped_matmul(a, b, groups)
            again = pm.grouped_matmul(a, b, groups)
            want = pm.plain_grouped_matmul(a, b, groups)
            err = float((got.double() - want.double()).abs().max())
            worst["probe_mma"] = max(worst["probe_mma"], err)
            log(f"  grouped_matmul {name} G={groups} M={m} K={k} N={n}, "
                f"integers in [-2, 2]: max_abs_err={err} (exact expected), "
                f"{pm.launch_plan(groups, m, k, n, dtype)}")
            check(torch.equal(got, want), f"probe_mma {name} disagrees at "
                                          f"G={groups} M={m} K={k} N={n}")
            check(torch.equal(got, again), f"probe_mma {name} does not "
                  f"repeat bit for bit at G={groups} M={m} K={k} N={n}")
        out, ws = pm.buffers(a, b, pm.G)
        kernel = lambda: pm.grouped_matmul(  # noqa: E731
            a, b, pm.G, out=out, workspace=ws)
        ms = cuda_ms(kernel, reps=20)
        device_ms = device_ms_per_call(kernel)
        plain_ms = cuda_ms(lambda: pm.plain_grouped_matmul(a, b, pm.G),
                           reps=2)
        lib = {key: (cuda_ms(call, reps=20), what) for key, (call, what)
               in mma_library_calls(a, b, pm.G).items()}
        ops = 2 * pm.G * pm.M * pm.K * pm.N
        bms, by = pm.bound_ms(pm.G, pm.M, pm.K, pm.N, dtype)
        shapes.append(dict(
            dtype=name, A=[pm.G * pm.M, pm.K], B=[pm.K, pm.N], ms=ms,
            top_s=ops / ms / 1e9, device_ms=device_ms, run_ms=mma[name]["ms"],
            first_s=mma[name]["first_s"], plain_ms=plain_ms,
            library_ms=lib["library"][0], library=lib["library"][1],
            every_product_ms=lib["every product"][0],
            every_product=lib["every product"][1], bound_ms=bms,
            bound_by=by, bound_share=bms / ms))
        log(f"  probe_mma {name}: kernel {ms:.4f} ms a call back to back "
            f"({ops / ms / 1e9:.0f} TOP/s, {bms / ms:.1%} of the {bms:.4f} "
            f"ms bound, {by}), device {_ms_or_not(device_ms)} (profiler), "
            f"plain (float64) {plain_ms:.3f} ms; library {lib['library'][1]} "
            f"{lib['library'][0]:.4f} ms; every product "
            f"{lib['every product'][1]} {lib['every product'][0]:.4f} ms "
            f"[{card}]")
        del a, b, out, ws
    ratio = shapes[0]["ms"] / shapes[1]["ms"]
    log(f"  int8 runs {ratio:.2f}x as fast as bf16 through wgmma on this "
        f"card (2x on paper; both are bound by reading A, int8's A is half "
        f"the bytes) [{card}]")
    launches = {"probe_bitcast.run": bitcast_launches,
                "probe_int8_mma.run": mma_launches}
    check(bitcast_launches == {"probe_bitcast": 1, "probe_mma": 0}
          and mma_launches["probe_bitcast"] == 0
          and mma_launches["probe_mma"] == 22,
          f"probe launch counts {launches}")
    return launches, worst, {"probe_bitcast": [bshape], "probe_mma": shapes}


# --------------- phase 13: sampling and planning on the card ---------------


def call_without_waiting(fn, busy_ms=1000.0):
    """``fn()`` with every operation that waits for the card an error
    (``torch.cuda.set_sync_debug_mode("error")``) and, since that mode
    does not catch every wait, called while the card still runs a
    ``busy_ms`` sleep queued just before it: its host time well under
    ``busy_ms`` shows that it waited for nothing.  ``fn`` should have run
    once before (first calls allocate).  Returns ``(result, host ms)``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    cycles = int(1_000_000 * busy_ms / max(start.elapsed_time(end), 1e-3))
    torch.cuda._sleep(cycles)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(host < busy_ms / 2, f"{host:.1f} ms on the host behind a "
          f"{busy_ms:.0f} ms sleep on the card: the call waited for it")
    return out, host


def h2d_copies(events):
    """The host-to-device copies among ``device_events`` entries."""
    return [(name, calls) for name, _, calls in events if "HtoD" in name]


def cut_eval(it, n):
    """The iterator with its valid and test pairs cut to the first ``n``
    each (evaluation depth; the graphs, the train pairs and the samplers'
    stream are the iterator's own)."""
    cut = copy.copy(it)
    for name in ("valid", "test"):
        setattr(cut, f"_{name}_node_pairs",
                getattr(it, f"{name}_node_pairs")[:, :n])
        setattr(cut, f"_{name}_ratings", getattr(it, f"{name}_ratings")[:n])
    return cut


def recording_uniforms(strainer):
    """Make ``strainer``'s plan draws also land in the list returned."""
    draws, real = [], strainer.plan_uniform

    def uniform(shape):
        u = real(shape)
        draws.append(u)
        return u

    strainer.plan_uniform = uniform
    return draws


def plan_on_card_against_cpu(strainer, feed, what, card):
    """One device plan of ``feed`` built with every wait for the card an
    error, then the same planner on the CPU fed the same uniforms: every
    array equal, weights within 1e-6.  Returns ``(plan, pairs_pos, aux)``
    and the largest weight difference."""
    import torch

    from stargcn_tpu_torch.graph.device_sampling import (DeviceGraphTables,
                                                         DevicePlanner)

    strainer._device_plan(feed)
    real = strainer.plan_uniform
    draws = recording_uniforms(strainer)
    try:
        out, host = call_without_waiting(lambda: strainer._device_plan(feed))
    finally:
        strainer.plan_uniform = real
    tab = DeviceGraphTables.build(strainer.data_iter.train_graph, "user",
                                  "movie", "cpu")
    cpu_feed = {k: v.cpu() for k, v in feed.items()}
    replay = iter([u.cpu() for u in draws])
    cout = DevicePlanner(strainer.model_cfg, strainer.caps, strainer.fanout,
                         symm=strainer.model_cfg.agg_norm_symm).build(
        tab, lambda shape: next(replay),
        tab.id2ind["user"].index_select(0, cpu_feed["bu"]),
        tab.id2ind["item"].index_select(0, cpu_feed["bi"]),
        cpu_feed["valid"], cpu_feed["recon_u"], cpu_feed["recon_i"],
        exclude=strainer.do_remove)
    worst = [0.0]

    def same(a, b, path):
        if b is None:
            check(a is None, f"{what}: {path} differs from the CPU plan")
        elif isinstance(b, dict):
            check(sorted(a) == sorted(b), f"{what}: {path} keys")
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, (list, tuple)):
            check(len(a) == len(b), f"{what}: {path} length")
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            x = a.cpu()
            check(x.shape == b.shape and x.dtype == b.dtype,
                  f"{what}: {path} shape or type")
            if b.dtype.is_floating_point:
                err = float((x - b).abs().max()) if b.numel() else 0.0
                worst[0] = max(worst[0], err)
                check(err <= 1e-6, f"{what}: {path} off by {err:.3e}")
            else:
                check(torch.equal(x, b), f"{what}: {path} differs from "
                      "the CPU plan")

    same(out[0], cout[0], "plan")
    same(out[1], cout[1], "pairs_pos")
    for k in ("needed_user", "needed_item", "overflow"):
        check(int(out[2][k]) == int(cout[2][k]), f"{what}: aux {k}")
    check(out[2]["identity"] == cout[2]["identity"], f"{what}: identity")
    log(f"  {what}: the plan built on the card with every wait for the card "
        f"an error (sync debug mode \"error\"), in {host:.2f} ms of host "
        f"time behind a 1 s sleep on the card, {len(draws)} uniform "
        f"draws; "
        f"the same planner on the CPU fed them gives every array equal, "
        f"weights within {worst[0]:.3e} (tol 1e-6); needed "
        f"{int(out[2]['needed_user'])} users / {int(out[2]['needed_item'])} "
        f"items of caps {strainer.caps} (0 on a dense type: no dedup), "
        f"identity {out[2]['identity']} [{card}]")
    return out, worst[0]


def state_snapshot(owner):
    """Copies of the parameters and the optimiser state (count, moments)."""
    opt = owner.opt.state_dict()
    return ({k: v.clone() for k, v in owner.model.state_dict().items()},
            opt["count"], {k: v.clone() for k, v in opt["mu"].items()},
            {k: v.clone() for k, v in opt["nu"].items()})


def states_equal(a, b):
    import torch

    return a[1] == b[1] and all(torch.equal(x[k], y[k]) for x, y in
                                ((a[0], b[0]), (a[2], b[2]), (a[3], b[3]))
                                for k in x)


def run_device_sampler_slice(bd, trainer, card, earlier):
    """Phase 13 (a): ``TRAIN.DEVICE_SAMPLER`` on phase 4's ML-10M
    ``bitdense`` trainer.  Returns the launch counts of each driven path
    and the numbers; the trainer's parameters come back as they were."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.train import loop as tloop

    it, cfg = trainer.data_iter, trainer.model_cfg
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    launches = {}

    # The path through its entry point: counts from 0, a chunk, read.
    trainer.seed_dropout(SEED)
    zero_launches(bd)
    stats, t_first = host_s(lambda: trainer.train_chunk_dev(10))
    launches["device_sampler train_chunk_dev(10)"] = dict(bd.LAUNCHES)
    losses = [float(x) for x in stats["loss"]]
    log(f"  first train_chunk_dev(10) (the train edges copied to the card "
        f"in it): {t_first:.3f} s, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, launches "
        f"{dict(bd.LAUNCHES)} [{card}]")
    check(bd.LAUNCHES == bit_counts(40, 40, 0, 0),
          f"expected 40 + 40 bit launches in 10 steps, got {bd.LAUNCHES}")
    check(np.isfinite(losses).all(), "non-finite loss drawn on the card")

    # After the first call nothing is copied to the card inside a chunk.
    events = device_events(lambda: trainer.train_chunk_dev(10))
    copies = h2d_copies(events)
    busy = device_busy_ms(None, events=events)
    busy = None if busy is None else busy / 10
    log(f"  a second chunk under the profiler: host-to-device copies "
        f"{copies or 'none'}; device busy {_ms_or_not(busy)} a step "
        f"[{card}]")
    check(not copies, f"copies to the card inside a chunk: {copies}")

    # One draw with every wait for the card an error, checked on the host.
    arrays = trainer.device_train_arrays()

    def draw():
        d = trainer.draw_device_batch()
        return d, tloop._device_sample_step_inputs(trainer, *arrays, d)

    draw()
    (draws, inputs), draw_host = call_without_waiting(draw)
    ints, flts, noise, rmask = (x.cpu().numpy() for x in inputs)
    tp = np.asarray(it.train_node_pairs, np.int64)
    keys = tp[0] * cfg.num_items + tp[1]
    order = np.argsort(keys)
    q = ints[0].astype(np.int64) * cfg.num_items + ints[1]
    pos = np.minimum(np.searchsorted(keys[order], q), keys.size - 1)
    check((keys[order][pos] == q).all(), "a drawn pair is not a train edge")
    check((np.asarray(it.train_ratings)[order][pos] == flts[0]).all()
          and (np.asarray(it.possible_rating_values)[ints[2]]
               == flts[0]).all(), "a drawn pair's rating or its index")
    check((flts[1] == 1).all() and (flts[2] == 1).all(),
          "drawn pairs are valid and removed")
    fracs = {}
    nu = cfg.num_users
    for i, (t, sl) in enumerate((("user", slice(0, nu)),
                                 ("item", slice(nu, None)))):
        m, nz = rmask[sl], noise[sl]
        p = trainer._dev_pmask[i]
        sd = (p * (1 - p) / m.size) ** 0.5
        fracs[t] = float(m.mean())
        check(abs(m.mean() - p) <= 5 * sd,
              f"{t} recon fraction {m.mean():.5f}, P_MASK {p} (sd {sd:.5f})")
        kept = nz != -1
        check(((~kept) <= (m > 0)).all()
              and (nz[kept] == np.nonzero(kept)[0]).all(),
              f"{t} noise: only selected nodes are masked")
    log(f"  one draw of {ints.shape[1]} pairs with sync debug mode "
        f"\"error\", in {draw_host:.2f} ms of host time behind a 1 s sleep "
        f"on the card: every pair a train edge with its rating; recon "
        f"fractions {fracs} against P_MASK {trainer._dev_pmask} (within 5 "
        f"standard deviations) [{card}]")

    # The same inputs through the host-fed step: the same loss and
    # gradients as the nearest of its repeats, within twice their spread.
    rb = (ints[:2], flts[0])
    cb = (noise[:nu], noise[nu:], rmask[:nu], rmask[nu:])
    reps = []
    for _ in range(HOST_FED_REPEATS):
        trainer.seed_dropout(SEED)
        reps.append(trainer.loss_and_grads(rb, cb))
    trainer.seed_dropout(SEED)
    drawn = trainer._loss_and_grads(*inputs)
    ok, got, tol, spread, nearest = held_to_repeats(reps, drawn)
    log(f"  the drawn inputs through train_step_dev's step and through the "
        f"host-fed step: against the nearest of {len(reps)} host-fed "
        f"repeats (repeat {nearest}), loss rel diff {got[0]:.3e} (tol "
        f"{tol[0]:.3e}), worst parameter {got[1]:.3e} ({got[2]}; tol "
        f"{tol[1]:.3e}), all gradients together {got[3]:.3e} (tol "
        f"{tol[2]:.3e}); the repeats' spread: loss {spread[0]:.3e}, worst "
        f"{spread[1]:.3e}, all together {spread[2]:.3e} (tol twice the "
        f"spread plus 1e-7 / 1e-6 / 1e-7)")
    check(ok, "the step drawn on the card disagrees with the host-fed step")
    del reps, drawn

    # Step time, busy and idle beside the host-fed step on these parameters.
    times = []
    for _ in range(3):
        _, t = host_s(lambda: trainer.train_chunk_dev(10))
        times.append(t * 1e3 / 10)
    step_ms = median(times)
    rs = it.rating_sampler(batch_size=trainer.s.rating_batch_size,
                           segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    host_times = []
    for _ in range(6):
        b = next_batches(trainer, rs, recon)
        _, t = host_s(lambda: trainer.train_iteration(*b))
        host_times.append(t * 1e3)
    host_ms = median(host_times[1:])
    host_busy = device_busy_ms(lambda: trainer.train_iteration(*b))
    was = earlier.get("training") or {}
    log(f"  DEVICE_SAMPLER step: {step_ms:.2f} ms on the host clock "
        f"(train_chunk_dev(10) / 10, median of "
        f"{', '.join(f'{x:.2f}' for x in times)}), device busy "
        f"{_ms_or_not(busy)}, idle "
        f"{'not measured' if busy is None else f'{1 - busy / step_ms:.0%}'};"
        f" host-fed step in this phase {host_ms:.2f} ms, busy "
        f"{_ms_or_not(host_busy)}; phase 6's host-fed step "
        f"{_earlier_ms(was.get('step_ms'))}, busy "
        f"{_earlier_ms(was.get('device_busy_ms'))} [{card}]")

    # fit with the sampler on: 20 steps, two validations.
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    trainer.seed_dropout(SEED)
    trainer.s.device_sampler = True
    losses, lines = [], []
    zero_launches(bd)
    try:
        with recorded_losses(trainer, losses):
            summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                        log=lines.append))
    finally:
        trainer.s.device_sampler = False
    launches["device_sampler fit(20)"] = dict(bd.LAUNCHES)
    for line in lines:
        log(f"  fit: {line}")
    losses = [float(x) for x in losses]
    log(f"  fit(max_iter=20) with TRAIN.DEVICE_SAMPLER: {t_fit:.2f} s (phase "
        f"6's host-fed fit {_s_or_not(was.get('fit_s'))}); launches "
        f"{dict(bd.LAUNCHES)} [{card}]")
    eval_batches = -(-it.valid_node_pairs.shape[1]
                     // trainer.s.rating_batch_size)
    check(bd.LAUNCHES["bit_reduce_matmul"] == 80
          and bd.LAUNCHES["bit_expand_matmul"] >= 80 + 2 * 4 * eval_batches,
          f"device-sampled fit launch counts {bd.LAUNCHES}")
    check(len(losses) == 20 and np.isfinite(losses).all()
          and sum("Val RMSE" in x for x in lines) == 2
          and np.isfinite(summary["best_valid_rmse"]),
          f"device-sampled fit: 20 finite steps, two validations {summary}")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    torch.cuda.empty_cache()
    return launches, dict(
        first_chunk_s=t_first, step_ms=step_ms, step_times_ms=times,
        device_busy_ms=busy, host_fed_step_ms=host_ms,
        host_fed_busy_ms=host_busy, h2d_copies_in_chunk=len(copies),
        draw_host_ms=draw_host,
        recon_fraction=fracs, host_fed_comparison=got[:2] + got[3:],
        fit_s=t_fit, fit=summary)


def _s_or_not(s):
    return "not run in this process" if s is None else f"{s:.2f} s"


def _earlier_ms(ms):
    return "not run in this process" if ms is None else f"{ms:.2f} ms"


def run_device_sampler_ml1m(bd, ek, card):
    """Phase 13 (b), in a process of its own (``--phases 13b``): the
    ML-1M ``dense`` trainer of phase 11, its host-fed step beside the step
    drawn on the card, and ``fit`` both ways."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.train import Trainer, TrainSettings

    (cfg, it, model_cfg), t_graph = host_s(build_ml1m)
    check(model_cfg.backend == "dense", "ML-1M should resolve to dense")
    numbers = {"graph_s": t_graph}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        trainer = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                          save_dir=save_dir, device=DEVICE)
        trainer.variants.dense_adj("train")
        params0 = copy.deepcopy(trainer.model.state_dict())
        opt0 = copy.deepcopy(trainer.opt.state_dict())
        rs = it.rating_sampler(batch_size=trainer.s.rating_batch_size,
                               segment="train")
        recon = it.recon_nodes_sampler(
            batch_size=trainer.s.recon_batch_size)
        zero_launches(bd, ek)
        host_times = []
        for _ in range(6):
            b = next_batches(trainer, rs, recon)
            _, t = host_s(lambda: trainer.train_iteration(*b))
            host_times.append(t * 1e3)
        host_busy = device_busy_ms(lambda: trainer.train_iteration(*b))
        trainer.train_chunk_dev(10)
        times = []
        for _ in range(3):
            _, t = host_s(lambda: trainer.train_chunk_dev(10))
            times.append(t * 1e3 / 10)
        events = device_events(lambda: trainer.train_chunk_dev(10))
        busy = device_busy_ms(None, events=events)
        busy = None if busy is None else busy / 10
        check(not h2d_copies(events), "copies to the card inside a chunk")
        check(no_kernel_launched(bd, ek), "a dense step launched a kernel")
        host_ms, step_ms = median(host_times[1:]), median(times)
        log(f"  ML-1M dense: host-fed step {host_ms:.2f} ms (median of "
            f"{', '.join(f'{x:.2f}' for x in host_times[1:])}), busy "
            f"{_ms_or_not(host_busy)}; DEVICE_SAMPLER step {step_ms:.2f} ms "
            f"(train_chunk_dev(10) / 10: "
            f"{', '.join(f'{x:.2f}' for x in times)}), busy "
            f"{_ms_or_not(busy)}, idle "
            f"{'not measured' if busy is None else f'{1 - busy / step_ms:.0%}'}"
            f" [{card}]")
        # fit three ways, in turns: host-fed serial (SCAN_STEPS 1: the same
        # steps, no producer thread), host-fed with the prefetch thread
        # (SCAN_STEPS 10), drawn on the card.
        fits = {k: [] for k in ("host_fed_serial", "host_fed_prefetch",
                                "device_sampler")}
        s0 = trainer.s
        for _ in range(2):
            for way in fits:
                trainer.model.load_state_dict(params0)
                trainer.opt.load_state_dict(opt0)
                trainer.seed_dropout(SEED)
                trainer.s = dataclasses.replace(
                    s0, device_sampler=way == "device_sampler",
                    scan_steps=1 if way == "host_fed_serial"
                    else s0.scan_steps)
                lines = []
                summary, t_fit = host_s(lambda: trainer.fit(
                    max_iter=20, log=lines.append))
                check(np.isfinite(summary["best_valid_rmse"])
                      and sum("Val RMSE" in x for x in lines) == 2,
                      f"ML-1M fit {way} {summary}")
                fits[way].append(t_fit)
        trainer.s = s0
        log(f"  ML-1M fit(max_iter=20), two validations, each way twice in "
            f"turns: host-fed serial (SCAN_STEPS 1) "
            f"{', '.join(f'{x:.2f}' for x in fits['host_fed_serial'])} s, "
            f"host-fed with the prefetch thread "
            f"{', '.join(f'{x:.2f}' for x in fits['host_fed_prefetch'])} s, "
            f"DEVICE_SAMPLER "
            f"{', '.join(f'{x:.2f}' for x in fits['device_sampler'])} s "
            f"[{card}]")
        check(no_kernel_launched(bd, ek), "ML-1M fit launched a kernel")
    del torch
    numbers.update(host_fed_step_ms=host_ms, host_fed_busy_ms=host_busy,
                   step_ms=step_ms, device_busy_ms=busy, fit_s=fits)
    return numbers


def run_fresh(phase, key, card, env=None):
    """``chip_smoke.py --phases <phase>`` in a process of its own (with
    ``env`` added to its environment): its lines relayed, its numbers (the
    JSON line under ``key``) returned."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases",
         phase], capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, **(env or {})})
    numbers = None
    for line in out.stdout.splitlines():
        if line.startswith(f'{{"{key}"'):
            numbers = json.loads(line)[key]
        elif line.startswith("  "):
            log(f"  [fresh] {line.strip()}")
    check(out.returncode == 0 and numbers is not None,
          f"--phases {phase} failed: {out.stderr[-2000:]}")
    return numbers


def probed_caps(strainer, batch):
    """The frontier caps ``SampledTrainer`` would probe at another batch
    size, from ``strainer``'s samplers (their caps lifted meanwhile so
    the probe plans keep their real sizes)."""
    saved = strainer.train_batch, [s.frontier_caps
                                   for s in strainer.samplers.values()]
    strainer.train_batch = batch
    for s in strainer.samplers.values():
        s.frontier_caps = None
    try:
        return strainer._probe_caps(1.6)
    finally:
        strainer.train_batch = saved[0]
        for s, c in zip(strainer.samplers.values(), saved[1]):
            s.frontier_caps = c


def run_plan_device_slice(bd, ek, cfg, it, model_cfg, save_dir, card,
                          earlier):
    """Phase 13 (c) and (d): ``SampledTrainer(plan_device=True)`` at
    ML-10M (batch 4096, recon 1024, fanout 8, ``xla``), then the dedup path
    at a batch whose probed user cap falls below the user count."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.graph.device_sampling import (batch_edge_keys,
                                                         keep_mask)
    from stargcn_tpu_torch.train import (SampledTrainer, TrainSettings,
                                         sampled_loop)

    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    eval_it = cut_eval(it, 8192)
    gk.set_seed(SEED)
    strainer, t_make = host_s(lambda: SampledTrainer(
        model_cfg, eval_it, settings, fanout=8, backend="xla",
        device=DEVICE, plan_device=True, save_dir=save_dir, save_id=3))
    n = strainer._dev_tables.n
    log(f"  SampledTrainer(plan_device=True): {t_make:.2f} s; probed caps "
        f"{strainer.caps} against {n} nodes [{card}]")
    check(all(strainer.caps[t] >= n[t] for t in n),
          "at batch 4096 both caps should pass the node counts")
    rs = eval_it.rating_sampler(batch_size=strainer.train_batch,
                                segment="train")
    recon = eval_it.recon_nodes_sampler(batch_size=settings.recon_batch_size)
    batch = strainer._build_batch_safe(rs, recon)
    params0 = copy.deepcopy(strainer.model.state_dict())
    opt0 = copy.deepcopy(strainer.opt.state_dict())
    launches = {}

    # The path through its entry point: counts from 0, a step, read.
    strainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: strainer.train_iteration(batch))
    launches["plan_device train_iteration"] = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  first plan_device train_iteration: {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, overflow {bool(stats['overflow'])}, "
        f"launches {launches['plan_device train_iteration']} [{card}]")
    check(no_kernel_launched(bd, ek), "a plan_device step launched a kernel")
    check(not bool(stats["overflow"]) and bool(torch.isfinite(stats["loss"])),
          "the first plan_device step")

    # The plan against the CPU; the step through identity_frontiers
    # against the same plan through the gather path.
    feed = strainer._feed(strainer._pack_batch(batch))
    (plan, pp, aux), w_err = plan_on_card_against_cpu(strainer, feed,
                                                      "batch 4096", card)
    check(aux["identity"] == {"user": True, "item": True},
          "both types should take the identity path")
    full = dict(feed, plan=dict(plan, pairs_pos=pp))
    strainer.seed_dropout(SEED)
    ident = sampled_loop._loss_and_grads(strainer, full,
                                         identity=aux["identity"])
    strainer.seed_dropout(SEED)
    gather = sampled_loop._loss_and_grads(strainer, full)
    loss_rel, worst, worst_name, glob = compare_grads(gather, ident)
    log(f"  identity_frontiers against the gather path on that plan: loss "
        f"rel diff {loss_rel:.3e} (tol 1e-5), all gradients together "
        f"{glob:.3e} (tol 1e-4), worst parameter {worst:.3e} ({worst_name};"
        f" tol 1e-3)")
    check(loss_rel <= 1e-5 and glob <= 1e-4 and worst <= 1e-3,
          "identity_frontiers disagrees with the gather path")
    del ident, gather, full

    # Device time of the plan and of the update, the step, idle, memory.
    plan_busy = device_busy_ms(lambda: strainer._device_plan(feed))
    dplan = strainer._device_plan(feed)
    update_busy = device_busy_ms(
        lambda: strainer._device_update(*dplan, feed))
    del dplan
    draw_times, times = [], []
    batches = []
    for _ in range(6):
        b, t = host_s(lambda: strainer._build_batch_safe(rs, recon))
        draw_times.append(t * 1e3)
        batches.append(b)
    for b in batches:
        _, t = host_s(lambda: strainer.train_iteration(b))
        times.append(t * 1e3)
    step_ms, draw_ms = median(times[1:]), median(draw_times)
    busy = device_busy_ms(lambda: strainer.train_iteration(batches[0]))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    strainer.train_iteration(batches[1])
    torch.cuda.synchronize()
    above = (torch.cuda.max_memory_allocated() - held) / 2**30
    was = (earlier.get("sampled_training") or {}).get("xla") or {}
    log(f"  plan_device step: {step_ms:.2f} ms on the host clock (median of "
        f"{', '.join(f'{x:.2f}' for x in times[1:])}; the batch drawn "
        f"before it in {draw_ms:.2f} ms), device busy {_ms_or_not(busy)}: "
        f"plan {_ms_or_not(plan_busy)}, update {_ms_or_not(update_busy)}; "
        f"idle "
        f"{'not measured' if busy is None else f'{1 - busy / step_ms:.0%}'};"
        f" {above:.3f} GiB above what is held; phase 8's host-planned xla "
        f"step {_earlier_ms(was.get('step_ms'))} [{card}]")

    # fit: 10 steps, one validation (evaluation on 8192 pairs).
    strainer.model.load_state_dict(params0)
    strainer.opt.load_state_dict(opt0)
    strainer.seed_dropout(SEED)
    lines = []
    zero_launches(bd, ek)
    summary, t_fit = host_s(lambda: strainer.fit(max_iter=10,
                                                 log=lines.append))
    launches["plan_device fit(10)"] = {**bd.LAUNCHES, **ek.LAUNCHES}
    for line in lines:
        log(f"  fit: {line}")
    log(f"  plan_device fit(max_iter=10), one validation and one test pass "
        f"of 8192 pairs each (host plans): {t_fit:.2f} s [{card}]")
    check(no_kernel_launched(bd, ek)
          and summary["best_iter"] == 10
          and np.isfinite(summary["best_valid_rmse"])
          and sum("Val RMSE" in x for x in lines) == 1,
          f"plan_device fit {summary}")

    # A forced overflow: the update is rejected, fit grows the caps.
    caps0 = dict(strainer.caps)
    strainer.caps = {"user": 4096, "item": 2048}
    before = state_snapshot(strainer)
    st = strainer.train_iteration(strainer._build_batch_safe(rs, recon))
    after = state_snapshot(strainer)
    need = (int(st["needed_user"]), int(st["needed_item"]))
    check(bool(st["overflow"]) and float(st["gnorm"]) == 0.0
          and float(st["sq_err"].abs().sum()) == 0.0,
          f"an overflowed step should report itself: {st}")
    check(states_equal(before, after),
          "an overflowed step changed the parameters or the optimiser")
    count = strainer.opt.count
    lines = []
    summary, t_grow = host_s(lambda: strainer.fit(max_iter=20,
                                                  log=lines.append))
    grown = dict(strainer.caps)
    log(f"  caps cut to {{'user': 4096, 'item': 2048}}: the step needed "
        f"{need}, reported overflow with gnorm 0, and left parameters and "
        f"optimiser bit-equal; fit(max_iter=20) then grew the caps to "
        f"{grown} and applied {strainer.opt.count - count} updates in "
        f"{t_grow:.2f} s: "
        f"{[x for x in lines if 'overflow' in x]} [{card}]")
    check(any("skipped on frontier-cap overflow" in x for x in lines)
          and grown["user"] > 4096 and strainer.opt.count > count
          and np.isfinite(summary["best_valid_rmse"]),
          "fit should grow the caps after an overflow and go on")
    strainer.caps = caps0

    # (d) the dedup path at full width.
    log("== 13 (d). plan_device on the dedup path at full width")
    found = None
    for b in (512, 256, 128, 64, 32, 16):
        caps_b = probed_caps(strainer, b)
        log(f"  probed caps at batch {b}: {caps_b}")
        if caps_b["user"] < n["user"]:
            found = b
            break
    check(found is not None, "no batch gave a user cap below the users")
    del strainer, batch, batches, feed, pp, plan
    torch.cuda.empty_cache()
    settings_d = dataclasses.replace(settings, rating_batch_size=found)
    d, t_make = host_s(lambda: SampledTrainer(
        model_cfg, eval_it, settings_d, fanout=8, backend="xla",
        device=DEVICE, plan_device=True))
    log(f"  SampledTrainer(plan_device=True) at batch {found}: "
        f"{t_make:.2f} s; probed caps {d.caps} [{card}]")
    check(d.caps["user"] < n["user"], "the dedup path's user cap")
    rs = eval_it.rating_sampler(batch_size=d.train_batch, segment="train")
    recon = eval_it.recon_nodes_sampler(batch_size=settings.recon_batch_size)
    batch = d._build_batch_safe(rs, recon)
    feed = d._feed(d._pack_batch(batch))
    (plan, pp, aux), w_err_d = plan_on_card_against_cpu(
        d, feed, f"batch {found}", card)
    check(not aux["identity"]["user"] and not bool(aux["overflow"]),
          "the dedup plan")
    zero_launches(bd, ek)
    stats, t_step = host_s(lambda: d.train_iteration(batch))
    launches["plan_device dedup train_iteration"] = {**bd.LAUNCHES,
                                                     **ek.LAUNCHES}
    check(no_kernel_launched(bd, ek) and not bool(stats["overflow"])
          and bool(torch.isfinite(stats["loss"])), "the dedup step")
    d_busy = device_busy_ms(lambda: d._device_plan(feed))

    # The exclusion the port keeps, against set membership on the host:
    # each batch row's first slot names its own batch partner.
    tab = d._dev_tables
    bu = tab.id2ind["user"].index_select(0, feed["bu"])
    bi = tab.id2ind["item"].index_select(0, feed["bi"])
    ok_b = feed["valid"] > 0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    nbr = torch.randint(0, n["item"], (bu.shape[0], 8), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    nbr[:, 0] = bi
    keep, _ = call_without_waiting(lambda: keep_mask(
        batch_edge_keys(bu, bi, ok_b, n["item"]), bu, nbr, n["item"]))
    bk = (bu.long() * n["item"] + bi.long())[ok_b].cpu().numpy()
    q = (bu.long()[:, None] * n["item"] + nbr.long()).cpu().numpy()
    want = ~np.isin(q, bk)
    check(np.array_equal(keep.cpu().numpy(), want)
          and not want[ok_b.cpu().numpy(), 0].any(),
          "the keep-mask differs from set membership")
    log(f"  dedup step {t_step * 1e3:.1f} ms (first), plan busy "
        f"{_ms_or_not(d_busy)}; the keep-mask of {keep.numel()} slots "
        f"({int((~keep).sum())} excluded) equals set membership of the "
        f"batch pairs [{card}]")
    del d
    torch.cuda.empty_cache()
    return launches, dict(
        caps=caps0, first_step_ms=t_first * 1e3, plan_weight_err=w_err,
        identity_vs_gather=[loss_rel, worst, glob], plan_busy_ms=plan_busy,
        update_busy_ms=update_busy, step_ms=step_ms, draw_ms=draw_ms,
        device_busy_ms=busy, above_held_gib=above, fit_s=t_fit,
        overflow_needed=need, grown_caps=grown,
        dedup=dict(batch=found, caps=caps_b, plan_weight_err=w_err_d,
                   first_step_ms=t_step * 1e3, plan_busy_ms=d_busy))


def run_prefetch_fit(bd, ek, cfg, it, model_cfg, save_dir, card, strainer,
                     earlier):
    """Phase 13 (e): ``SampledTrainer.fit(max_iter=10)`` on ``pallas`` at
    batch 4096, serial and with the prefetch thread, no validation inside
    (the host plans of evaluation would dominate both)."""
    import threading

    import torch

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.train import SampledTrainer, TrainSettings

    if strainer is None:
        settings = TrainSettings.from_cfg(cfg)
        settings.rating_batch_size = 4096
        settings.recon_batch_size = 1024
        gk.set_seed(SEED)
        strainer = SampledTrainer(model_cfg, it, settings, fanout=8,
                                  backend="pallas", device=DEVICE,
                                  save_dir=save_dir, save_id=1)
    params0 = copy.deepcopy(strainer.model.state_dict())
    opt0 = copy.deepcopy(strainer.opt.state_dict())
    s0 = strainer.s
    strainer.s = dataclasses.replace(s0, valid_interval=10 ** 6)
    launches, fits = {}, {}
    try:
        for prefetch in (False, True, True, False):
            strainer.model.load_state_dict(params0)
            strainer.opt.load_state_dict(opt0)
            strainer.seed_dropout(SEED)
            lines = []
            zero_launches(bd, ek)
            summary, t_fit = host_s(lambda: strainer.fit(
                max_iter=10, prefetch=prefetch, log=lines.append))
            path = f"sampled fit(10) prefetch={prefetch}"
            launches[path] = {**bd.LAUNCHES, **ek.LAUNCHES}
            fits.setdefault(path, []).append(t_fit)
            check(launches[path] == {"ell_spmm_fwd_only": 40,
                                     "ell_spmm_transpose": 40,
                                     "ell_sddmm": 0,
                                     **bit_counts(0, 0, 0, 0)},
                  f"{path}: expected 4 + 4 ELL launches a step, got "
                  f"{launches[path]}")
            check(strainer.opt.count == opt0["count"] + 10 and all(
                bool(torch.isfinite(v).all())
                for v in strainer.model.state_dict().values()),
                f"{path}: 10 updates, finite parameters")
            check(not [t for t in threading.enumerate()
                       if t.name == "prefetch"],
                  "a producer thread outlived fit")
    finally:
        strainer.s = s0
        strainer.model.load_state_dict(params0)
        strainer.opt.load_state_dict(opt0)
    was = (earlier.get("sampled_training") or {}).get("fit_s")
    log(f"  sampled pallas fit(max_iter=10) without validation, in turns "
        f"(serial, prefetch, prefetch, serial): serial "
        f"{', '.join(f'{x:.2f}' for x in fits['sampled fit(10) prefetch=False'])}"
        f" s, with the prefetch thread "
        f"{', '.join(f'{x:.2f}' for x in fits['sampled fit(10) prefetch=True'])}"
        f" s; phase 8's "
        f"serial fit with one validation and one test pass "
        f"{_s_or_not(was)} [{card}]")
    return launches, fits


def run_sampling_on_card(bd, ek, cfg, it, model_cfg, trainer, save_dir,
                         card, strainer=None, earlier=None):
    """Phase 13: batch sampling and plan building on the card, and the
    prefetch threads.  Returns the launch counts of each driven path and
    the numbers."""
    import torch

    earlier = earlier or {}
    launches, numbers = {}, {}
    t0 = time.perf_counter()
    log("== 13 (a). TRAIN.DEVICE_SAMPLER at ML-10M on bitdense")
    got, numbers["device_sampler_ml10m"] = run_device_sampler_slice(
        bd, trainer, card, earlier)
    launches.update(got)
    log("== 13 (b). TRAIN.DEVICE_SAMPLER at ML-1M on dense, in a fresh "
        "process")
    numbers["device_sampler_ml1m"] = run_fresh("13b", "device_sampler_ml1m",
                                               card)
    log("== 13 (c). SampledTrainer(plan_device=True) at ML-10M")
    got, numbers["plan_device"] = run_plan_device_slice(
        bd, ek, cfg, it, model_cfg, save_dir, card, earlier)
    launches.update(got)
    torch.cuda.empty_cache()
    log("== 13 (e). sampled fit with the prefetch thread, on pallas")
    got, numbers["prefetch_fit_s"] = run_prefetch_fit(
        bd, ek, cfg, it, model_cfg, save_dir, card, strainer, earlier)
    launches.update(got)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return launches, numbers


# ------------------------ phase 14: the model options ------------------------


def options_cfg(name, **keys):
    """``configs/<name>`` as published with the dotted ``keys`` changed,
    e.g. ``{"MODEL.COMPUTE_DTYPE": "bfloat16"}``."""
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(os.path.join(ROOT, "configs", name))
    for dotted, value in keys.items():
        node = cfg
        *path, leaf = dotted.split(".")
        for key in path:
            node = node[key]
        node[leaf] = value
    return cfg


FEA_KEYS = {"MODEL.USE_FEA_PROJ": True, "FEA.MID_MAP": 16, "FEA.UNITS": 16}


def held_against(name, ref, other, tol):
    """Log and check ``compare_grads(ref, other)`` against ``tol`` = (loss,
    all gradients together, worst single parameter or None); returns the
    numbers."""
    loss_rel, worst, worst_name, glob = compare_grads(ref, other)
    log(f"  {name}: loss rel diff {loss_rel:.3e} (tol {tol[0]:g}), all "
        f"gradients together {glob:.3e} relative (tol {tol[1]:g}), worst "
        f"single parameter {worst:.3e} of its largest entry ({worst_name}"
        + (f"; tol {tol[2]:g})" if tol[2] else "; printed only)"))
    check(loss_rel <= tol[0] and glob <= tol[1]
          and (tol[2] is None or worst <= tol[2]),
          f"{name}: the step's loss or gradients disagree")
    return dict(loss_rel=loss_rel, worst=worst, worst_name=worst_name,
                all=glob)


def peak_above(fn):
    """``(result, seconds, GiB above what is held, peak GiB)`` of one call
    of ``fn``."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, t = host_s(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, t, (peak - held) / 2**30, peak / 2**30


def run_bf16_ml10m(bd, ek, trainer, card):
    """Phase 14 (a): ``MODEL.COMPUTE_DTYPE: bfloat16`` on phase 4's ML-10M
    ``bitdense`` trainer (same parameters, packs and batches), and the bit
    walk at F = 81 beside F = 65 on its packs."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import export_serving

    numbers = {}
    t16 = backend_twin(trainer, compute_dtype="bfloat16")
    t16.save_id = 6     # its fit's checkpoints beside phase 6's
    it, s = trainer.data_iter, trainer.s
    rs = it.rating_sampler(batch_size=s.rating_batch_size, segment="train")
    recon = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    next_batch = lambda: next_batches(trainer, rs, recon)  # noqa: E731
    batch = next_batch()
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: t16.train_iteration(*batch))
    launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  first bf16 train_iteration: {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, launches {launches} [{card}]")
    check(launches == {**bit_counts(4, 4, 0, 0), "ell_spmm_fwd_only": 0,
                       "ell_spmm_transpose": 0, "ell_sddmm": 0},
          f"expected 4 + 4 bit launches in a bf16 step, got {launches}")
    check(bool(torch.isfinite(stats["loss"])), "non-finite bf16 loss")
    check(all(p.dtype == torch.float32 for p in t16.model.parameters())
          and all(v.dtype == torch.float32 for v in t16.opt.mu.values()),
          "parameters and Adam moments must stay float32")
    t16.model.load_state_dict(params0)

    # The same bf16 step through the kernels and through the plain
    # versions fed the same bf16-rounded x and g: phase 6's bound, or twice
    # the spread of the kernel step against its own repeats where that is
    # wider (the atomics' float32 sum orders flip bf16 roundings in the
    # Denses after them, which float32 compute does not round).
    trainer.seed_dropout(SEED)
    k_run = t16.loss_and_grads(*batch)
    spread = []
    for _ in range(3):
        trainer.seed_dropout(SEED)
        spread.append(compare_grads(k_run, t16.loss_and_grads(*batch)))
    spread_all = max(x[3] for x in spread)
    spread_worst = max(x[1] for x in spread)
    log(f"  the bf16 step 3 more times through the kernels, each against the "
        f"first: all gradients together "
        f"{', '.join(f'{x[3]:.3e}' for x in spread)}; worst single parameter "
        f"{', '.join(f'{x[1]:.3e}' for x in spread)}")
    twin = plain_twin(t16)
    trainer.seed_dropout(SEED)
    with bf16_fed_plain_versions(bd):
        p_run = twin.loss_and_grads(*batch)
    del twin
    check(all(g.dtype == torch.float32 for g in k_run[1].values()),
          "bf16 gradients must be float32")
    numbers["repeat_spread"] = dict(all=spread_all, worst=spread_worst)
    numbers["vs_plain"] = held_against(
        "bf16 step, kernels against plain versions fed bf16-rounded x and g",
        p_run, k_run, (1e-3, max(1e-3, 2 * spread_all),
                       max(5e-2, 2 * spread_worst)))
    del k_run, p_run

    # Step time, busy, idle and memory, float32 and bf16 in turns.
    for name, owner in (("float32", trainer), ("bf16", t16),
                        ("bf16 again", t16), ("float32 again", trainer)):
        owner.model.load_state_dict(params0)
        numbers[name] = step_numbers(owner, next_batch, card,
                                     f"ML-10M bitdense {name}")
    t16.model.load_state_dict(params0)
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # fit(20) in bf16: the loss falls; then the export and queries.
    trainer.seed_dropout(SEED)
    losses, lines = [], []
    with recorded_losses(t16, losses):
        summary, t_fit = host_s(lambda: t16.fit(max_iter=20,
                                                log=lines.append))
    losses = [float(x) for x in losses]
    log(f"  bf16 fit(max_iter=20): {t_fit:.2f} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {summary} [{card}]")
    check(len(losses) == 20 and np.isfinite(losses).all()
          and np.mean(losses[10:]) < losses[0], "the bf16 loss should fall")
    numbers["fit_s"] = t_fit

    # Predictions of the trained parameters on 100,000 test pairs, in bf16
    # and in float32 (the seed's parameters predict the mean everywhere).
    pairs = it.test_node_pairs[:, :100_000]
    pu = torch.from_numpy(pairs[0].astype(np.int64)).to(DEVICE)
    pi = torch.from_numpy(pairs[1].astype(np.int64)).to(DEVICE)
    trainer.model.load_state_dict(t16.model.state_dict())
    with torch.no_grad():
        p16, p32 = ((owner._eval_forward("test", pu, pi)
                     - trainer.rating_mean) / trainer.rating_std
                    for owner in (t16, trainer))
    scale = max(float(p32.abs().max()), 1.0)
    diff = float((p16 - p32).abs().max())
    log(f"  trained parameters, bf16 against float32 predictions on "
        f"{pairs.shape[1]:,} test pairs (normalised, largest "
        f"{float(p32.abs().max()):.3f}): max abs diff {diff:.4f} (tol 5% of "
        f"the scale {scale:.3f})")
    check(diff <= 0.05 * scale, "bf16 predictions stray from float32")
    numbers["pred_vs_f32"] = diff / scale
    trainer.model.load_state_dict(params0)

    zero_launches(bd, ek)
    art, t_export = host_s(lambda: export_serving(t16, segment="test"))
    export_launches = dict(bd.LAUNCHES)
    check(export_launches == bit_counts(4, 0, 0, 0),
          f"bf16 export launches {export_launches}")
    check_artifact(art, ML10M)
    check_queries(art, card, "bf16 trained parameters")
    numbers["export_s"] = t_export
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    del t16, art

    # The bit walk at F = 81 (feature projection's 64 + 16 + the ones
    # column) beside F = 65 on the same ML-10M packs.
    R = trainer.model_cfg.num_links
    train_pack = trainer.variants.bit_pack("train")
    test_pack = trainer.variants.bit_pack("test")
    walks = {}
    for F in (65, 81):
        e_worst, e_shapes = full_expand_checks(bd, test_pack, R, F, card)
        r_worst, r_shapes = full_reduce_checks(bd, train_pack, R, F, card)
        adjoint_check(bd, train_pack, R, F)
        walks[F] = dict(expand=e_shapes, reduce=r_shapes,
                        worst=max(e_worst, r_worst))
    numbers["walk_by_f"] = walks
    return numbers, {"bf16 train_iteration": launches,
                     "bf16 export": export_launches}, walks


def ml1m_archive(cfg, data_root, card):
    """``build_dataset``'s result for ``cfg`` on phase 12's ML-1M-format
    archive under ``data_root``, written first where it is not there."""
    from stargcn_tpu_torch.predict import build_dataset

    if os.path.exists(os.path.join(data_root, "ml-1m", "ratings.dat")):
        built, t = host_s(lambda: build_dataset(cfg, data_root))
        log(f"  build_dataset on the archive phase 12 wrote: {t:.2f} s "
            f"[{card}]")
        return built
    return build_inductive_ml1m(cfg, data_root, card)[0]


def run_fea_proj_ml1m(bd, ek, card, save_dir):
    """Phase 14 (b): ``MODEL.USE_FEA_PROJ`` on the inductive ML-1M archive:
    ``dense`` (``auto``), the same batch on ``bitdense`` (the walk at F =
    81) and sampled ``pallas``; ``RECON_FEA``; feature-only input."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import export_serving
    from stargcn_tpu_torch.train import (SampledTrainer, Trainer,
                                         TrainSettings, sampled_loop)

    os.environ["STARGCN_AUTO_DOWNLOAD"] = "0"
    data_root = os.path.join(save_dir, "movielens")
    cfg = options_cfg("inductive_ml_1m_item_10.yml", **FEA_KEYS)
    _, it, model_cfg = ml1m_archive(cfg, data_root, card)
    check(model_cfg.backend == "dense" and model_cfg.use_fea_proj
          and model_cfg.fea_units == 16, f"model config {model_cfg}")
    fea_dims = {k: it.all_graph.features[k].shape[1]
                for k in ("user", "movie")}
    log(f"  raw feature widths {fea_dims} (user: age, gender, occupation "
        f"one-hot; movie: the 300-d title vector, year, genre one-hots)")
    numbers, launches = {"feature_dims": fea_dims}, {}
    trainer = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                      save_dir=os.path.join(save_dir, "fea1m"),
                      device=DEVICE)
    fu, fi = trainer.features()
    check(fu.device.type == torch.device(DEVICE).type
          and tuple(fu.shape) == (ML1M["num_users"], fea_dims["user"]),
          "the features should sit on the card")
    check(trainer.model.enc_b0.l0.agg_user_item.weight.shape[1] == 80,
          "the first block's input should be 64 + 16 wide")
    s = trainer.s
    rs = it.rating_sampler(batch_size=s.rating_batch_size, segment="train")
    recon = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    next_batch = lambda: next_batches(trainer, rs, recon)  # noqa: E731
    batch = next_batch()
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())

    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t_first = host_s(lambda: trainer.train_iteration(*batch))
    log(f"  first train_iteration with USE_FEA_PROJ (dense): "
        f"{t_first * 1e3:.1f} ms, loss {float(stats['loss']):.4f} [{card}]")
    check(no_kernel_launched(bd, ek) and bool(torch.isfinite(stats["loss"])),
          "the dense feature step")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)
    numbers["dense_step"] = step_numbers(trainer, next_batch, card,
                                         "inductive dense USE_FEA_PROJ")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # The same batch on bitdense: the bit pair at F = 81.
    bit = backend_twin(trainer, backend="bitdense")
    trainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    b_stats, t_bit = host_s(lambda: bit.train_iteration(*batch))
    launches["USE_FEA_PROJ bitdense train_iteration (F = 81)"] = \
        bit_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  bitdense train_iteration with USE_FEA_PROJ (packs built in the "
        f"call): {t_bit * 1e3:.1f} ms, loss {float(b_stats['loss']):.4f}, "
        f"launches {bit_launches} [{card}]")
    check(bit_launches == {**bit_counts(4, 4, 0, 0), "ell_spmm_fwd_only": 0,
                           "ell_spmm_transpose": 0, "ell_sddmm": 0},
          f"expected 4 + 4 bit launches at F = 81, got {bit_launches}")
    bit.model.load_state_dict(params0)
    runs = {}
    for name, owner in (("dense", trainer), ("bitdense", bit)):
        trainer.seed_dropout(SEED)
        runs[name] = owner.loss_and_grads(*batch)
    twin = plain_twin(bit)
    trainer.seed_dropout(SEED)
    with bf16_fed_plain_versions(bd):
        runs["plain"] = twin.loss_and_grads(*batch)
    del twin
    numbers["bitdense_vs_plain"] = held_against(
        "F = 81: bitdense against its plain versions fed bf16-rounded x and "
        "g", runs["plain"], runs["bitdense"], (1e-3, 1e-3, 5e-2))
    numbers["bitdense_vs_dense"] = held_against(
        "F = 81: bitdense against dense (bf16 adjacency)", runs["dense"],
        runs["bitdense"], (1e-2, 1e-1, None))
    del runs, bit
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    # fit, evaluation, export, queries.
    trainer.seed_dropout(SEED)
    lines = []
    summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                log=lines.append))
    log(f"  fit(max_iter=20) with USE_FEA_PROJ: {t_fit:.2f} s; {summary} "
        f"[{card}]")
    rmses = [summary["best_valid_rmse"], *summary["best_test_rmse"]]
    check(summary["best_iter"] in (10, 20) and np.isfinite(rmses).all()
          and max(rmses) <= trainer.rating_max - trainer.rating_min,
          f"fit summary {summary}")
    numbers["fit_s"] = t_fit
    valid = trainer.evaluate("valid")
    art, t_export = host_s(lambda: export_serving(trainer, segment="test"))
    check_artifact(art, ML1M)
    check_queries(art, card, "USE_FEA_PROJ inductive ML-1M")
    log(f"  evaluate('valid') {valid}; export_serving {t_export:.3f} s "
        f"[{card}]")
    numbers["export_s"] = t_export
    del art

    # RECON_FEA: the decoder reconstructs [embedding, projected features].
    rcfg = dataclasses.replace(model_cfg, recon_fea=True)
    rtrainer = Trainer(rcfg, it, TrainSettings.from_cfg(cfg), device=DEVICE)
    rtrainer.variants = trainer.variants
    r_stats, t_r = host_s(lambda: rtrainer.train_iteration(*batch))
    check(rtrainer.model.embed_map_b0_user_l1.out_features == 80
          and bool(torch.isfinite(r_stats["loss"])), "the RECON_FEA step")
    log(f"  RECON_FEA train_iteration: {t_r * 1e3:.1f} ms, loss "
        f"{float(r_stats['loss']):.4f} (decoder 80 wide) [{card}]")
    del rtrainer

    # Feature-only input: NBLOCKS 1, no DAE (the reference's own limit).
    ocfg = dataclasses.replace(model_cfg, use_embed=False, nblocks=1,
                               use_dae=False)
    osettings = TrainSettings.from_cfg(cfg)
    osettings.use_dae = False
    otrainer = Trainer(ocfg, it, osettings, device=DEVICE)
    otrainer.variants = trainer.variants
    check(not any(k.startswith(("embed_user", "embed_item"))
                  for k in otrainer.model.state_dict()),
          "feature-only input has no embedding tables")
    o_rb = batch[0]
    o_cb = (np.arange(ML1M["num_users"], dtype=np.int32),
            np.arange(ML1M["num_items"], dtype=np.int32),
            np.zeros(ML1M["num_users"], np.float32),
            np.zeros(ML1M["num_items"], np.float32))
    o_stats, t_o = host_s(lambda: otrainer.train_iteration(o_rb, o_cb))
    o_art = export_serving(otrainer, segment="test")
    check(bool(torch.isfinite(o_stats["loss"]))
          and np.isfinite(o_art.user_feats).all(), "feature-only step")
    log(f"  USE_EMBED false, NBLOCKS 1: train_iteration {t_o * 1e3:.1f} ms, "
        f"loss {float(o_stats['loss']):.4f}; export {o_art.user_feats.shape}"
        f" [{card}]")
    del otrainer, o_art, trainer
    torch.cuda.empty_cache()

    # Sampled pallas with features, phase 8's settings.
    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    strainer = SampledTrainer(model_cfg, it, settings, fanout=8,
                              backend="pallas", device=DEVICE)
    srs = it.rating_sampler(batch_size=strainer.train_batch,
                            segment="train")
    srecon = it.recon_nodes_sampler(batch_size=settings.recon_batch_size)
    sbatch = strainer._build_batch_safe(srs, srecon)
    sparams0 = copy.deepcopy(strainer.model.state_dict())
    strainer.seed_dropout(SEED)
    zero_launches(bd, ek)
    s_stats, t_s = host_s(lambda: strainer.train_iteration(sbatch))
    launches["USE_FEA_PROJ sampled train_iteration"] = \
        s_launches = {**bd.LAUNCHES, **ek.LAUNCHES}
    log(f"  sampled pallas train_iteration with USE_FEA_PROJ: "
        f"{t_s * 1e3:.1f} ms, loss {float(s_stats['loss']):.4f}, launches "
        f"{s_launches} [{card}]")
    check(s_launches == {"ell_spmm_fwd_only": 4, "ell_spmm_transpose": 4,
                         "ell_sddmm": 0, **bit_counts(0, 0, 0, 0)},
          f"expected 4 + 4 ELL launches, got {s_launches}")

    def fixed():
        strainer.model.load_state_dict(sparams0)
        strainer.seed_dropout(SEED)
        return sampled_loop._loss_and_grads(
            strainer, strainer._feed(strainer._pack_batch(sbatch)))

    k_run = fixed()
    with plain_ell_versions(ek):
        p_run = fixed()
    numbers["sampled_vs_plain"] = held_against(
        "sampled USE_FEA_PROJ step, ELL kernels against the plain twin",
        p_run, k_run, (1e-5, 1e-4, 1e-3))
    del k_run, p_run, strainer
    torch.cuda.empty_cache()
    return numbers, launches


def run_per_edge_dropout(bd, ek, trainer10m, card):
    """Phase 14 (c): ``GCN.DROPOUT_PER_EDGE`` (forced to ``xla``) on phase
    11's ML-1M graph beside the per-node ``xla`` step, then one ML-10M step
    in that mode."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.models import aggregators, build_model_config
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    numbers = {}
    cfg, it, _ = build_ml1m()
    cfg.GCN.DROPOUT_PER_EDGE = True
    csr = it.all_graph["user", "movie"]
    model_cfg = build_model_config(cfg, csr.shape[0], csr.shape[1],
                                   len(csr.multi_link), num_edges=csr.nnz)
    check(model_cfg.backend == "xla" and model_cfg.dropout_per_edge,
          "DROPOUT_PER_EDGE should force the xla backend")
    edge = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                   device=DEVICE)
    node = backend_twin(edge, dropout_per_edge=False)
    rs = it.rating_sampler(batch_size=edge.s.rating_batch_size,
                           segment="train")
    recon = it.recon_nodes_sampler(batch_size=edge.s.recon_batch_size)
    next_batch = lambda: next_batches(edge, rs, recon)  # noqa: E731
    params0 = copy.deepcopy(edge.model.state_dict())
    for name, owner in (("per-node xla", node), ("per-edge", edge),
                        ("per-edge again", edge),
                        ("per-node xla again", node)):
        owner.model.load_state_dict(params0)
        numbers[name] = step_numbers(owner, next_batch, card,
                                     f"ML-1M {name}")
    edge.model.load_state_dict(params0)
    node.model.load_state_dict(params0)
    pairs = it.test_node_pairs
    pu = torch.from_numpy(pairs[0].astype(np.int64)).to(DEVICE)
    pi = torch.from_numpy(pairs[1].astype(np.int64)).to(DEVICE)
    with torch.no_grad():
        a = edge._eval_forward("test", pu, pi)
        b = node._eval_forward("test", pu, pi)
    diff = float((a - b).abs().max())
    log(f"  eval on {pairs.shape[1]:,} test pairs, per-edge against "
        f"per-node: max abs diff {diff:.3e} (tol 1e-5)")
    check(diff <= 1e-5, "per-edge eval should equal the per-node eval")
    numbers["eval_diff"] = diff

    # The keep rate of one training step's masks.
    kept = []
    real = aggregators.dropout

    def counting(x, rate, train, generator=None):
        out = real(x, rate, train, generator)
        live = x != 0
        kept.append((int((out != 0).sum()), int(live.sum())))
        return out

    aggregators.dropout = counting
    try:
        edge.seed_dropout(SEED)
        edge.train_iteration(*next_batch())
    finally:
        aggregators.dropout = real
    k, n = map(sum, zip(*kept))
    rate = edge.model_cfg.gcn_dropout
    sd = (rate * (1 - rate) / n) ** 0.5
    log(f"  one step's per-edge masks: {len(kept)} gathers, {n:,} live "
        f"elements, kept {k / n:.5f} (1 - p = {1 - rate:g}, 5 sd "
        f"{5 * sd:.1e})")
    check(abs(k / n - (1 - rate)) <= 5 * sd, "the per-edge keep rate")
    numbers["keep_rate"] = k / n
    del edge, node
    torch.cuda.empty_cache()

    # One ML-10M step in that mode: its (E, 65) float32 messages.
    edge10 = backend_twin(trainer10m, backend="xla", dropout_per_edge=True,
                          edge_chunk=None)
    it10, s10 = trainer10m.data_iter, trainer10m.s
    b10 = next_batches(trainer10m, it10.rating_sampler(
        batch_size=s10.rating_batch_size, segment="train"),
        it10.recon_nodes_sampler(batch_size=s10.recon_batch_size))
    trainer10m.seed_dropout(SEED)
    zero_launches(bd, ek)
    stats, t10, above, peak = peak_above(
        lambda: edge10.train_iteration(*b10))
    log(f"  ML-10M per-edge step: {t10 * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}; peak device memory {peak:.3f} GiB, "
        f"{above:.3f} GiB above what is held ({10_000_000 * 65 * 4 / 2**30:.2f}"
        f" GiB is one (E, 65) float32 message) [{card}]")
    check(no_kernel_launched(bd, ek) and bool(torch.isfinite(stats["loss"])),
          "the ML-10M per-edge step")
    numbers["ml10m"] = dict(step_ms=t10 * 1e3, step_gib=above,
                            peak_gib=peak)
    del edge10
    torch.cuda.empty_cache()
    return numbers


def run_sampled_options(bd, ek, cfg, it, model_cfg, strainer, save_dir,
                        card):
    """Phase 14 (d), (e): ``remat`` on phase 8's host-planned ``pallas``
    trainer and on a ``plan_device`` ``xla`` trainer at ML-10M, then bf16
    on the ``plan_device`` trainer."""
    import torch

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.train import (SampledTrainer, TrainSettings,
                                         sampled_loop)

    numbers, launches = {}, {}
    if strainer is None:
        settings = TrainSettings.from_cfg(cfg)
        settings.rating_batch_size = 4096
        settings.recon_batch_size = 1024
        gk.set_seed(SEED)
        strainer, t_make = host_s(lambda: SampledTrainer(
            model_cfg, it, settings, fanout=8, backend="pallas",
            device=DEVICE, save_dir=save_dir, save_id=4))
        log(f"  SampledTrainer (pallas, batch 4096, fanout 8): {t_make:.2f}"
            f" s; caps {strainer.caps} [{card}]")
    rs = it.rating_sampler(batch_size=strainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=strainer.s.recon_batch_size)
    feed = strainer._feed(strainer._pack_batch(
        strainer._build_batch_safe(rs, recon)))
    params0 = copy.deepcopy(strainer.model.state_dict())

    def run(owner, feed, remat, **kw):
        owner.model.load_state_dict(params0)
        owner.remat = remat
        owner.seed_dropout(SEED)
        return sampled_loop._loss_and_grads(owner, feed, **kw)

    def remat_pair(owner, feed, what, **kw):
        out = {}
        for remat in (False, True, True, False):
            zero_launches(bd, ek)
            res, t, above, _ = peak_above(lambda: run(owner, feed, remat,
                                                      **kw))
            out.setdefault(remat, []).append(dict(
                ms=t * 1e3, gib_above=above, run=res,
                launches={**bd.LAUNCHES, **ek.LAUNCHES}))
        owner.remat = False
        for remat in (False, True):
            r = out[remat]
            log(f"  {what} loss_and_grads, remat {remat}: "
                f"{r[0]['ms']:.2f} / {r[1]['ms']:.2f} ms, "
                f"{r[0]['gib_above']:.3f} / {r[1]['gib_above']:.3f} GiB above"
                f" what is held, launches {r[0]['launches']} [{card}]")
        same = held_against(
            f"{what}: remat against no remat, dropout "
            f"{owner.model_cfg.gcn_dropout} from one generator state",
            out[False][0]["run"], out[True][0]["run"], (1e-5, 1e-4, 1e-3))
        return dict(same=same, **{
            f"remat_{r}": [dict(ms=x["ms"], gib_above=x["gib_above"])
                           for x in out[r]] for r in (False, True)}), \
            out[True][0]["launches"]

    numbers["pallas"], launches["sampled remat loss_and_grads"] = \
        remat_pair(strainer, feed, "host-planned pallas")
    check(launches["sampled remat loss_and_grads"]["ell_spmm_transpose"]
          == 4, "remat: 4 transposes a step")
    strainer.model.load_state_dict(params0)
    del feed

    # plan_device on xla, f32 and bf16 (e), with and without remat (d).
    settings = TrainSettings.from_cfg(cfg)
    settings.rating_batch_size = 4096
    settings.recon_batch_size = 1024
    eval_it = cut_eval(it, 8192)
    dtr = SampledTrainer(model_cfg, eval_it, settings, fanout=8,
                         backend="xla", device=DEVICE, plan_device=True,
                         save_dir=save_dir, save_id=5)
    drs = eval_it.rating_sampler(batch_size=dtr.train_batch,
                                 segment="train")
    drecon = eval_it.recon_nodes_sampler(batch_size=settings.recon_batch_size)
    dfeed = dtr._feed(dtr._pack_batch(dtr._build_batch_safe(drs, drecon)))
    plan, pp, aux = dtr._device_plan(dfeed)
    full = dict(dfeed, plan=dict(plan, pairs_pos=pp))
    params0 = copy.deepcopy(dtr.model.state_dict())
    numbers["plan_device"], _ = remat_pair(dtr, full, "plan_device xla",
                                           identity=aux["identity"])
    del full, plan, pp

    d16 = copy.copy(dtr)
    d16.model_cfg = dataclasses.replace(model_cfg,
                                        compute_dtype="bfloat16")
    batches = [dtr._build_batch_safe(drs, drecon) for _ in range(12)]
    for name, owner in (("float32", dtr), ("bf16", d16), ("bf16 again", d16),
                        ("float32 again", dtr)):
        owner.model.load_state_dict(params0)
        times = []
        for b in batches[:6]:
            _, t = host_s(lambda: owner.train_iteration(b))
            times.append(t * 1e3)
        step_ms = median(times[1:])
        events = device_events(lambda: owner.train_iteration(batches[6]))
        busy, top = device_busy_ms(None, top=8, events=events)
        # What bf16 turns the products into: the kernels named bf16.
        named = [(n[:60], ms, c) for n, ms, c in events
                 if "bf16" in n.lower() or "bfloat16" in n.lower()]
        numbers[f"plan_device {name}"] = dict(step_ms=step_ms, busy_ms=busy,
                                              top=top, bf16_ops=named)
        log(f"  plan_device xla {name}: step {step_ms:.2f} ms (median of "
            f"{', '.join(f'{x:.2f}' for x in times[1:])}), busy "
            f"{_ms_or_not(busy)}, idle "
            + ("not measured" if busy is None else f"{1 - busy / step_ms:.0%}")
            + "; top device operations: "
            + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top)
            + "; kernels named bf16: "
            + ("; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in named)
               or "none")
            + f" [{card}]")
    dtr.model.load_state_dict(params0)
    del d16, dtr, batches
    torch.cuda.empty_cache()
    return numbers, launches


def run_options_cli(bd, ek, card, save_dir):
    """Phase 14 (f): the train CLI on a YAML with ``USE_FEA_PROJ`` and
    bf16 over the inductive ML-1M archive, full-graph and then with
    ``--num_neighbors 8 --remat``."""
    import logging

    import numpy as np
    import yaml

    from stargcn_tpu_torch.train import __main__ as train_cli

    data_root = os.path.join(save_dir, "movielens")
    numbers = {}
    for name, extra, batch in (
            ("full-graph", [], {}),
            ("sampled remat", ["--num_neighbors", "8", "--backend", "pallas",
                               "--remat"],
             {"TRAIN.RATING_BATCH_SIZE": 4096,
              "TRAIN.RECON_BATCH_SIZE": 1024})):
        # The config as published, the options, and (sampled) phase 8's
        # batch sizes.
        cfg = options_cfg("inductive_ml_1m_item_10.yml", **FEA_KEYS,
                          **{"MODEL.COMPUTE_DTYPE": "bfloat16"}, **batch)
        path = os.path.join(save_dir, f"options_{name.split()[0]}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(json.loads(json.dumps(cfg)), f)
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        try:
            result, t = host_s(lambda: train_cli.main([
                "--cfg", path, "--data_root", data_root, "--save_dir",
                os.path.join(save_dir, "cli_options", name.split()[0]),
                "--max_iter", "10", "--silent", "--device", DEVICE,
                *extra]))
        finally:
            for h in list(root.handlers):
                if h not in handlers:
                    h.close()
            root.handlers[:] = handlers
            root.setLevel(level)
        log(f"  train CLI, USE_FEA_PROJ + bf16, {name}: {t:.2f} s, best "
            f"valid RMSE {result['best_valid_rmse']:.4f} [{card}]")
        check(result["best_iter"] == 10
              and np.isfinite(result["best_valid_rmse"]),
              f"options CLI result {result}")
        numbers[name] = t
    return numbers


def run_model_options(bd, ek, cfg, it, model_cfg, trainer, save_dir, card,
                      strainer=None):
    """Phase 14: the model options at full width.  Returns the launch
    counts of its kernel paths and its numbers."""
    import torch

    t0 = time.perf_counter()
    numbers, launches = {}, {}
    log("  (a) bf16 compute at ML-10M, bitdense")
    numbers["bf16_ml10m"], paths, walks = run_bf16_ml10m(bd, ek, trainer,
                                                         card)
    launches.update(paths)
    torch.cuda.empty_cache()
    log("  (b) feature projection, inductive ML-1M")
    numbers["fea_proj_ml1m"], paths = run_fea_proj_ml1m(bd, ek, card,
                                                        save_dir)
    launches.update(paths)
    log("  (c) per-edge dropout")
    numbers["per_edge_dropout"] = run_per_edge_dropout(bd, ek, trainer, card)
    log("  (d), (e) sampled remat and bf16 at ML-10M")
    numbers["sampled"], paths = run_sampled_options(
        bd, ek, cfg, it, model_cfg, strainer, save_dir, card)
    launches.update(paths)
    log("  (f) the train CLI with the options")
    numbers["cli_s"] = run_options_cli(bd, ek, card, save_dir)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return launches, numbers, walks


# ---------------- ranking, the ell backend and resilience ----------------


RANK_N, RANK_K = 100, 10


def trained_parameters(trainer, save_dir, card):
    """The trained ML-10M parameters: phase 6's best checkpoint where the
    whole script made one, else those of a 20-step ``fit`` of ``trainer``
    (which writes it).  The trainer's own parameters and optimiser are
    left as they were."""
    import torch

    path = os.path.join(save_dir, "ckpt_best_0.pt")
    if not os.path.exists(path):
        params0 = copy.deepcopy(trainer.model.state_dict())
        opt0 = copy.deepcopy(trainer.opt.state_dict())
        _, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                              log=lambda *_: None))
        log(f"  fit(max_iter=20) for the trained artifact: {t_fit:.2f} s "
            f"[{card}]")
        trainer.model.load_state_dict(params0)
        trainer.opt.load_state_dict(opt0)
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def ranking_artifacts(trainer, save_dir, card):
    """``{"seed", "trained", "gaussian"}`` artifacts of the ML-10M graph:
    the export of seed-123 parameters, of the trained parameters, and
    i.i.d. N(0, 1) tables of the same shapes."""
    import numpy as np

    from stargcn_tpu_torch.serve import (ServingArtifact, ServingState,
                                         export_serving)

    state = ServingState(trainer.model_cfg, trainer.data_iter, device=DEVICE,
                         seed=SEED, variants=trainer.variants)
    arts = {"seed": export_serving(state, segment="test")}
    state.model.load_state_dict(trained_parameters(trainer, save_dir, card))
    arts["trained"] = export_serving(state, segment="test")
    rng = np.random.RandomState(SEED)
    seed_art = arts["seed"]
    arts["gaussian"] = ServingArtifact(
        user_feats=rng.randn(*seed_art.user_feats.shape).astype(np.float32),
        item_feats=rng.randn(*seed_art.item_feats.shape).astype(np.float32),
        rating_mean=seed_art.rating_mean, rating_std=seed_art.rating_std,
        rating_min=seed_art.rating_min, rating_max=seed_art.rating_max,
        rated_indptr=seed_art.rated_indptr,
        rated_items=seed_art.rated_items)
    for art in arts.values():
        check_artifact(art, ML10M)
    return arts


def check_device_draw(trainer, gen, uu, card):
    """One batch of device negatives (4096 positives x 100), drawn under
    ``torch.cuda.set_sync_debug_mode("error")`` behind a busy card, then
    checked on the host: inside ``[0, num_items)`` and no candidate an
    edge of the all-edges graph."""
    import numpy as np
    import torch

    from stargcn_tpu_torch import ranking

    indptr, cols, free, max_deg = ranking._gen_device_tables(gen, DEVICE)
    uu_b = torch.from_numpy(uu[:4096]).to(DEVICE)
    index = torch.arange(4096, device=DEVICE)
    iters = ranking.bisect_iters(max_deg)

    def draw():
        return ranking._draw_device_negatives(
            indptr, cols, free, uu_b, ranking._uniforms(SEED, index, RANK_N),
            iters)

    draw()
    neg, host_ms = call_without_waiting(draw)
    neg = neg.cpu().numpy()
    ni = trainer.model_cfg.num_items
    q = uu[:4096, None].astype(np.int64) * ni + neg
    csr = trainer.variants.all_csr
    edges = np.sort(csr.row_indices.astype(np.int64) * csr.shape[1]
                    + csr.end_points)
    pos = np.clip(np.searchsorted(edges, q), 0, edges.size - 1)
    hits = int((edges[pos] == q).sum())
    log(f"  one batch of device negatives (4096 x {RANK_N}, {iters} bisect "
        f"steps): {host_ms:.2f} ms on the host behind a busy card with every "
        f"wait an error; range [{neg.min()}, {neg.max()}] of {ni} items, "
        f"{hits} of {neg.size} candidates are edges [{card}]")
    check(neg.min() >= 0 and neg.max() < ni, "a negative outside the items")
    check(hits == 0, "a device negative is an edge of the graph")
    return dict(host_ms=host_ms, bisect_iters=iters)


def run_ranking_ml10m(trainer, save_dir, card):
    """Phase 15 (a): ``rank_eval`` at ML-10M on the test segment (HR@10 and
    NDCG@10 against 100 device negatives) for the seed, trained and
    Gaussian artifacts; host negatives on 100,000 positives through
    ``rank_eval_from_iterator``; batch-size invariance; one batch of device
    negatives checked on the host; the predict CLI's ``--rank_eval``."""
    import io

    import numpy as np

    from stargcn_tpu_torch import predict
    from stargcn_tpu_torch.data import NegEdgeGenerator
    from stargcn_tpu_torch.ranking import rank_eval, rank_eval_from_iterator

    numbers = {}
    it = trainer.data_iter
    arts, t_arts = host_s(lambda: ranking_artifacts(trainer, save_dir, card))
    log(f"  artifacts (seed export, trained export, Gaussian): {t_arts:.2f} s "
        f"[{card}]")
    csr = it.all_graph[it.name_user, it.name_item]
    pairs = it.test_node_pairs
    uu = np.asarray(csr.row_id_to_ind(pairs[0]), np.int64)
    ii = np.asarray(csr.col_id_to_ind(pairs[1]), np.int64)
    gen, t_gen = host_s(lambda: NegEdgeGenerator(np.random.RandomState(0),
                                                  csr))
    log(f"  {uu.size:,} test positives; NegEdgeGenerator over the all-edges "
        f"graph: {t_gen:.2f} s on the host [{card}]")
    for name in ("gaussian", "seed", "trained"):
        out, t = host_s(lambda: rank_eval(
            arts[name], uu, ii, gen, num_negatives=RANK_N, k=RANK_K,
            device=DEVICE))
        numbers[name] = dict(hr=out["hr"], ndcg=out["ndcg"], s=t,
                             positives_per_s=out["num_positives"] / t,
                             rankable=out["num_rankable"])
        log(f"  rank_eval {name} (device negatives, batch 4096): "
            f"HR@{RANK_K} {out['hr']:.5f}, NDCG@{RANK_K} {out['ndcg']:.5f} "
            f"over {out['num_rankable']:,} rankable of "
            f"{out['num_positives']:,}; {t:.3f} s, "
            f"{out['num_positives'] / t:,.0f} positives/s [{card}]")
    busy, top = device_busy_ms(lambda: rank_eval(
        arts["trained"], uu, ii, gen, num_negatives=RANK_N, k=RANK_K,
        device=DEVICE), top=6)
    numbers["trained"]["device_busy_ms"] = busy
    log(f"  rank_eval trained under the profiler: device busy {busy} ms; "
        + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top)
        + f" [{card}]")
    chance = RANK_K / (RANK_N + 1)
    check(abs(numbers["gaussian"]["hr"] - chance) <= 0.01,
          f"Gaussian artifact HR {numbers['gaussian']['hr']} not within "
          f"0.01 of {chance:.4f}")
    small, t = host_s(lambda: rank_eval(
        arts["trained"], uu, ii, gen, num_negatives=RANK_N, k=RANK_K,
        batch_size=1000, device=DEVICE))
    log(f"  the trained artifact at batch 1000: HR {small['hr']:.6f} "
        f"(batch 4096: {numbers['trained']['hr']:.6f}), NDCG diff "
        f"{abs(small['ndcg'] - numbers['trained']['ndcg']):.2e}; {t:.3f} s "
        f"[{card}]")
    check(small["hr"] == numbers["trained"]["hr"],
          "device-negative HR depends on the batch size")
    host, t = host_s(lambda: rank_eval_from_iterator(
        arts["trained"], it, num_negatives=RANK_N, k=RANK_K,
        max_positives=100_000, negatives="host", device=DEVICE))
    numbers["trained_host_100k"] = dict(hr=host["hr"], ndcg=host["ndcg"],
                                        s=t)
    log(f"  rank_eval_from_iterator, trained, host negatives on "
        f"{host['num_positives']:,} positives: HR {host['hr']:.5f}, NDCG "
        f"{host['ndcg']:.5f}; {t:.2f} s (generator and numpy draws "
        f"included) [{card}]")
    check(abs(host["hr"] - numbers["trained"]["hr"]) <= 0.01,
          "host and device negatives disagree on the trained HR")
    numbers["device_draw"] = check_device_draw(trainer, gen, uu, card)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, t_cli = host_s(lambda: predict.main([
            "--cfg", os.path.join(ROOT, "configs", "transductive_ml_1m.yml"),
            "--dataset", "synthetic", "--rank_eval", "--device", DEVICE]))
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    rank = [x for x in lines if x.get("mode") == "rank_eval"]
    check(len(rank) == 1 and 0 <= rank[0]["ndcg"] <= rank[0]["hr"] <= 1,
          f"predict --rank_eval printed {lines}")
    log(f"  python -m stargcn_tpu_torch.predict --cfg "
        f"configs/transductive_ml_1m.yml --dataset synthetic --rank_eval: "
        f"{json.dumps(rank[0])} in {t_cli:.2f} s [{card}]")
    numbers["cli_s"] = t_cli
    return numbers, arts


def recommend_parts(pred, users, k=10):
    """``Predictor.recommend`` for one batch of users, its body written out
    with a clock at each part: the numpy rated lists, the host-to-device
    copies, the launches of the product, the scatter and ``topk``, and the
    two ``.cpu()`` reads; the device part by CUDA events.  Returns
    ``((idx, vals), parts)`` with ms per part."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import NEG_INF

    art, dev = pred.art, pred.device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    parts = {}
    t0 = time.perf_counter()
    pu = torch.from_numpy(users).to(dev)
    t1 = time.perf_counter()
    lo = art.rated_indptr[users]
    deg = art.rated_indptr[users + 1] - lo
    pad = max(int(deg.max(initial=0)), 1)
    col = np.arange(pad)
    valid = col[None, :] < deg[:, None]
    pos = np.where(valid, lo[:, None] + col[None, :], 0)
    rated = np.where(valid, art.rated_items[pos], 0)
    t2 = time.perf_counter()
    rated_d = torch.from_numpy(rated.astype(np.int64)).to(dev)
    fill_d = torch.from_numpy(valid.astype(np.float32) * NEG_INF).to(dev)
    t3 = time.perf_counter()
    start.record()
    scores = pred._U[pu] @ pred._I.T
    scores.scatter_add_(1, rated_d, fill_d)
    vals, idx = torch.topk(scores, k, dim=1)
    end.record()
    t4 = time.perf_counter()
    out = (idx.cpu().numpy(), pred._denorm(vals).cpu().numpy())
    t5 = time.perf_counter()
    parts = dict(copy_users_ms=(t1 - t0) * 1e3, rated_lists_ms=(t2 - t1)
                 * 1e3, copy_rated_ms=(t3 - t2) * 1e3,
                 launches_ms=(t4 - t3) * 1e3, cpu_reads_ms=(t5 - t4) * 1e3,
                 device_ms=start.elapsed_time(end), total_ms=(t5 - t0) * 1e3,
                 rated_width=pad)
    return out, parts


def run_query_latency_fresh(card):
    """Phase 15 (b), in a process that ran nothing else on the card
    (``--phases 15b``): ``recommend(k=10)`` for check_queries' 256 users on
    the trained and the seed ML-10M artifacts (saved by the parent), in
    turns, in the order ``CHIP_SMOKE_QUERY_ORDER`` names; each call timed as
    ``check_queries`` times it (after its ``predict``), with whether the
    stream was idle when the window opened, then its parts
    (``recommend_parts``), then the profiler's device time by kernel.
    With ``CHIP_SMOKE_QUERY_WARM`` set, the product, the scatter and
    ``topk`` of a recommend are first run once each, timed, on tensors of
    the same shapes, before any recommend."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.serve import Predictor, ServingArtifact

    root = os.environ["CHIP_SMOKE_ARTIFACTS"]
    order = os.environ.get("CHIP_SMOKE_QUERY_ORDER", "trained,seed")
    order = order.split(",")
    arts = {n: ServingArtifact.load(os.path.join(root, f"{n}.npz"))
            for n in order}
    preds = {n: Predictor(arts[n], device=DEVICE) for n in order}
    rng = np.random.RandomState(SEED)
    uu = rng.randint(0, arts[order[0]].num_users, 4096)
    ii = rng.randint(0, arts[order[0]].num_items, 4096)
    users = rng.choice(arts[order[0]].num_users, 256, replace=False)
    calls = []
    if os.environ.get("CHIP_SMOKE_QUERY_WARM"):
        pred = preds[order[0]]
        pu = torch.from_numpy(users).to(DEVICE)
        scores, t_mm = host_s(lambda: pred._U[pu] @ pred._I.T)
        idx = torch.zeros(256, 174, dtype=torch.int64, device=DEVICE)
        fill = torch.zeros(256, 174, device=DEVICE)
        _, t_sc = host_s(lambda: scores.scatter_add_(1, idx, fill))
        _, t_tk = host_s(lambda: torch.topk(scores, 10, dim=1))
        calls.append(dict(first_use_ms=dict(product=t_mm * 1e3,
                                            scatter_add=t_sc * 1e3,
                                            topk=t_tk * 1e3)))
    for rnd in range(3):
        for name in order:
            pred = preds[name]
            host_s(lambda: pred.predict(uu, ii))
            idle = torch.cuda.current_stream().query()
            (idx, vals), t = host_s(lambda: pred.recommend(users, k=10))
            calls.append(dict(round=rnd, artifact=name, ms=t * 1e3,
                              stream_idle_before=idle))
    for name in order:
        want = preds[name].recommend(users, k=10)
        (idx, vals), parts = recommend_parts(preds[name], users)
        torch.cuda.synchronize()
        check(np.array_equal(idx, want[0]) and np.allclose(vals, want[1]),
              "recommend_parts disagrees with recommend")
        busy, top = device_busy_ms(
            lambda: preds[name].recommend(users, k=10), top=6)
        parts["device_busy_ms"] = busy
        parts["top_device_ops"] = top
        calls.append(dict(artifact=name, parts=parts))
    for c in calls:
        log(f"  {json.dumps(c)} [{card}]")
    log(json.dumps({"query_latency": calls}))


def run_query_latency(arts, save_dir, card):
    """Phase 15 (b): the ``recommend`` latency of the trained and the seed
    artifacts, each first in a fresh process of its own."""
    numbers = {}
    root = os.path.join(save_dir, "query_arts")
    os.makedirs(root, exist_ok=True)
    for name in ("trained", "seed"):
        arts[name].save(os.path.join(root, f"{name}.npz"))
    for order, warm in (("trained,seed", ""), ("seed,trained", "1")):
        numbers[order] = run_fresh(
            "15b", "query_latency", card, env={
                "CHIP_SMOKE_ARTIFACTS": root,
                "CHIP_SMOKE_QUERY_ORDER": order,
                "CHIP_SMOKE_QUERY_WARM": warm})
    for order, calls in numbers.items():
        timed = [c for c in calls if "ms" in c]
        for c in calls:
            if "first_use_ms" in c:
                log(f"  order {order}: first use of each op of a recommend, "
                    f"before any recommend (ms): {c['first_use_ms']} "
                    f"[{card}]")
        log(f"  order {order}: recommend ms in call order "
            + ", ".join(f"{c['artifact']} {c['ms']:.2f}" for c in timed)
            + f"; the stream idle before every window: "
            f"{all(c['stream_idle_before'] for c in timed)} [{card}]")
        for c in calls:
            if "parts" in c:
                p = c["parts"]
                log(f"    {c['artifact']} warm, by part (ms): users copy "
                    f"{p['copy_users_ms']:.3f}, rated lists "
                    f"{p['rated_lists_ms']:.3f} (width {p['rated_width']}), "
                    f"their copies {p['copy_rated_ms']:.3f}, launches "
                    f"{p['launches_ms']:.3f}, .cpu() {p['cpu_reads_ms']:.3f}"
                    f", device {p['device_ms']:.3f}; profiler busy "
                    f"{p['device_busy_ms']}: " + "; ".join(
                        f"{n} {ms:.3f} ms x{k}"
                        for n, ms, k in p["top_device_ops"] or []))
    return numbers


def run_ell_ml10m(bd, ek, trainer, save_dir, card):
    """Phase 15 (c): ``KERNEL.BACKEND: ell`` on phase 4's ML-10M graph and
    the trainer's parameters: the packs, one ``train_iteration`` (no hand
    kernel), the same batch, parameters and dropout state against the
    ``xla`` trainer in ``resolve_edge_chunk``'s chunks (phase 11's float32
    bound), against the ``bitdense`` trainer (phase 12's bound between
    ``bitdense`` and ``dense``) and against an ``ELL_BF16`` twin; step
    time, busy time, top device operations and memory beside the step's
    byte bound; ``fit(10)`` with one validation and a checkpoint; the
    export against the ``bitdense`` export of the same parameters; queries;
    the train CLI with ``--backend ell``."""
    import logging

    import numpy as np
    import torch

    from stargcn_tpu_torch.models import resolve_edge_chunk
    from stargcn_tpu_torch.ops.chunked_ell import pack_bytes
    from stargcn_tpu_torch.serve import ServingState, export_serving
    from stargcn_tpu_torch.train import __main__ as train_cli

    numbers = {}
    it, s = trainer.data_iter, trainer.s
    ell = backend_twin(trainer, backend="ell")
    ell.save_id = 15
    v = ell.variants
    for variant in ("train", "test"):
        pack, t_pack = host_s(lambda: v.ell_pack(variant))
        mb = pack_bytes(pack) / 1e6
        numbers[f"pack_{variant}"] = dict(s=t_pack, mb=mb,
                                          rows=[int(pack[t]["idx"].shape[0])
                                                for t in ("user", "item")])
        log(f"  {variant}-variant chunked-ELL packs (K = "
            f"{ell.model_cfg.ell_k}, both directions, built on the card): "
            f"{t_pack:.3f} s, {mb:.1f} MB, virtual rows "
            f"{numbers[f'pack_{variant}']['rows']} [{card}]")
    check(v.ell_pack("valid") is v.ell_pack("train"),
          "the valid variant should share the train variant's ELL packs")
    rs = it.rating_sampler(batch_size=s.rating_batch_size, segment="train")
    recon = it.recon_nodes_sampler(batch_size=s.recon_batch_size)
    next_batch = lambda: next_batches(trainer, rs, recon)  # noqa: E731
    batch = next_batch()
    params0 = copy.deepcopy(ell.model.state_dict())

    zero_launches(bd, ek)
    trainer.seed_dropout(SEED)
    stats, t_first = host_s(lambda: ell.train_iteration(*batch))
    check(no_kernel_launched(bd, ek), "an ell step launched a hand kernel")
    check(bool(torch.isfinite(stats["loss"])), "non-finite ell loss")
    log(f"  first ell train_iteration: {t_first * 1e3:.1f} ms, loss "
        f"{float(stats['loss']):.4f}, hand-kernel launches "
        f"{ {**bd.LAUNCHES, **ek.LAUNCHES} } [{card}]")
    ell.model.load_state_dict(params0)

    E = it.all_graph["user", "movie"].nnz
    chunk = resolve_edge_chunk("xla", E, trainer.model_cfg.agg_units)
    xla = backend_twin(trainer, backend="xla", edge_chunk=chunk)
    bf16 = backend_twin(trainer, backend="ell", ell_bf16=True)
    runs = {}
    for name, owner in (("ell", ell), ("xla", xla), ("bitdense", trainer),
                        ("ell_bf16", bf16)):
        owner.model.load_state_dict(params0)
        trainer.seed_dropout(SEED)
        runs[name] = owner.loss_and_grads(*batch)
    trainer.seed_dropout(SEED)
    again = ell.loss_and_grads(*batch)
    spread = compare_grads(runs["ell"], again)
    log(f"  the ell step again against itself (index_add_ atomics): all "
        f"gradients together {spread[3]:.3e}, worst single parameter "
        f"{spread[1]:.3e}")
    numbers["repeat_spread"] = dict(all=spread[3], worst=spread[1])
    numbers["vs_xla"] = held_against("ell vs xla (float32)", runs["xla"],
                                     runs["ell"], (1e-3, 1e-3, 5e-2))
    numbers["vs_bitdense"] = held_against(
        "ell vs bitdense (the bit kernels round x and g to bf16)",
        runs["bitdense"], runs["ell"], (1e-2, 1e-1, None))
    numbers["bf16_vs_f32"] = held_against(
        "ell with ELL_BF16 vs ell", runs["ell"], runs["ell_bf16"],
        (1e-2, 1e-1, None))
    del runs, again, xla
    torch.cuda.empty_cache()

    for name, owner in (("ell", ell), ("ell_bf16", bf16), ("ell again", ell)):
        owner.model.load_state_dict(params0)
        numbers[name] = step_numbers(owner, next_batch, card,
                                     f"ML-10M {name}")
    mask = v.edge_mask("train") * v._edges[3]
    f_aug = ell.model_cfg.embed_units + 1
    gb = 8 * float(mask.sum()) * f_aug * 4 / 1e9
    numbers["byte_bound_ms"] = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    log(f"  the step's 4 forward and 4 backward pools gather {gb:.2f} GB "
        f"({int(mask.sum()):,} train edges x {f_aug} float32 columns each): "
        f"{numbers['byte_bound_ms']:.2f} ms at 3.35 TB/s, beside "
        f"{numbers['ell']['step_ms']:.2f} ms measured (printed, not a "
        f"claim) [{card}]")
    del bf16
    for owner in (ell, trainer):
        owner.model.load_state_dict(params0)

    lines = []
    summary, t_fit = host_s(lambda: ell.fit(max_iter=10, log=lines.append))
    log(f"  ell fit(max_iter=10): {t_fit:.2f} s; {summary} [{card}]")
    check(summary["best_iter"] == 10
          and np.isfinite(summary["best_valid_rmse"]), "ell fit summary")
    check(os.path.exists(os.path.join(save_dir, "ckpt_best_15.pt")),
          "ell fit checkpoint")
    numbers["fit_s"] = t_fit
    art, t_export = host_s(lambda: export_serving(ell, segment="test"))
    state = ServingState(trainer.model_cfg, it, device=DEVICE,
                         state_dict=ell.model.state_dict(),
                         variants=trainer.variants)
    ref = export_serving(state, segment="test")
    eu = rel_err(art.user_feats, ref.user_feats)
    ei = rel_err(art.item_feats, ref.item_feats)
    log(f"  ell export {t_export:.3f} s; against the bitdense export of the "
        f"same parameters: U rel err {eu:.3e}, I {ei:.3e} (tol 1e-2: the "
        f"bit kernel rounds its input to bf16) [{card}]")
    check(eu <= 1e-2 and ei <= 1e-2, "ell export disagrees with bitdense")
    check_artifact(art, ML10M)
    check_queries(art, card, "ell-trained parameters")
    numbers["export_s"] = t_export
    del ell, state, art, ref
    torch.cuda.empty_cache()

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    zero_launches(bd, ek)
    try:
        result, t_cli = host_s(lambda: train_cli.main([
            "--cfg", os.path.join(ROOT, "configs", "transductive_ml_1m.yml"),
            "--dataset", "synthetic", "--backend", "ell", "--save_dir",
            os.path.join(save_dir, "cli_ell"), "--max_iter", "10",
            "--silent", "--device", DEVICE]))
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    log(f"  python -m stargcn_tpu_torch.train --cfg "
        f"configs/transductive_ml_1m.yml --dataset synthetic --backend ell "
        f"--max_iter 10: {t_cli:.2f} s, best valid RMSE "
        f"{result['best_valid_rmse']:.4f}, no hand kernel launched: "
        f"{no_kernel_launched(bd, ek)} [{card}]")
    check(result["best_iter"] == 10
          and np.isfinite(result["best_valid_rmse"]), f"ell CLI {result}")
    check(no_kernel_launched(bd, ek), "the ell CLI launched a hand kernel")
    numbers["cli_s"] = t_cli
    return numbers


def run_resilience_on_card(trainer, save_dir, card):
    """Phase 15 (d): ``device_health_check`` on the card; a
    ``Trainer.fit(20)`` whose step 7 raises once, which restores
    ``ckpt_last`` (saved just before) and finishes after one restart; a
    ``HeartbeatMonitor`` with a 2 s timeout around a 5 s host stall; the
    ``net0.txt`` that ``fit`` wrote."""
    import numpy as np

    from stargcn_tpu_torch.train.resilience import (HeartbeatMonitor,
                                                    device_health_check)
    from stargcn_tpu_torch.utils.model_info import total_param_num

    numbers = {}
    healthy, detail = device_health_check(device=DEVICE)
    log(f"  device_health_check(device={DEVICE!r}): {healthy}, {detail} "
        f"[{card}]")
    check(healthy, f"the card failed its health check: {detail}")

    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    trainer.save_checkpoint("last")
    count0 = trainer.opt.count
    real, calls, lines = trainer._step, [0], []

    def flaky(*inputs):
        calls[0] += 1
        if calls[0] == 7:
            raise RuntimeError("injected failure at step 7")
        return real(*inputs)

    trainer._step = flaky
    try:
        summary, t_fit = host_s(lambda: trainer.fit(max_iter=20,
                                                    log=lines.append))
    finally:
        del trainer._step
    restarts = trainer.elastic.restarts
    log(f"  fit(max_iter=20) with step 7 raising once: {t_fit:.2f} s "
        f"(a 5 s backoff included), {restarts} restart, optimizer steps "
        f"{count0} -> {trainer.opt.count}; "
        + " | ".join(x.splitlines()[0] for x in lines if "[elastic]" in x)
        + f" [{card}]")
    check(restarts == 1 and calls[0] == 27
          and trainer.opt.count == count0 + 20,
          "the failed step should be restored from ckpt_last and retried")
    check(np.isfinite(summary["best_valid_rmse"]), "fit after a restart")
    numbers["restart_fit_s"] = t_fit
    text = open(os.path.join(save_dir, "net0.txt")).read()
    check(text.startswith(
        f"embed_item/embedding: shape=({ML10M['num_items']}, 64)")
          and text.endswith(
              f"Total #Params: {total_param_num(params0)}\n"),
          "net0.txt")
    log(f"  net0.txt: {len(text.splitlines())} lines, "
        f"{text.splitlines()[-1]}")
    trainer.model.load_state_dict(params0)
    trainer.opt.load_state_dict(opt0)

    reports, crash = [], os.path.join(save_dir, "crash_stall.log")
    t0 = time.perf_counter()
    with HeartbeatMonitor(2.0, on_hang=reports.append, log=lambda *_: None,
                          poll_s=0.25, crash_file=crash, device=DEVICE):
        time.sleep(5.0)
    stall_s = time.perf_counter() - t0
    text = open(crash).read() if os.path.exists(crash) else ""
    log(f"  HeartbeatMonitor(2 s) around a 5 s host stall: {len(reports)} "
        f"report, crash file {len(text)} bytes; first line: "
        f"{text.splitlines()[0] if text else None} [{card}]")
    check(len(reports) == 1 and "device answers" in text
          and "Thread MainThread" in text
          and "run_resilience_on_card" in text,
          "the heartbeat crash file lacks the main thread's stack")
    numbers["stall_s"] = stall_s
    return numbers


def run_phase15(bd, ek, trainer, save_dir, card):
    """Phase 15: ranking, the ell backend and resilience at ML-10M.
    Returns its numbers."""
    import torch

    t0 = time.perf_counter()
    numbers = {}
    log("  (a) ranking at ML-10M")
    numbers["ranking"], arts = run_ranking_ml10m(trainer, save_dir, card)
    log("  (b) recommend latency, in fresh processes")
    numbers["query_latency"] = run_query_latency(arts, save_dir, card)
    del arts
    log("  (c) KERNEL.BACKEND ell at ML-10M")
    numbers["ell_ml10m"] = run_ell_ml10m(bd, ek, trainer, save_dir, card)
    torch.cuda.empty_cache()
    log("  (d) resilience on the card")
    numbers["resilience"] = run_resilience_on_card(trainer, save_dir, card)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 15 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return numbers


# ----- phase 16: the profiler, the FLOP count, the reference estimate -----


def trace_device_events(logdir):
    """The one Chrome trace under ``logdir``: ``(device, names, bytes)``,
    ``device`` its device events as ``[(name, ms), ...]`` (kernels,
    copies, memsets), ``names`` the names of all its events."""
    import glob

    files = glob.glob(os.path.join(logdir, "*.json"))
    check(len(files) == 1, f"{logdir}: {len(files)} trace files")
    with open(files[0]) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    device = [(e["name"], e.get("dur", 0) / 1e3) for e in events
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")]
    return device, {e.get("name") for e in events}, os.path.getsize(
        files[0])


def bit_walks(device):
    """The walk and table kernel events of each bit op in a trace (their
    namespaces name the op: ``ops/csrc/bit_walk.cuh``)."""
    out = {}
    for op in ("bit_expand", "bit_reduce"):
        for kernel in ("walk_kernel", "table_kernel"):
            out[f"{op} {kernel}"] = sum(
                1 for n, _ in device if f"{op}::" in n and kernel in n)
    return out


def top_by_name(device, top=8):
    totals = {}
    for name, ms in device:
        t, c = totals.get(name, (0.0, 0))
        totals[name] = (t + ms, c + 1)
    return sorted(((n, t, c) for n, (t, c) in totals.items()),
                  key=lambda e: -e[1])[:top]


def check_bit_walks(walks, steps, launches, what):
    """4 + 4 walks a step: every reduce walk is a training step's, the
    expand walks beyond 4 a step are evaluation batches' (4 each); each
    walk has its table kernel and each is one counted launch."""
    exp, red = walks["bit_expand walk_kernel"], walks["bit_reduce walk_kernel"]
    check(red == 4 * steps and exp >= 4 * steps and (exp - 4 * steps) % 4
          == 0, f"{what}: {exp} expand / {red} reduce walks for {steps} "
          f"steps")
    check(walks["bit_expand table_kernel"] == exp
          and walks["bit_reduce table_kernel"] == red,
          f"{what}: table kernels {walks}")
    if launches is not None:
        check(exp == launches["bit_expand_matmul"]
              and red == launches["bit_reduce_matmul"],
              f"{what}: trace {walks} against launches {launches}")


def profiled_fit(bd, trainer, cfg, save_dir, card):
    """Phase 16 (a): ``fit(max_iter=VALID_INTERVAL)`` under
    ``utils.profiling.trace`` with one ``annotate`` span, between two of
    the same ``fit`` without the profiler (the first also builds what the
    trainer has not built yet); the trace's device events by name; then 5
    steps under the profiler and 5 without, host clock ending in a
    synchronise."""
    import torch

    from stargcn_tpu_torch.utils.profiling import annotate, trace

    steps = int(cfg.TRAIN.VALID_INTERVAL)
    logdir = os.path.join(save_dir, "profile16")

    def fit():
        return host_s(lambda: trainer.fit(max_iter=steps,
                                          log=lambda *_: None))[1]

    t_first = fit()
    zero_launches(bd)
    t0 = time.perf_counter()
    with trace(logdir):
        with annotate("chip_smoke.profiled_fit"):
            t_fit_prof = fit()
    t_trace = time.perf_counter() - t0 - t_fit_prof
    launches = dict(bd.LAUNCHES)
    t_fit = fit()
    device, names, nbytes = trace_device_events(logdir)
    check("chip_smoke.profiled_fit" in names,
          "the annotate span is not in the trace")
    walks = bit_walks(device)
    check_bit_walks(walks, steps, launches, "profiled fit")
    busy = sum(ms for _, ms in device)
    top = top_by_name(device)
    log(f"  fit(max_iter={steps}) under trace(): {t_fit_prof:.2f} s "
        f"(+{t_trace:.2f} s to stop and write the trace, {nbytes / 1e6:.1f} "
        f"MB), without the profiler {t_first:.2f} s before, {t_fit:.2f} s "
        f"after; launches "
        f"{launches['bit_expand_matmul']} + {launches['bit_reduce_matmul']}, "
        f"trace: {walks}; device time in the trace {busy:.1f} ms; top device "
        "operations: " + "; ".join(f"{n[:90]} {ms:.2f} ms x{c}"
                                   for n, ms, c in top) + f" [{card}]")
    rs = trainer.data_iter.rating_sampler(
        batch_size=trainer.s.rating_batch_size, segment="train")
    recon = trainer.data_iter.recon_nodes_sampler(
        batch_size=trainer.s.recon_batch_size)
    batches = [next_batches(trainer, rs, recon) for _ in range(11)]
    trainer.train_iteration(*batches[0])

    def five(bs):
        times = []
        for b in bs:
            times.append(host_s(lambda: trainer.train_iteration(*b))[1]
                         * 1e3)
        return times

    with trace(os.path.join(save_dir, "profile16_steps")):
        prof_ms = five(batches[1:6])
    plain_ms = five(batches[6:11])
    log(f"  train_iteration, 5 steps under the profiler: "
        f"{', '.join(f'{x:.2f}' for x in prof_ms)} ms (median "
        f"{median(prof_ms):.2f}); 5 without: "
        f"{', '.join(f'{x:.2f}' for x in plain_ms)} ms (median "
        f"{median(plain_ms):.2f}) [{card}]")
    torch.cuda.synchronize()
    return launches, dict(
        fit_s_profiled=t_fit_prof, fit_s_before=t_first, fit_s=t_fit,
        trace_write_s=t_trace,
        trace_mb=nbytes / 1e6, walks=walks, trace_device_ms=busy,
        top_device_ops=[[n, ms, c] for n, ms, c in top],
        step_ms_profiled=median(prof_ms), step_ms=median(plain_ms),
        step_times_profiled_ms=prof_ms, step_times_ms=plain_ms)


def flop_rate(bd, trainer, card):
    """Phase 16 (b): 10 steps timed by ``StepTimer`` (each ending in a
    synchronise), ``stargcn_step_flops`` at each step's active edges (the
    train graph less the batch's removed edges) and batch, the useful
    TFLOP/s and ``mfu`` against the H100 peak."""
    import torch

    from stargcn_tpu_torch.utils.flops import (H100_SXM_BF16_PEAK_FLOPS,
                                               mfu, stargcn_step_flops)
    from stargcn_tpu_torch.utils.profiling import StepTimer

    it = trainer.data_iter
    n_train = it.train_graph[it.name_user, it.name_item].nnz
    rs = it.rating_sampler(batch_size=trainer.s.rating_batch_size,
                           segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    batches = [next_batches(trainer, rs, recon) for _ in range(11)]
    trainer.train_iteration(*batches[0])
    torch.cuda.synchronize()
    timer = StepTimer(window=10)
    flops, active = [], []
    zero_launches(bd)
    timer.start()
    for rb, cb in batches[1:]:
        prepped = trainer._prep_host_arrays(rb, cb)
        trainer._step(*trainer._to_device(prepped))
        torch.cuda.synchronize()
        timer.tick()
        e_active = n_train - int(prepped[1][2].sum())
        active.append(e_active)
        flops.append(stargcn_step_flops(trainer.model_cfg, e_active,
                                        rb[1].size))
    launches = dict(bd.LAUNCHES)
    step_s = timer.mean_step_s
    step_flops = sum(f["step"] for f in flops) / len(flops)
    rate = step_flops / step_s
    util = mfu(step_flops, step_s)
    log(f"  10 steps by StepTimer: {step_s * 1e3:.2f} ms a step; "
        f"e_active {min(active):,}-{max(active):,} of {n_train:,} train "
        f"edges, batch {batches[1][0][1].size:,}; useful work "
        f"{step_flops / 1e9:.2f} GFLOP a step (forward "
        f"{flops[-1]['fwd'] / 1e9:.2f}, {flops[-1]['edge_msgs']:,} edge "
        f"messages): {rate / 1e12:.3f} TFLOP/s, mfu {util:.5f} of the "
        f"{H100_SXM_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak; "
        f"launches {launches['bit_expand_matmul']} + "
        f"{launches['bit_reduce_matmul']} [{card}]")
    check(0 < util < 1, f"mfu {util} outside (0, 1)")
    check(launches["bit_expand_matmul"] == launches["bit_reduce_matmul"]
          == 40, f"StepTimer steps launched {launches}")
    return launches, dict(step_ms=step_s * 1e3, gflop_per_step=step_flops
                          / 1e9, tflops=rate / 1e12, mfu=util,
                          e_active=active, edge_msgs=flops[-1]["edge_msgs"])


def cpu_model():
    """The host CPU's name: ``model name`` of ``/proc/cpuinfo``, else
    ``lscpu``'s, else (a virtual machine may read "unknown" there) its
    vendor, family and model fields."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    if fields.get("model name", "unknown") != "unknown":
        return fields["model name"]
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        for line in out.splitlines():
            name = line.split(":", 1)[1].strip() if ":" in line else ""
            if line.lower().startswith("model name") and name not in (
                    "", "unknown"):
                return name
    except (OSError, subprocess.SubprocessError):
        pass
    return ", ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "cpu implementer", "cpu part")
        if k in fields) or "not readable"


def reference_estimate(card):
    """Phase 16 (c): ``measure_host_ms`` at the ``ml-100k`` and ``ml-1m``
    shapes (3 iterations) and at ``ml-10m`` (1), then ``estimate`` on
    these medians and ``estimate_all`` on the recorded ones; every
    ``rate_bound`` inside (1e5, 7.2e8)."""
    from stargcn_tpu_torch.utils import refestimate as ref

    cpu = cpu_model()
    measured, seconds = {}, {}
    for name, iters in (("ml-100k", 3), ("ml-1m", 3), ("ml-10m", 1)):
        got, seconds[name] = host_s(
            lambda: ref.measure_host_ms(ref.DATASETS[name], iters=iters))
        measured[name] = got["host_ms_measured"]
    est = {name: ref.estimate(ref.DATASETS[name], ms)
           for name, ms in measured.items()}
    log(f"  measure_host_ms on {cpu} ({os.cpu_count()} logical CPUs): "
        + "; ".join(f"{n} {ms} ms (the call {seconds[n]:.1f} s)"
                    for n, ms in measured.items()) + f" [{card}]")
    for name, e in est.items():
        log(f"  estimate {name}: step {e['step_ms_bound']} ms bound / "
            f"{e['step_ms_realistic']} ms realistic, rate "
            f"{e['rate_bound']:.4g} / {e['rate_realistic']:.4g} edge-msgs/s "
            f"(host {e['host_ms_credited']} ms credited, pcie "
            f"{e['pcie_ms']}, device {e['device_ms_bound']}, launch "
            f"{e['launch_ms_bound']} ms)")
        check(1e5 < e["rate_bound"] < 7.2e8,
              f"{name} rate_bound {e['rate_bound']} outside (1e5, 7.2e8)")
    for name, e in ref.estimate_all(measure=False).items():
        check(1e5 < e["rate_bound"] < 7.2e8,
              f"recorded {name} rate_bound {e['rate_bound']}")
    return dict(cpu=cpu, cpus=os.cpu_count(), host_ms=measured,
                call_s=seconds, estimate=est)


def run_profile_cli(save_dir, card):
    """Phase 16 (d): ``python -m stargcn_tpu_torch.train`` in a process of
    its own on ``transductive_ml_10m.yml`` with ``--dataset synthetic
    --backend bitdense --max_iter 20 --profile DIR``: rc 0, a trace under
    DIR whose bit kernels are 4 + 4 a step of the profiled ``fit``."""
    from stargcn_tpu_torch.utils import cfg_from_file

    cfg_path = os.path.join(ROOT, "configs", "transductive_ml_10m.yml")
    steps = int(cfg_from_file(cfg_path).TRAIN.VALID_INTERVAL)
    prof = os.path.join(save_dir, "cli16_profile")
    out, t_cli = host_s(lambda: subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.train", "--cfg", cfg_path,
         "--dataset", "synthetic", "--backend", "bitdense", "--max_iter",
         "20", "--profile", prof, "--save_dir",
         os.path.join(save_dir, "cli16"), "--device", DEVICE, "--silent"],
        capture_output=True, text=True, timeout=600, cwd=ROOT))
    check(out.returncode == 0, f"the train CLI with --profile failed: "
          f"{out.stderr[-2000:]}")
    device, _, nbytes = trace_device_events(prof)
    walks = bit_walks(device)
    check_bit_walks(walks, steps, None, "train CLI --profile")
    log(f"  python -m stargcn_tpu_torch.train --cfg "
        f"configs/transductive_ml_10m.yml --dataset synthetic --backend "
        f"bitdense --max_iter 20 --profile DIR: rc 0 in {t_cli:.2f} s, trace "
        f"{nbytes / 1e6:.1f} MB: {walks} [{card}]")
    return dict(cli_s=t_cli, walks=walks)


def host_library_ml10m(trainer, card):
    """Phase 16 (e): ``CSRMat.sample_neighbors(symm=True,
    use_multi_link=True)`` on the ML-10M train CSR in both directions; the
    per-level counts of ``multi_link_split`` add up to the nnz."""
    it = trainer.data_iter
    csr = it.train_graph[it.name_user, it.name_item]
    numbers = {}
    csr_t, t_t = host_s(lambda: csr.T)
    for what, mat in (("user -> item", csr), ("item -> user", csr_t)):
        (ep, vals, ptr, sup), t = host_s(
            lambda: mat.sample_neighbors(symm=True, use_multi_link=True))
        counts = [int(p[-1]) for p in ptr]
        check(len(ptr) == len(mat.multi_link) and sum(counts) == mat.nnz
              and [len(e) for e in ep] == counts
              and [len(s) for s in sup] == counts,
              f"{what}: per-level counts {counts} against nnz {mat.nnz}")
        check(all((v == r).all() for v, r in zip(vals, mat.multi_link)),
              f"{what}: a level holds another rating")
        log(f"  sample_neighbors({what}, {mat.nnz:,} edges, "
            f"{mat.shape[0]:,} rows): {t:.2f} s, per level "
            f"{counts} [{card}]")
        numbers[what] = dict(s=t, per_level=counts)
    log(f"  the transpose for the item side: {t_t:.2f} s [{card}]")
    numbers["transpose_s"] = t_t
    return numbers


def run_phase16(bd, trainer, cfg, save_dir, card):
    """Phase 16: the profiler, the FLOP count, the reference estimate, the
    train CLI's ``--profile`` and the host graph library at ML-10M, on
    phase 4's trainer (its parameters and optimizer state restored after,
    its fits' files in a directory of their own).  Returns the launch
    counts of its paths and its numbers."""
    import torch

    t0 = time.perf_counter()
    numbers, launches = {}, {}
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    own_dir = trainer.save_dir
    trainer.save_dir = os.path.join(save_dir, "phase16")
    os.makedirs(trainer.save_dir, exist_ok=True)
    try:
        log("  (a) a profiled fit")
        launches["profiled fit(10)"], numbers["profiled_fit"] = \
            profiled_fit(bd, trainer, cfg, save_dir, card)
        log("  (b) the FLOP count")
        launches["StepTimer steps(10)"], numbers["flops"] = flop_rate(
            bd, trainer, card)
    finally:
        trainer.save_dir = own_dir
        trainer.model.load_state_dict(params0)
        trainer.opt.load_state_dict(opt0)
    torch.cuda.empty_cache()
    log("  (c) the reference step estimate")
    numbers["refestimate"] = reference_estimate(card)
    log("  (d) the train CLI with --profile")
    numbers["cli"] = run_profile_cli(save_dir, card)
    log("  (e) the host graph library at ML-10M")
    numbers["host_library"] = host_library_ml10m(trainer, card)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 16 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return launches, numbers


# ------------------------------- phase 17 -------------------------------

# Phase 11's float32 tolerances: loss, all gradients together, the
# worst single parameter, each relative.
MESH_TOL = (1e-4, 1e-4, 1e-4)
MESH_SHAPES_B = ((1, 2), (2, 1))


def collectives_numbers(counts, modeled, what, card):
    """The counted collectives of one step (``collectives.counted()``)
    beside ``perfmodel.modeled_collectives``: logged, checked equal call
    for call and byte for byte, and returned."""
    from stargcn_tpu_torch.parallel.perfmodel import total

    by_kind = counts.by_kind()
    calls, nbytes = total(by_kind)
    m_calls, m_bytes = total(modeled)
    log(f"  {what}: {calls} collectives, {nbytes / 1e6:.3f} MB (kind: "
        f"axis: [count, bytes] {by_kind}); modeled {m_calls}, "
        f"{m_bytes / 1e6:.3f} MB [{card}]")
    check(by_kind == modeled, f"{what}: the counted collectives are not "
          f"the modeled ones ({modeled})")
    return {"count": calls, "mb": nbytes / 1e6, "by_kind": by_kind,
            "equal_to_model": True}


def collectives_alone_ms(counts, mesh):
    """One collective of each kind, axis and size the step issued, timed
    back to back by CUDA events (float32 buffers of the same bytes), times
    how often the step issued it."""
    import torch

    ms = 0.0
    for kind, axis, nbytes in sorted(set(counts.calls)):
        ms += cuda_ms(replay_collective(kind, max(nbytes // 4, 1),
                                        mesh.group(axis), DEVICE), 5) \
            * counts.calls.count((kind, axis, nbytes))
    torch.cuda.empty_cache()
    return ms


def replay_collective(kind, n, group, device):
    """A function that issues one collective of ``kind`` giving ``n``
    float32 elements on ``group`` (for timing)."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size(group)
    buf = torch.zeros(n // world if kind == "all_gather" else n,
                      device=device)
    if kind == "all_gather":
        outs = [torch.empty_like(buf) for _ in range(world)]
        return lambda: dist.all_gather(outs, buf, group=group)
    if kind == "broadcast":
        src = dist.get_global_rank(group, 0)
        return lambda: dist.broadcast(buf, src, group=group)
    return lambda: dist.all_reduce(buf, group=group)


def params_diff(ref, got):
    """Parameters after a step against a reference's: per parameter the
    largest difference over its largest entry; returns ``(all parameters
    together, the worst of those, its parameter)``, relative."""
    worst, worst_name, diff2, norm2 = 0.0, "", 0.0, 0.0
    for k, r in ref.items():
        r = r.detach().double().cpu()
        d = got[k].detach().double().cpu() - r
        rel = float(d.abs().max()) / max(float(r.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
        diff2 += float(d.pow(2).sum())
        norm2 += float(r.pow(2).sum())
    return (diff2 / norm2) ** 0.5, worst, worst_name


def params_held(name, ref, got):
    """The parameters after a mesh step against those after the nearest of
    the step without a mesh's outcomes (``mesh_reference``), within
    ``PARAM_TOL``."""
    diffs = [params_diff(o["after"], got) for o in ref["outcomes"]]
    i = min(range(len(diffs)), key=lambda j: diffs[j][1])
    glob, worst, worst_name = diffs[i]
    log(f"  {name}: parameters after the step against outcome {i} of the "
        f"step without a mesh: {glob:.3e} relative all together (tol "
        f"{PARAM_TOL[0]:g}), worst {worst:.3e} ({worst_name}; tol "
        f"{PARAM_TOL[1]:g}); against the others "
        + (", ".join(f"{d[1]:.3e}" for j, d in enumerate(diffs) if j != i)
           or "none"))
    check(glob <= PARAM_TOL[0] and worst <= PARAM_TOL[1],
          f"{name}: the parameters after the step disagree")
    return dict(all=glob, worst=worst, worst_name=worst_name, outcome=i)


def stats_held(name, ref, got, tol):
    """Loss and ``sq_err`` of one step against the step without a mesh."""
    rel = {k: float((got[k].double().cpu() - ref[k].double().cpu()).abs()
                    .max() / ref[k].double().abs().max().cpu())
           for k in ("loss", "sq_err")}
    log(f"  {name}: loss rel diff {rel['loss']:.3e}, sq_err rel diff "
        f"{rel['sq_err']:.3e} (tol {tol:g})")
    check(max(rel.values()) <= tol, f"{name}: the step's loss or sq_err "
          "disagree")
    return rel


def plain_mesh_twin(mt):
    """The mesh trainer ``mt`` (a shallow copy: the same operands, mesh and
    dropout stream) with its model on the plain float32 bit pools, its
    embedding rows split as ``mt``'s."""
    from stargcn_tpu_torch.models import STARGCN
    from stargcn_tpu_torch.models.stargcn import feature_dims

    twin = copy.copy(mt)
    twin.model = STARGCN(dataclasses.replace(mt.model_cfg, bit_impl="xla"),
                         feature_dims=feature_dims(mt.data_iter))
    twin.model.to(mt.device)
    mt.shardings.place_params(twin.model)
    twin.model.load_state_dict(mt.model.state_dict())
    return twin


def whole_grads(owner, batch):
    """``loss_and_grads`` of ``owner`` (dropout from seed 123), gradients
    whole (gathered over 'model' on a mesh)."""
    owner.seed_dropout(SEED)
    stats, grads = owner.loss_and_grads(*batch)
    if getattr(owner, "mesh", None) is not None:
        grads = {k: owner._whole(k, g) for k, g in grads.items()}
    return stats, grads


# The step without a mesh, repeated from one checkpoint on one batch: its
# kernels' step has many outcomes (``index_add_`` adds with atomics, and a
# last-bit change upstream can flip a bf16 table entry of the bit kernels;
# PR 2's repeat spread; 8 repeats gave 8 outcomes, PERF.md PR 17), so a
# mesh step's gradients are held against the nearest of the outcomes these
# repeats find, within twice the largest difference between two of them
# (``MESH_TOL`` where that is wider), as phase 14 holds its bf16 step.
REF_REPEATS = 12
# The parameters after the step, against the nearest outcome's: all
# together, and the worst parameter's largest difference over its largest
# entry.  Adam moves an entry whose gradient nearly cancels by up to
# ``lr`` on a last-bit change of that gradient, which splits the outcomes
# in two clusters 1.4e-1 apart in one bias; within a cluster the worst
# readings were 3.7e-5 to 9.5e-4 (PERF.md, PR 17).
PARAM_TOL = (MESH_TOL[1], 5e-3)


def mesh_reference(trainer, batch, ckpt, grads_of=None, plain=None,
                   repeats=REF_REPEATS):
    """The step without a mesh from the checkpoint ``ckpt``: ``repeats``
    times ``loss_and_grads`` through the kernels (``grads_of(trainer,
    batch)``, default ``whole_grads``: dropout from seed 123) and the
    optimiser's step on those gradients, as ``train_iteration`` takes it;
    its distinct outcomes (stats, gradients, parameters after), and the
    largest difference between two of them; once through the plain
    float32 pools (``plain(trainer, batch)``, default the plain bit
    twin's; ``False``: no plain route).  The trainer's own state comes
    back."""
    import torch

    grads_of = grads_of or whole_grads
    if plain is None:
        def plain(owner, b):
            return whole_grads(plain_twin(owner), b)
    params0 = copy.deepcopy(trainer.model.state_dict())
    opt0 = copy.deepcopy(trainer.opt.state_dict())
    lr0 = trainer.lr
    outcomes = []
    try:
        for _ in range(repeats):
            trainer.restore_checkpoint(ckpt)
            stats, grads = grads_of(trainer, batch)
            trainer.opt.step(grads)
            after = {k: v.detach().clone()
                     for k, v in trainer.model.state_dict().items()}
            same = [o for o in outcomes
                    if all(torch.equal(o["grads"][k], g)
                           for k, g in grads.items())
                    and all(torch.equal(o["after"][k], v)
                            for k, v in after.items())]
            if same:
                same[0]["repeats"] += 1
                continue
            outcomes.append(dict(stats=stats, grads=grads, after=after,
                                 repeats=1))
        trainer.restore_checkpoint(ckpt)
        plain = plain(trainer, batch) if plain else None
    finally:
        trainer.model.load_state_dict(params0)
        trainer.opt.load_state_dict(opt0)
        trainer.set_lr(lr0)
    spread = [(compare_grads((a["stats"], a["grads"]),
                             (b["stats"], b["grads"])),
               params_diff(a["after"], b["after"]))
              for i, a in enumerate(outcomes) for b in outcomes[i + 1:]]
    log(f"  the step without a mesh {repeats} times: "
        f"{len(outcomes)} outcomes ({[o['repeats'] for o in outcomes]} "
        f"repeats); between two of them the gradients differ by up to "
        f"{max([x[0][3] for x in spread], default=0.0):.3e} all together, "
        f"{max([x[0][1] for x in spread], default=0.0):.3e} worst, the "
        f"parameters after by up to "
        f"{max([x[1][1] for x in spread], default=0.0):.3e} worst")
    return dict(outcomes=outcomes, plain=plain, spread=dict(
        grads_all=max([x[0][3] for x in spread], default=0.0),
        grads_worst=max([x[0][1] for x in spread], default=0.0),
        params_worst=max([x[1][1] for x in spread], default=0.0),
        repeats=[o["repeats"] for o in outcomes]))


def mesh_grads_held(what, ref, got, numbers):
    """The mesh step's gradients against the step without a mesh: through
    the kernels against the nearest of its outcomes, within twice their
    spread (``MESH_TOL`` where that is wider); through the plain float32
    pools against its one plain step, within ``MESH_TOL``."""
    got_kernel, got_plain = got
    spread = ref["spread"]
    tol = (MESH_TOL[0], max(MESH_TOL[1], 2 * spread["grads_all"]),
           max(MESH_TOL[2], 2 * spread["grads_worst"]))
    fits = [compare_grads((o["stats"], o["grads"]), got_kernel)
            for o in ref["outcomes"]]
    i = min(range(len(fits)), key=lambda j: max(
        fits[j][0] / tol[0], fits[j][3] / tol[1], fits[j][1] / tol[2]))
    o = ref["outcomes"][i]
    numbers["grads"] = held_against(
        f"{what} vs no mesh (loss_and_grads, kernels; outcome {i} of "
        f"{len(fits)})", (o["stats"], o["grads"]), got_kernel, tol)
    numbers["grads"]["outcome"] = i
    if ref["plain"] is not None:
        numbers["grads_plain"] = held_against(
            f"{what} vs no mesh (loss_and_grads, plain float32 pools)",
            ref["plain"], got_plain, MESH_TOL)


def mesh_step(bd, mt, batch):
    """``loss_and_grads`` of the mesh trainer ``mt`` through the kernels
    and through the plain float32 pools, and one ``train_iteration``
    (dropout from seed 123): the kernel routes' bit launches counted from
    0, the step's collectives (``collectives.counted()``); the gradients
    and the parameters after the step whole."""
    from stargcn_tpu_torch.parallel import collectives as C

    zero_launches(bd)
    grads = whole_grads(mt, batch)
    grad_launches = dict(bd.LAUNCHES)
    plain = whole_grads(plain_mesh_twin(mt), batch)
    mt.seed_dropout(SEED)
    zero_launches(bd)
    with C.counted() as counts:
        stats, t_step = host_s(lambda: mt.train_iteration(*batch))
    return (grads, plain), stats, mt.whole_params(), grad_launches, dict(
        bd.LAUNCHES), t_step, counts


def run_mesh_1x1(bd, trainer, cfg, it, model_cfg, ckpt, batch, ref,
                 save_dir, card):
    """Phase 17 (a): the ML-10M bitdense trainer on a 1 x 1 mesh over NCCL
    (a world of one): one step against the step without a mesh, the launch
    counts, the evaluation and the export against one process's, step
    times and what the collectives cost."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.parallel import make_mesh
    from stargcn_tpu_torch.serve import export_serving
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    numbers, launches = {}, {}
    mesh = make_mesh(1, 1, device=DEVICE)
    check(mesh.backend == ("nccl" if DEVICE == "cuda" else "gloo"),
          f"the 1x1 mesh runs on {mesh.backend}")
    mt, t_build = host_s(lambda: Trainer(
        model_cfg, it, TrainSettings.from_cfg(cfg),
        save_dir=os.path.join(save_dir, "phase17"), device=DEVICE,
        mesh=mesh))
    mt.restore_checkpoint(ckpt)
    log(f"  1x1 mesh trainer (NCCL): {t_build:.2f} s [{card}]")
    got_grads, stats, after, grad_l, step_l, _, coll = mesh_step(
        bd, mt, batch)
    for path, counts in (("mesh 1x1 loss_and_grads", grad_l),
                         ("mesh 1x1 train_iteration", step_l)):
        launches[path] = counts
        check(counts["bit_expand_matmul"] == 4
              and counts["bit_reduce_matmul"] == 4,
              f"{path}: {counts} bit launches, not the 4 + 4 of the step "
              "without a mesh")
    numbers["held"] = {
        "stats": stats_held("mesh 1x1 vs no mesh (train_iteration)",
                            ref["outcomes"][0]["stats"], stats, MESH_TOL[0]),
        "params": params_held("mesh 1x1 vs no mesh", ref, after)}
    mesh_grads_held("mesh 1x1", ref, got_grads, numbers["held"])
    from stargcn_tpu_torch.parallel.perfmodel import modeled_collectives

    numbers["collectives"] = collectives_numbers(
        coll, modeled_collectives(model_cfg, 1, 1, model_cfg.backend),
        "one 1x1 mesh step (NCCL)", card)

    # Step times in turns, the parameters moving on in both (phase 17
    # restores phase 4's trainer after).
    times = {"mesh": [], "no_mesh": []}
    mt.restore_checkpoint(ckpt)
    trainer.restore_checkpoint(ckpt)
    for _ in range(3):
        for name, owner in (("no_mesh", trainer), ("mesh", mt)):
            times[name].append(host_s(
                lambda: owner.train_iteration(*batch))[1] * 1e3)
    numbers["step_ms"] = {k: median(v) for k, v in times.items()}
    # The collectives of one step alone: one of each kind and size the
    # step issued, back to back by CUDA events.
    coll_ms = collectives_alone_ms(coll, mesh)
    numbers["collectives_ms"] = coll_ms
    log(f"  step on the 1x1 mesh {numbers['step_ms']['mesh']:.1f} ms, "
        f"without a mesh {numbers['step_ms']['no_mesh']:.1f} ms (host "
        f"clock, median of 3 in turns); the step's collectives alone "
        f"{coll_ms:.2f} ms on the card [{card}]")

    # Evaluation and export of the same parameters, against one process's.
    mt.restore_checkpoint(ckpt)
    trainer.restore_checkpoint(ckpt)
    zero_launches(bd)
    rmse_mesh, t_eval = host_s(lambda: mt.evaluate("valid"))
    launches["mesh 1x1 evaluate"] = dict(bd.LAUNCHES)
    rmse_one = trainer.evaluate("valid")
    err = float(np.abs(rmse_mesh - rmse_one).max())
    log(f"  evaluate('valid') on the mesh {rmse_mesh.tolist()} vs one "
        f"process {rmse_one.tolist()}: diff {err:.2e} (tol 1e-5), "
        f"{t_eval:.2f} s [{card}]")
    check(err <= 1e-5, "the mesh's evaluation disagrees")
    zero_launches(bd)
    art = export_serving(mt)
    launches["mesh 1x1 export"] = dict(bd.LAUNCHES)
    one = export_serving(trainer)
    exp_err = max(rel_err(art.user_feats, one.user_feats),
                  rel_err(art.item_feats, one.item_feats))
    log(f"  export_serving on the mesh vs one process: {exp_err:.2e} "
        f"relative (tol 1e-5)")
    check(exp_err <= 1e-5, "the mesh's export disagrees")
    numbers.update(valid_rmse=rmse_mesh.tolist(), eval_s=t_eval,
                   eval_diff=err, export_rel=exp_err)
    del mt
    import torch.distributed as dist

    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, numbers


def run_mesh_ranks_on_one_card(bd, trainer, cfg, it, model_cfg, ckpt, batch,
                               ref, save_dir, card):
    """Phase 17 (b): two processes on the one card over gloo (NCCL refuses
    two ranks on one device), on a 1 x 2 and then a 2 x 1 mesh of the
    ML-10M ``bitdense`` trainer (``--phases 17b``, the data iterator
    passed pickled): each rank's step against the step without a mesh,
    its launches and its rows of the packs, each process's peak memory."""
    import pickle

    import torch

    work = os.path.join(save_dir, "phase17b")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "iterator.pkl"), "wb") as f:
        pickle.dump((cfg, it, model_cfg), f, protocol=5)
    torch.save({"ckpt": ckpt, "batch": batch}, os.path.join(work, "in.pt"))
    env = {**os.environ, "CHIP_SMOKE_MESH_DIR": work}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases",
         "17b"], cwd=ROOT, env={**env, "CHIP_SMOKE_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("  "):
                log(f"  [rank {r}] {line.strip()}")
        check(p.returncode == 0, f"--phases 17b rank {r} failed: "
              f"{err[-3000:]}")
    numbers, launches = {}, {}
    for d, m in MESH_SHAPES_B:
        for r in range(2):
            got = torch.load(os.path.join(work, f"{d}x{m}_r{r}.pt"),
                             weights_only=False)
            what = f"mesh {d}x{m} rank {r} (gloo, one card)"
            entry = {
                "stats": stats_held(f"{what} vs no mesh",
                                    ref["outcomes"][0]["stats"],
                                    got["stats"], MESH_TOL[0]),
                "params": params_held(what, ref, got["params"]),
                "pack_rows": got["pack_rows"],
                "peak_gib": got["peak_gib"], "step_ms": got["step_ms"],
                "collectives_per_step": got["collectives_per_step"]}
            mesh_grads_held(what, ref, got["grads"], entry)
            whole = {t: trainer.variants.bit_pack("train")[t]["pf"].shape[0]
                     for t in ("user", "item")}
            for t in ("user", "item"):
                check(got["pack_rows"][t] * m == whole[t],
                      f"{what}: {got['pack_rows'][t]} of {whole[t]} "
                      f"packed rows of the {t} pack, not 1/{m}")
            for path, counts in (("loss_and_grads", got["grad_launches"]),
                                 ("train_iteration", got["step_launches"])):
                check(counts["bit_expand_matmul"] == 4
                      and counts["bit_reduce_matmul"] == 4,
                      f"{what} {path}: {counts}")
                launches[f"mesh {d}x{m} rank {r} {path}"] = counts
            log(f"  {what}: holds {got['pack_rows']} packed rows, peak "
                f"{got['peak_gib']:.2f} GiB, step {got['step_ms']:.1f} ms "
                f"[{card}]")
            numbers[f"{d}x{m}_r{r}"] = entry
    with open(os.path.join(work, "gloo_r0.json")) as f:
        numbers["gloo_cuda_collectives"] = json.load(f)
    log(f"  gloo on CUDA tensors: {numbers['gloo_cuda_collectives']} "
        f"[{card}]")
    return launches, numbers


def mesh_rank_main(bd, card):
    """``--phases 17b``: one rank of phase 17 (b), ``CHIP_SMOKE_RANK`` of
    two on this card, joined over gloo through a file in
    ``CHIP_SMOKE_MESH_DIR``; for each mesh of ``MESH_SHAPES_B`` the step of
    ``mesh_step`` from the parent's checkpoint and batch, written there."""
    import pickle

    import torch
    import torch.distributed as dist

    from stargcn_tpu_torch.parallel import initialize_distributed, make_mesh
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    work = os.environ["CHIP_SMOKE_MESH_DIR"]
    rank = int(os.environ["CHIP_SMOKE_RANK"])
    initialize_distributed("file://" + os.path.join(work, "rendezvous"), 2,
                           rank, device=DEVICE, backend="gloo")
    with open(os.path.join(work, "iterator.pkl"), "rb") as f:
        cfg, it, model_cfg = pickle.load(f)
    inputs = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    for d, m in MESH_SHAPES_B:
        mesh = make_mesh(d, m, device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        mt, t_build = host_s(lambda: Trainer(
            model_cfg, it, TrainSettings.from_cfg(cfg), device=DEVICE,
            mesh=mesh))
        mt.restore_checkpoint(inputs["ckpt"])
        grads, stats, params, grad_l, step_l, t_step, coll = mesh_step(
            bd, mt, inputs["batch"])
        pack = mt.variants.bit_pack("train")
        torch.save({
            "grads": grads, "stats": stats, "params": params,
            "grad_launches": grad_l, "step_launches": step_l,
            "pack_rows": {t: pack[t]["pf"].local.shape[0]
                          for t in ("user", "item")},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_ms": t_step * 1e3,
            "collectives_per_step": coll.count,
        }, os.path.join(work, f"{d}x{m}_r{rank}.pt"))
        log(f"  {d}x{m}: trainer {t_build:.2f} s, train_iteration "
            f"{t_step:.2f} s [{card}]")
        del mt, pack
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"gloo_r{rank}.json"), "w") as f:
        json.dump(gloo_cuda_collectives(), f)
    dist.destroy_process_group()


def gloo_cuda_collectives():
    """Which ``torch.distributed`` collectives gloo runs on CUDA tensors:
    each tried once on a group with a 30 s timeout, ``"ok"`` or the error's
    first line."""
    import datetime

    import torch
    import torch.distributed as dist

    group = dist.new_group(timeout=datetime.timedelta(seconds=30))
    world = dist.get_world_size()
    t = torch.ones(4 * world, device=DEVICE)
    cases = {
        "all_reduce": lambda: dist.all_reduce(t.clone(), group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), 0, group=group),
        "reduce": lambda: dist.reduce(t.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            t.new_empty(world * t.numel()), t, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            t.new_empty(4), t, group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(t), t, group=group),
        "barrier": lambda: dist.barrier(group=group),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the error is the finding
            out[name] = f"{type(e).__name__}: " + (
                str(e).strip().splitlines() or [""])[0][:160]
    return out


def run_mesh_cli(bd, save_dir, card):
    """Phase 17 (c): ``python -m stargcn_tpu_torch.train --mesh 1x1`` on
    ``transductive_ml_10m.yml`` (the CLI's synthetic graph, ``bitdense``, 4
    steps) in a process of its own, its bit launches counted there; then
    the multiprocess twin, whose two ranks share this card over gloo."""
    out_dir = os.path.join(save_dir, "phase17_cli")
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from stargcn_tpu_torch.ops import bitdense as bd\n"
        "from stargcn_tpu_torch.train.__main__ import main\n"
        "r = main(sys.argv[1:])\n"
        "print(json.dumps({'launches': bd.LAUNCHES, 'result': r}))\n"
        % ROOT)
    args = ["--cfg", os.path.join(ROOT, "configs", "transductive_ml_10m.yml"),
            "--dataset", "synthetic", "--backend", "bitdense", "--mesh",
            "1x1", "--max_iter", "4", "--save_dir", out_dir, "--silent",
            "--device", DEVICE]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    check(out.returncode == 0, f"the train CLI with --mesh 1x1 failed: "
          f"{out.stderr[-3000:]}")
    last = json.loads(out.stdout.strip().splitlines()[-1])
    counts = last["launches"]
    # 4 steps of 4 + 4 and the closing test evaluation's expands.
    check(counts["bit_reduce_matmul"] == 16
          and counts["bit_expand_matmul"] >= 16,
          f"the --mesh 1x1 CLI launched {counts}")
    log(f"  train CLI --mesh 1x1: {t_cli:.1f} s in a process of its own, "
        f"{counts['bit_expand_matmul']} + {counts['bit_reduce_matmul']} bit "
        f"launches, result {last['result']} [{card}]")
    t0 = time.perf_counter()
    twin = subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.multiprocess_train",
         "--device", DEVICE],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_twin = time.perf_counter() - t0
    check(twin.returncode == 0 and "MULTIPROCESS RUN PASSED" in twin.stdout,
          f"the multiprocess twin failed: {twin.stdout[-2000:]}"
          f"{twin.stderr[-2000:]}")
    log(f"  {twin.stdout.strip().splitlines()[-1]}: {t_twin:.1f} s [{card}]")
    return {"mesh 1x1 train CLI": counts}, {"cli_s": t_cli,
                                            "twin_s": t_twin}


def shard_kernel_checks(bd, card):
    """The four bit kernels on row shards of a pack (``row0``): shards that
    cross rating levels, shards of whole 128-row blocks of a
    row-interleaved pack, a shard of one level and the whole pack as one
    shard; each against its plain version on the same shard fed the
    bf16-rounded operand, the shards' expands (each its own rows) stacked
    equal bit for bit to the whole pack's expand and their reduces adding
    up to its reduce within 1e-5 of its largest entry.  Returns ``{kernel: worst max abs error}``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    worst = {k: 0.0 for k in bd.LAUNCHES}
    for R, D, S, F, route, cuts in (
            (5, 2000, 1500, 65, "", (0, 640, 1280)),
            (5, 2000, 1500, 65, "", (0, 300, 700, 1280)),
            (10, 300, 70000, 65, "", (0, 1280)),
            (10, 300, 70000, 65, "", (0, 640, 1280)),
            (5, 2000, 1500, 81, "16", (0, 640, 1280)),
            (10, 2000, 1500, 65, "16", (0, 1280, 2560)),
            (3, 2000, 1500, 300, "", (0, 256, 768))):
        e = 40000
        P, d8 = bd.pack_bits(rng.randint(0, D, e), rng.randint(0, S, e),
                             rng.randint(0, R, e), R, D, S,
                             row_interleave=128 if route else 0)
        P = torch.from_numpy(P).to(DEVICE)
        s_pad = P.shape[1]
        check(cuts[-1] == R * d8, f"cuts {cuts} of {R * d8} rows")
        x = torch.from_numpy(rng.randn(s_pad, F).astype(np.float32)).to(
            DEVICE)
        g = torch.from_numpy(rng.randn(R, s_pad, F).astype(np.float32)).to(
            DEVICE)
        expand = getattr(bd, f"bit_expand_matmul{route}")
        reduce = getattr(bd, f"bit_reduce_matmul{route}")
        pe = getattr(bd, f"xla_expand_matmul{route}")
        pr = getattr(bd, f"xla_reduce_matmul{route}")
        xr, gr = x.to(torch.bfloat16).float(), g.to(torch.bfloat16).float()
        whole_e, whole_r = expand(P, x, R, d8), reduce(P, g, R, d8)
        # (R, 8, d8, F) -> packed rows (R * d8, 8, F), a shard's layout.
        whole_e = whole_e.permute(0, 2, 1, 3).reshape(R * d8, 8, F)
        parts_e = []
        sum_r = torch.zeros_like(whole_r)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            shard = P[lo:hi].contiguous()
            got_e = expand(shard, x, R, d8, row0=lo)
            got_r = reduce(shard, g, R, d8, row0=lo)
            again = reduce(shard, g, R, d8, row0=lo)
            check(torch.equal(got_r, again), "a shard's reduce repeated "
                  "gave other bits")
            for name, got, want in (
                    (f"bit_expand_matmul{route}", got_e,
                     pe(shard, xr, R, d8, row0=lo)),
                    (f"bit_reduce_matmul{route}", got_r,
                     pr(shard, gr, R, d8, row0=lo))):
                err, tol, scale = _sub_err(got, want)
                worst[name] = max(worst[name], err)
                check(err <= tol, f"{name} on rows [{lo}, {hi}) of R={R} "
                      f"d8={d8} F={F}: max_abs_err {err:.3e} > {tol:.3e}")
            parts_e.append(got_e)
            sum_r += got_r
        check(torch.equal(torch.cat(parts_e), whole_e), f"R={R} F={F} "
              f"route {route or 'natural'}: the shards' expands stacked are "
              "not the whole pack's")
        err, _, scale = _sub_err(sum_r, whole_r)
        check(err <= 1e-5 * max(scale, 1.0), f"R={R} F={F}: the shards' "
              f"reduces add up to {err:.3e} off the whole pack's")
        log(f"  row shards {list(zip(cuts[:-1], cuts[1:]))} of an R={R} "
            f"d8={d8} S_pad={s_pad} F={F} "
            f"{'row-interleaved ' if route else ''}pack: kernels = plain "
            f"versions, expands stack bit for bit, reduces to {err:.2e} "
            f"[{card}]")
    return worst


def run_phase17(bd, trainer, cfg, it, model_cfg, save_dir, card):
    """Phase 17: full-graph training on a device mesh at ML-10M width on
    phase 4's graph (its trainer's state restored after).  Returns the
    launch counts of its paths and its numbers."""
    import torch

    t0 = time.perf_counter()
    numbers, launches = {}, {}
    log("  the bit kernels on row shards of a pack")
    numbers["shard_worst"] = shard_kernel_checks(bd, card)
    ckpt = trainer.save_checkpoint("phase17")
    rs = it.rating_sampler(batch_size=trainer.s.rating_batch_size,
                           segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    batch = next_batches(trainer, rs, recon)
    ref = mesh_reference(trainer, batch, ckpt)
    numbers["reference_spread"] = ref["spread"]
    log("  (a) a 1x1 mesh over NCCL")
    got, numbers["mesh_1x1"] = run_mesh_1x1(
        bd, trainer, cfg, it, model_cfg, ckpt, batch, ref, save_dir, card)
    launches.update(got)
    log("  (b) two ranks on the one card over gloo: 1x2, then 2x1")
    got, numbers["ranks_on_one_card"] = run_mesh_ranks_on_one_card(
        bd, trainer, cfg, it, model_cfg, ckpt, batch, ref, save_dir, card)
    launches.update(got)
    del ref
    torch.cuda.empty_cache()
    log("  (c) the train CLI with --mesh 1x1, and the multiprocess twin")
    got, numbers["cli"] = run_mesh_cli(bd, save_dir, card)
    launches.update(got)
    trainer.restore_checkpoint(ckpt)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 17 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return launches, numbers


# ------------------------------- phase 18 -------------------------------

# Phase 8's sampled set-up: batch 4096, recon 1024, fanout 8, pallas.
SAMPLED_MESH = dict(batch=4096, recon=1024, fanout=8)
# Phase 18 (a)'s evaluation compares the first 16,384 valid pairs (4
# batches); the whole segment is 244 host-planned batches.
EVAL_PAIRS = 16_384


def sampled_ml10m(cfg, it, model_cfg, save_dir, **kw):
    """Phase 8's ``SampledTrainer`` on phase 4's graph (``--phases 18``
    builds its own)."""
    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.train import SampledTrainer, TrainSettings

    s = TrainSettings.from_cfg(cfg)
    s.rating_batch_size = SAMPLED_MESH["batch"]
    s.recon_batch_size = SAMPLED_MESH["recon"]
    gk.set_seed(SEED)
    return SampledTrainer(model_cfg, it, s,
                          fanout=SAMPLED_MESH["fanout"], device=DEVICE,
                          save_dir=save_dir, save_id=1,
                          **{"backend": "pallas", **kw})


def sampled_grads(owner, batch):
    """``loss_and_grads`` of a ``SampledTrainer`` (or of one rank of a
    mesh) on ``batch`` (a one-tuple), dropout and device plans from seed
    123, gradients whole."""
    if getattr(owner, "plan_device", False):
        owner._plan_gen.manual_seed(SEED)
    return whole_grads(owner, batch)


def sampled_mesh_step(ek, mt, batch):
    """Phase 17's ``mesh_step`` for a sampled mesh trainer: its gradients
    through the ELL kernels and through their plain versions, then one
    ``train_iteration`` with its collectives counted; ELL launches counted
    from 0 for each kernel route."""
    from stargcn_tpu_torch.parallel import collectives as C

    zero_launches(ek)
    grads = sampled_grads(mt, batch)
    grad_l = dict(ek.LAUNCHES)
    plain = None
    if mt.backend == "pallas":
        with plain_ell_versions(ek):
            plain = sampled_grads(mt, batch)
    mt.seed_dropout(SEED)
    if mt.plan_device:
        mt._plan_gen.manual_seed(SEED)
    zero_launches(ek)
    with C.counted() as counts:
        stats, t_step = host_s(lambda: mt.train_iteration(*batch))
    return (grads, plain), stats, mt.whole_params(), grad_l, dict(
        ek.LAUNCHES), t_step, counts


def ell_step_launches(what, counts, ell):
    """``ell`` ELL launches of each of the pair and no ``ell_sddmm``."""
    want = {"ell_spmm_fwd_only": ell, "ell_spmm_transpose": ell,
            "ell_sddmm": 0}
    check(counts == want, f"{what}: {counts}, not {want}")


def sampled_modeled(mt, d, m):
    from stargcn_tpu_torch.parallel.perfmodel import modeled_collectives

    return modeled_collectives(
        mt.model_cfg, d, m, mt.backend, sampled=dict(
            caps=mt.caps, batch=mt.train_batch_pad, recon=mt.recon_cap,
            fanout=mt.fanout, plan_device=mt.plan_device))


def sampled_held(what, ref, stats, after, grads, numbers):
    """A sampled mesh step against the step without a mesh, by phase 17's
    rule (its nearest outcome, within twice the outcomes' spread)."""
    numbers["stats"] = stats_held(f"{what} vs no mesh (train_iteration)",
                                  ref["outcomes"][0]["stats"], stats,
                                  MESH_TOL[0])
    numbers["params"] = params_held(f"{what} vs no mesh", ref, after)
    mesh_grads_held(what, ref, grads, numbers)
    return numbers


def run_sampled_mesh_1x1(ek, strainer, cfg, it, model_cfg, ckpt, batch, ref,
                         save_dir, card):
    """Phase 18 (a): the ML-10M sampled ``pallas`` trainer on a 1 x 1 mesh
    over NCCL: one step against the step without a mesh, its launches,
    its collectives against the model and alone, step times, the
    evaluation against one process's; then a ``plan_device`` (``xla``)
    step likewise."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.parallel import make_mesh

    numbers, launches = {}, {}
    mesh = make_mesh(1, 1, device=DEVICE)
    check(mesh.backend == ("nccl" if DEVICE == "cuda" else "gloo"),
          f"the 1x1 mesh runs on {mesh.backend}")
    mt, t_build = host_s(lambda: sampled_ml10m(
        cfg, it, model_cfg, os.path.join(save_dir, "phase18"),
        frontier_caps=strainer.caps, mesh=mesh))
    mt.restore_checkpoint(ckpt)
    log(f"  1x1 mesh SampledTrainer (NCCL): {t_build:.2f} s [{card}]")
    grads, stats, after, grad_l, step_l, _, coll = sampled_mesh_step(
        ek, mt, batch)
    for path, got in (("mesh 1x1 sampled loss_and_grads", grad_l),
                      ("mesh 1x1 sampled train_iteration", step_l)):
        ell_step_launches(path, got, 4)
        launches[path] = got
    numbers["held"] = sampled_held("sampled mesh 1x1", ref, stats, after,
                                   grads, {})
    numbers["collectives"] = collectives_numbers(
        coll, sampled_modeled(mt, 1, 1), "one 1x1 sampled mesh step "
        "(NCCL)", card)
    numbers["collectives_ms"] = collectives_alone_ms(coll, mesh)

    # Step times in turns, from the checkpoint, the parameters moving on.
    times = {"mesh": [], "no_mesh": []}
    mt.restore_checkpoint(ckpt)
    strainer.restore_checkpoint(ckpt)
    for _ in range(3):
        for name, owner in (("no_mesh", strainer), ("mesh", mt)):
            times[name].append(host_s(
                lambda: owner.train_iteration(*batch))[1] * 1e3)
    numbers["step_ms"] = {k: median(v) for k, v in times.items()}
    log(f"  sampled step on the 1x1 mesh {numbers['step_ms']['mesh']:.1f} "
        f"ms, without a mesh {numbers['step_ms']['no_mesh']:.1f} ms (host "
        f"clock, one batch replayed, median of 3 in turns); its "
        f"collectives alone {numbers['collectives_ms']:.2f} ms on the card "
        f"[{card}]")

    # Evaluation of the same parameters and plans (the first EVAL_PAIRS
    # valid pairs; the planners' stream from one seed each time).
    mt.restore_checkpoint(ckpt)
    strainer.restore_checkpoint(ckpt)
    whole = (it.valid_node_pairs, it.valid_ratings)
    it._valid_node_pairs = whole[0][:, :EVAL_PAIRS]
    it._valid_ratings = whole[1][:EVAL_PAIRS]
    try:
        gk.set_seed(SEED + 18)
        zero_launches(ek)
        rmse_mesh, t_eval = host_s(lambda: mt.evaluate("valid"))
        launches["mesh 1x1 sampled evaluate"] = dict(ek.LAUNCHES)
        gk.set_seed(SEED + 18)
        rmse_one = strainer.evaluate("valid")
    finally:
        it._valid_node_pairs, it._valid_ratings = whole
    err = float(np.abs(rmse_mesh - rmse_one).max())
    log(f"  evaluate('valid') of {EVAL_PAIRS} pairs on the mesh "
        f"{rmse_mesh.tolist()} vs one process {rmse_one.tolist()}: diff "
        f"{err:.2e} (tol 1e-5), {t_eval:.2f} s, "
        f"{launches['mesh 1x1 sampled evaluate']} [{card}]")
    check(err <= 1e-5, "the sampled mesh's evaluation disagrees")
    n_eval = -(-min(EVAL_PAIRS, whole[0].shape[1]) // mt.train_batch_pad)
    check(launches["mesh 1x1 sampled evaluate"] == {
        "ell_spmm_fwd_only": 4 * n_eval, "ell_spmm_transpose": 0,
        "ell_sddmm": 0},
        "the mesh's evaluation should pool 4 blocks a batch forward only")
    numbers.update(valid_rmse=rmse_mesh.tolist(), eval_s=t_eval,
                   eval_diff=err)
    del mt
    torch.cuda.empty_cache()

    # plan_device (xla): planned on the card on every rank.
    one, t_one = host_s(lambda: sampled_ml10m(
        cfg, it, model_cfg, None, backend="xla", plan_device=True))
    md = sampled_ml10m(cfg, it, model_cfg, None, backend="xla",
                       plan_device=True, mesh=mesh)
    rs = it.rating_sampler(batch_size=one.train_batch, segment="train")
    rc = it.recon_nodes_sampler(batch_size=one.s.recon_batch_size)
    pd_batch = (one._make_batch(rs, rc),)
    ref_pd = mesh_reference(one, pd_batch, ckpt, grads_of=sampled_grads,
                            plain=False)
    md.restore_checkpoint(ckpt)
    grads, stats, after, grad_l, step_l, _, coll = sampled_mesh_step(
        ek, md, pd_batch)
    for path, got in (("mesh 1x1 plan_device loss_and_grads", grad_l),
                      ("mesh 1x1 plan_device train_iteration", step_l)):
        ell_step_launches(path, got, 0)
    numbers["plan_device"] = {
        "caps": dict(md.caps), "trainers_s": t_one,
        "reference_spread": ref_pd["spread"],
        "held": sampled_held("plan_device mesh 1x1", ref_pd, stats, after,
                             grads, {}),
        "collectives": collectives_numbers(
            coll, sampled_modeled(md, 1, 1), "one 1x1 plan_device mesh "
            "step (NCCL)", card)}
    del one, md, ref_pd
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, numbers


def run_sampled_mesh_ranks_on_one_card(ek, strainer, cfg, it, model_cfg,
                                       ckpt, batch, ref, save_dir, card):
    """Phase 18 (b): two processes on the one card over gloo (``--phases
    18b``, the data iterator passed pickled), on a 1 x 2 and then a 2 x 1
    mesh of the sampled ``pallas`` trainer: each rank's step against the
    step without a mesh, its ELL launches and the rows they ran on, its
    collectives against the model, its peak memory."""
    import pickle

    import torch

    work = os.path.join(save_dir, "phase18b")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "iterator.pkl"), "wb") as f:
        pickle.dump((cfg, it, model_cfg), f, protocol=5)
    torch.save({"ckpt": ckpt, "batch": batch, "caps": dict(strainer.caps)},
               os.path.join(work, "in.pt"))
    env = {**os.environ, "CHIP_SMOKE_MESH_DIR": work}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases",
         "18b"], cwd=ROOT, env={**env, "CHIP_SMOKE_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("  "):
                log(f"  [rank {r}] {line.strip()}")
        check(p.returncode == 0, f"--phases 18b rank {r} failed: "
              f"{err[-3000:]}")
    numbers, launches = {}, {}
    for d, m in MESH_SHAPES_B:
        for r in range(2):
            got = torch.load(os.path.join(work, f"{d}x{m}_r{r}.pt"),
                             weights_only=False)
            what = f"sampled mesh {d}x{m} rank {r} (gloo, one card)"
            entry = sampled_held(what, ref, got["stats"], got["params"],
                                 got["grads"], {})
            for path in ("loss_and_grads", "train_iteration"):
                counts = got[f"{path}_launches"]
                ell_step_launches(f"{what} {path}", counts, 4)
                launches[f"mesh {d}x{m} rank {r} sampled {path}"] = counts
            check(got["collectives"]["equal_to_model"], what)
            rows = got["ell_rows"]
            check(all(n == rows["want"][t] for t, n in rows["launched"]),
                  f"{what}: ELL launches on {rows['launched']} rows, not "
                  f"the rank's {rows['want']}")
            check(rows["equal_to_whole"],
                  f"{what}: the rows of its ELL launches are not its slice "
                  f"of the whole blocks: {rows['mismatch']}")
            log(f"  {what}: each of its 4 + 4 ELL launches of the step "
                f"ran on rows {rows['launched']} equal, element for "
                f"element, to rows {rows['ranges']} of the whole blocks "
                f"that the 1x2 mesh launched on, "
                f"{got['collectives']['count']} collectives = modeled, "
                f"{got['collectives']['mb']:.1f} MB, peak "
                f"{got['peak_gib']:.2f} GiB, step {got['step_ms']:.1f} ms "
                f"[{card}]")
            numbers[f"{d}x{m}_r{r}"] = {
                **entry, "ell_rows": rows["ranges"],
                "collectives": got["collectives"],
                "peak_gib": got["peak_gib"], "step_ms": got["step_ms"]}
    return launches, numbers


def sampled_mesh_rank_main(ek, card):
    """``--phases 18b``: one rank of phase 18 (b), ``CHIP_SMOKE_RANK`` of
    two on this card, joined over gloo through a file in
    ``CHIP_SMOKE_MESH_DIR``: for each mesh of ``MESH_SHAPES_B`` the step
    of ``sampled_mesh_step`` from the parent's checkpoint and batch, the
    rows of each ELL launch, written there."""
    import pickle

    import torch
    import torch.distributed as dist

    from stargcn_tpu_torch.parallel import initialize_distributed, make_mesh
    from stargcn_tpu_torch.parallel.shardings import padded_split

    work = os.environ["CHIP_SMOKE_MESH_DIR"]
    rank = int(os.environ["CHIP_SMOKE_RANK"])
    initialize_distributed("file://" + os.path.join(work, "rendezvous"), 2,
                           rank, device=DEVICE, backend="gloo")
    with open(os.path.join(work, "iterator.pkl"), "rb") as f:
        cfg, it, model_cfg = pickle.load(f)
    inputs = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    caps = inputs["caps"]
    real = {"fwd": ek.ell_spmm_fwd_only, "t": ek.ell_spmm_transpose}
    whole = None        # the 1 x 2 mesh's launches: every block whole
    check(MESH_SHAPES_B[0][0] == 1, "the first mesh must launch on whole "
          "blocks")
    for d, m in MESH_SHAPES_B:
        mesh = make_mesh(d, m, device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        mt, t_build = host_s(lambda: sampled_ml10m(
            cfg, it, model_cfg, None, frontier_caps=caps, mesh=mesh))
        mt.restore_checkpoint(inputs["ckpt"])
        batch = inputs["batch"] if mt._plans else (None,)
        launched = {"fwd": [], "t": []}

        def fwd(values, idx, weight):
            launched["fwd"].append((idx.cpu(), weight.cpu()))
            return real["fwd"](values, idx, weight)

        def transpose(cot, idx, weight, num_src):
            launched["t"].append((idx.cpu(), weight.cpu()))
            return real["t"](cot, idx, weight, num_src)

        ek.ell_spmm_fwd_only, ek.ell_spmm_transpose = fwd, transpose
        try:
            grads, stats, params, grad_l, step_l, t_step, coll = \
                sampled_mesh_step(ek, mt, batch)
        finally:
            ek.ell_spmm_fwd_only, ek.ell_spmm_transpose = (real["fwd"],
                                                           real["t"])
        k = mesh.index("data")
        split = {t: padded_split(caps[t], d, k) for t in ("user", "item")}
        # The step's launches (the last four of each kernel), each named
        # by its row count: the rank's padded rows of the user or the item
        # block (the caps differ at ML-10M).
        check(caps["user"] != caps["item"], "equal caps: the launches "
              "cannot be told apart by their rows")
        name = {split[t][2]: t for t in split}
        step = {kind: [(name.get(int(idx.shape[0])), (idx, w))
                       for idx, w in launched[kind][-4:]]
                for kind in launched}
        if whole is None:
            whole = step
        # Each launch's rows against the rank's rows of the whole block
        # (the n-th launch of a kind on a type against the n-th of the
        # whole blocks'), element for element; the padded rows empty.
        mismatch = [f"{kind} launch on {idx.shape[0]} rows"
                    for kind in step for t, (idx, _) in step[kind]
                    if t is None]
        for kind in step:
            for t in split:
                lo, hi, _ = split[t]
                mine = [a for tt, a in step[kind] if tt == t]
                theirs = [a for tt, a in whole[kind] if tt == t]
                if len(mine) != len(theirs):
                    mismatch.append(f"{kind} {t}: {len(mine)} launches "
                                    f"against {len(theirs)}")
                for j, ((idx, w), (widx, ww)) in enumerate(zip(mine,
                                                               theirs)):
                    if not (torch.equal(idx[:hi - lo], widx[lo:hi])
                            and torch.equal(w[:hi - lo], ww[lo:hi])
                            and not w[hi - lo:].any()):
                        mismatch.append(f"{kind} {t} launch {j}")
        torch.save({
            "grads": grads, "stats": stats, "params": params,
            "loss_and_grads_launches": grad_l,
            "train_iteration_launches": step_l,
            "ell_rows": {
                "launched": [(t, int(idx.shape[0]))
                             for kind in ("fwd", "t")
                             for t, (idx, _) in step[kind]],
                "equal_to_whole": not mismatch, "mismatch": mismatch,
                "want": {t: split[t][2] for t in split},
                "ranges": {t: f"[{split[t][0]}, {split[t][1]}) of "
                              f"{caps[t]} (padded to {split[t][2]})"
                           for t in split}},
            "collectives": collectives_numbers(
                coll, sampled_modeled(mt, d, m), f"{d}x{m} rank {rank} "
                "step (gloo)", card),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_ms": t_step * 1e3,
        }, os.path.join(work, f"{d}x{m}_r{rank}.pt"))
        log(f"  {d}x{m}: trainer {t_build:.2f} s, train_iteration "
            f"{t_step:.2f} s [{card}]")
        del mt
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def run_sampled_mesh_cli(ek, save_dir, split, card):
    """Phase 18 (c), each in a process of its own: ``python -m
    stargcn_tpu_torch.train --mesh 1x1 --num_neighbors 8`` on
    ``transductive_ml_10m.yml`` (the CLI's synthetic graph, ``pallas``, 4
    steps), its ELL launches counted there; ``python -m
    stargcn_tpu_torch.parallel.scaling --meshes 1x1``; its ``--project``
    table fed ``split``, the sampled step without a mesh measured whole and
    its device part (``time_sampled_steps``); and ``python -m
    stargcn_tpu_torch.parallel.mesh_scale_check`` on the card, ``1 1 1``
    over NCCL beside ``2 2 1`` (two ranks on the card over gloo)."""
    out_dir = os.path.join(save_dir, "phase18_cli")
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from stargcn_tpu_torch.ops import ell_kernels as ek\n"
        "from stargcn_tpu_torch.train.__main__ import main\n"
        "r = main(sys.argv[1:])\n"
        "print(json.dumps({'launches': ek.LAUNCHES, 'result': r}))\n"
        % ROOT)
    args = ["--cfg", os.path.join(ROOT, "configs", "transductive_ml_10m.yml"),
            "--dataset", "synthetic", "--num_neighbors", "8", "--backend",
            "pallas", "--mesh", "1x1", "--max_iter", "4", "--save_dir",
            out_dir, "--silent", "--device", DEVICE]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    check(out.returncode == 0, f"the sampled train CLI with --mesh 1x1 "
          f"failed: {out.stderr[-3000:]}")
    last = json.loads(out.stdout.strip().splitlines()[-1])
    counts = last["launches"]
    # 4 steps of 4 + 4; evaluation passes add forward launches only.
    check(counts["ell_spmm_transpose"] == 16
          and counts["ell_spmm_fwd_only"] >= 16,
          f"the sampled --mesh 1x1 CLI launched {counts}")
    log(f"  train CLI --mesh 1x1 --num_neighbors 8: {t_cli:.1f} s in a "
        f"process of its own, {counts} ELL launches, result "
        f"{last['result']} [{card}]")
    numbers = {"cli_s": t_cli}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.scaling",
         "--meshes", "1x1", "--device", DEVICE, "--steps", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    numbers["scaling_s"] = time.perf_counter() - t0
    check(out.returncode == 0, f"scaling --meshes 1x1 failed: "
          f"{out.stderr[-3000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    check(row["full_graph"]["equal"] and row["sampled"]["equal"],
          f"scaling --meshes 1x1: counted collectives are not the modeled "
          f"ones: {row}")
    numbers["scaling"] = {k: (row[k] if k not in ("full_graph", "sampled")
                              else {kk: v for kk, v in row[k].items()
                                    if kk not in ("counted", "modeled")})
                          for k in row}
    log(f"  scaling --meshes 1x1 ({numbers['scaling_s']:.1f} s): full-graph "
        f"{row['full_graph']['step_ms']:.2f} ms a step, "
        f"{row['full_graph']['examples_per_s']:.0f} examples/s; sampled "
        f"{row['sampled']['step_ms']:.2f} ms, "
        f"{row['sampled']['examples_per_s']:.0f} examples/s; collectives "
        f"= modeled [{card}]")
    step_ms, split_ms = split["step_ms"], split["device_step_ms"]
    out = subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.scaling",
         "--project", "--sampled", "--step-ms", f"{step_ms:.3f}",
         "--split-ms", f"{split_ms:.3f}",
         "--batch", str(SAMPLED_MESH["batch"])],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"scaling --project failed: {out.stderr}")
    numbers["projection"] = [json.loads(line)
                             for line in out.stdout.splitlines()
                             if line.startswith("{")]
    numbers["projected_from"] = split
    for row in numbers["projection"]:
        log(f"    projected from {step_ms:.1f} ms on this card (device "
            f"{split_ms:.1f} ms divided): {row['mesh']}"
            f" {row['step_ms']:.2f} ms a step, {row['link_ms']:.3f} ms on "
            f"NVLink 4 ({row['link_ms_pcie']:.3f} over PCIe Gen5), "
            f"{row['examples_per_s']:.0f} examples/s")
    # The mesh-scale twin on the card: NCCL on one rank, gloo on two.
    t0 = time.perf_counter()
    twins = {shape: subprocess.Popen(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.mesh_scale_check",
         *shape, "--device", DEVICE, "--timeout", "400"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in (("1", "1", "1"), ("2", "2", "1"))}
    try:
        outs = {shape: p.communicate(timeout=480)[0]
                for shape, p in twins.items()}
    finally:
        for p in twins.values():
            p.kill()
    numbers["mesh_scale_check_s"] = time.perf_counter() - t0
    for shape, text in outs.items():
        ranks, d, m = shape
        over = "nccl" if DEVICE == "cuda" and ranks == "1" else "gloo"
        want = f"MESH SCALE OK {ranks} ranks {d}x{m} on {DEVICE} over {over}"
        check(twins[shape].returncode == 0 and want in text,
              f"mesh_scale_check {' '.join(shape)} on the card: "
              f"{text[-3000:]}")
        line = next(x for x in text.splitlines() if x.startswith(want))
        numbers[f"mesh_scale_check_{ranks}{d}{m}"] = line
        log(f"  mesh_scale_check {' '.join(shape)}: {line} "
            f"({numbers['mesh_scale_check_s']:.1f} s for both) [{card}]")
    return {"mesh 1x1 sampled train CLI": counts}, numbers


def run_phase18(ek, strainer, cfg, it, model_cfg, save_dir, card):
    """Phase 18: the sampled trainer on a device mesh at ML-10M width, on
    phase 8's trainer, one checkpoint of it and one batch (its state
    restored after).  Returns the launch counts of its paths and its
    numbers."""
    import torch

    t0 = time.perf_counter()
    numbers, launches = {}, {}
    ckpt = strainer.save_checkpoint("phase18")
    rs = it.rating_sampler(batch_size=strainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=strainer.s.recon_batch_size)
    batch = (strainer._build_batch_safe(rs, recon),)

    def plain(owner, b):
        with plain_ell_versions(ek):
            return sampled_grads(owner, b)

    ref = mesh_reference(strainer, batch, ckpt, grads_of=sampled_grads,
                         plain=plain)
    numbers["reference_spread"] = ref["spread"]
    log("  (a) a 1x1 mesh over NCCL")
    got, numbers["mesh_1x1"] = run_sampled_mesh_1x1(
        ek, strainer, cfg, it, model_cfg, ckpt, batch, ref, save_dir, card)
    launches.update(got)
    log("  (b) two ranks on the one card over gloo: 1x2, then 2x1")
    got, numbers["ranks_on_one_card"] = run_sampled_mesh_ranks_on_one_card(
        ek, strainer, cfg, it, model_cfg, ckpt, batch, ref, save_dir, card)
    launches.update(got)
    del ref
    torch.cuda.empty_cache()
    log("  (c) the train CLI with --mesh 1x1 --num_neighbors 8, scaling "
        "--meshes 1x1, its projection and mesh_scale_check")
    strainer.restore_checkpoint(ckpt)
    split, _ = time_sampled_steps(strainer, rs, recon, 3)
    log(f"  the sampled step without a mesh, fresh batches: "
        f"{split['step_ms']:.1f} ms = plan {split['plan_ms']:.1f} + pack "
        f"{split['pack_ms']:.1f} + copies {split['copy_ms']:.1f} + device "
        f"{split['device_step_ms']:.1f} (median of 3) [{card}]")
    got, numbers["cli"] = run_sampled_mesh_cli(ek, save_dir, split, card)
    launches.update(got)
    strainer.restore_checkpoint(ckpt)
    numbers["phase_s"] = time.perf_counter() - t0
    log(f"  phase 18 took {numbers['phase_s']:.1f} s on the host clock "
        f"[{card}]")
    return launches, numbers


def kernel_row(name, source, replaces, launches, worst, shapes):
    """One entry of the ``kernels`` line: the times are means over the
    directions measured (``shapes`` holds each)."""
    mean = lambda key: sum(s[key] for s in shapes) / len(shapes)  # noqa
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=worst, ms=mean("ms"),
        plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        library_ms=(mean("library_ms") if all(
            s.get("library_ms") is not None for s in shapes) else None),
        shapes=shapes)


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--phases", default=None,
        help="comma-separated phases out of 4, 8 and 11 to 18 (those "
             "that build their own data) to run alone after phases 1 and 2, "
             "in a process that ran no other phase (13b: phase 13's ML-1M "
             "part alone, which phase 13 runs so; 15b: phase 15's query "
             "timing on saved artifacts, which phase 15 runs so; 17b / 18b: "
             "one rank of phase 17 (b) / 18 (b), which those phases run "
             "so); default: every phase")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    phases = {p.strip() for p in args.phases.split(",")}
    if not phases or not phases <= {"4", "8", "11", "12", "13", "13b", "14",
                                    "15", "15b", "16", "17", "17b", "18",
                                    "18b"}:
        ap.error("--phases takes 4, 8, 11, 12, 13, 13b, 14, 15, 15b, 16, "
                 "17, 17b, 18 or 18b, comma-separated")
    return phases


def run_phases_alone(bd, ek, card, phases):
    """``--phases``: phases 4, 8 and 11 to 18 without the phases before
    them (phases 4, 8 and 13 to 18 build phase 4's ML-10M graph and trainer
    first, phase 4 its bit packs and ``pack_bits``' check, phase 8 the
    sampled slice with phase 9, phase 18 phase 8's sampled trainer); their
    numbers on one line."""
    import torch

    numbers = {}
    if "17b" in phases:
        mesh_rank_main(bd, card)
        return
    if "18b" in phases:
        sampled_mesh_rank_main(ek, card)
        return
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        if "15b" in phases:
            log("== 15 (b). recommend latency on saved artifacts")
            run_query_latency_fresh(card)
        if "13b" in phases:
            log("== 13 (b). TRAIN.DEVICE_SAMPLER at ML-1M on dense")
            numbers["device_sampler_ml1m"] = run_device_sampler_ml1m(
                bd, ek, card)
        if "11" in phases:
            log("== 11. slice: ML-1M full-graph training on KERNEL.BACKEND "
                "auto (dense) and xla, serving, the train CLI")
            numbers["full_graph_dense_xla"] = run_dense_xla_slice(
                bd, ek, card, save_dir)
            torch.cuda.empty_cache()
        if "12" in phases:
            log("== 12. slice: inductive ML-1M (items held out) from an "
                "archive on disk")
            numbers["inductive_ml1m"], _ = run_inductive_slice(
                bd, ek, card, save_dir)
            torch.cuda.empty_cache()
        if phases & {"4", "8", "13", "14", "15", "16", "17", "18"}:
            from stargcn_tpu_torch.train import Trainer, TrainSettings

            log("== 4. set-up (for phases 4, 8 and 13 to 18): ML-10M graph, "
                "iterator, trainer")
            (cfg, it, model_cfg), t_graph = host_s(build_ml10m)
            trainer = Trainer(model_cfg, it, TrainSettings.from_cfg(cfg),
                              save_dir=save_dir, device=DEVICE)
            log(f"  host graph build: {t_graph:.2f} s [{card}]")
        if "4" in phases:
            log("== 4. the bit packs and pack_bits")
            packs = {v: trainer.variants.bit_pack(v)
                     for v in ("train", "test")}
            numbers["pack_bits"] = pack_bits_check(bd, trainer, packs, card)
            del packs
            torch.cuda.empty_cache()
        if "8" in phases:
            log("== 8. slice: ML-10M sampled mini-batch training (batch "
                "4096, fanout 8) through the ELL kernels, and phase 9")
            launches, _, _, numbers["sampled_training"], strainer = \
                run_sampled_slice(bd, ek, cfg, it, model_cfg, trainer,
                                  save_dir, card)
            numbers["sampled_training"]["launches_by_path"] = launches
            del strainer
            torch.cuda.empty_cache()
        if "13" in phases:
            log("== 13. slice: batch sampling and plan building on the "
                "card, and the prefetch threads")
            launches, numbers["sampling_on_card"] = run_sampling_on_card(
                bd, ek, cfg, it, model_cfg, trainer, save_dir, card)
            numbers["sampling_on_card"]["launches_by_path"] = launches
        if "14" in phases:
            log("== 14. slice: the model options (bf16 compute, feature "
                "projection, per-edge dropout, sampled remat)")
            launches, numbers["model_options"], _ = run_model_options(
                bd, ek, cfg, it, model_cfg, trainer, save_dir, card)
            numbers["model_options"]["launches_by_path"] = launches
        if "15" in phases:
            log("== 15. slice: ranking, the ell backend and resilience at "
                "ML-10M")
            numbers["phase15"] = run_phase15(bd, ek, trainer, save_dir, card)
        if "16" in phases:
            log("== 16. slice: the profiler, the FLOP count, the reference "
                "step estimate and the host graph library at ML-10M")
            launches, numbers["phase16"] = run_phase16(bd, trainer, cfg,
                                                       save_dir, card)
            numbers["phase16"]["launches_by_path"] = launches
        if "17" in phases:
            log("== 17. slice: full-graph training on a device mesh at "
                "ML-10M (1x1 over NCCL; 1x2 and 2x1 over gloo on one card)")
            launches, numbers["mesh"] = run_phase17(
                bd, trainer, cfg, it, model_cfg, save_dir, card)
            numbers["mesh"]["launches_by_path"] = launches
        if "18" in phases:
            log("== 18. slice: sampled training on a device mesh at ML-10M "
                "(1x1 over NCCL; 1x2 and 2x1 over gloo on one card)")
            strainer, t_make = host_s(lambda: sampled_ml10m(
                cfg, it, model_cfg, save_dir))
            log(f"  phase 8's SampledTrainer: {t_make:.2f} s, caps "
                f"{strainer.caps} [{card}]")
            launches, numbers["sampled_mesh"] = run_phase18(
                ek, strainer, cfg, it, model_cfg, save_dir, card)
            numbers["sampled_mesh"]["launches_by_path"] = launches
    if numbers:
        log(json.dumps(numbers))


def main(argv=None):
    phases = parse_args(sys.argv[1:] if argv is None else argv)
    if not os.path.isdir(os.path.join(ROOT, "stargcn_tpu_torch")):
        fail("stargcn_tpu_torch/ is not beside chip_smoke.py: run it from "
             "a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    # Full float32 in the plain versions' matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. environment")
    card = card_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card: {card}")

    log("== 2. build")
    from stargcn_tpu_torch.graph import kernels as gk
    from stargcn_tpu_torch.graph import native
    from stargcn_tpu_torch.ops import _build
    from stargcn_tpu_torch.ops import bitdense as bd
    from stargcn_tpu_torch.ops import ell_kernels as ek

    # The host extension builds with g++ while nvcc builds the kernels; a
    # failed build raises here.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        host_ext = pool.submit(native.build)
        _, t_build = host_s(_build.build)
        host_path = host_ext.result()
        t_host_ext = time.perf_counter() - t0
    _, t_load = host_s(gk.native_module)
    log(f"  nvcc build of {sorted(_build.SIGNATURES)}: {t_build:.2f} s; "
        f"g++ build of {native.SOURCE.name} beside it: {t_host_ext:.2f} s in "
        f"all ({os.path.basename(host_path)}), loaded in {t_load:.3f} s")
    for name, text in _build.build_logs.items():
        # ptxas -v: registers, shared memory and spills of every instance,
        # each after the (mangled) name of the instance it belongs to.
        for line in text.strip().splitlines():
            if "Compiling entry function" in line:
                entry = re.search(r"entry function '([^']+)'", line)
                log(f"  [{name}] {entry[1] if entry else line.strip()}:")
            elif "registers" in line or "spill" in line or "rror" in line:
                log(f"  [{name}] {line.strip()}")
    if phases:
        run_phases_alone(bd, ek, card, phases)
        return finish(card)

    log("== 3. kernel check (small cases)")
    worst = small_kernel_checks(bd)
    worst.update(small_kernel16_checks(bd))
    for name, err in small_design_checks(bd).items():
        worst[name] = max(worst[name], err)
    worst.update(small_ell_checks(ek))
    worst["ell_sddmm"] = max(worst["ell_sddmm"], small_sddmm_checks(ek))

    log("== 4. set-up: ML-10M graph, iterator, trainer, bit packs")
    from stargcn_tpu_torch.train import Trainer, TrainSettings

    (cfg, it, model_cfg), t_graph = host_s(build_ml10m)
    log(f"  host graph build ({ML10M['num_users']} x {ML10M['num_items']}, "
        f"{it.all_graph['user', 'movie'].nnz} edges): {t_graph:.2f} s "
        f"[{card}]")
    check(model_cfg.backend == "bitdense",
          f"ML-10M resolved to {model_cfg.backend!r}, not 'bitdense'")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        trainer, t_trainer = host_s(lambda: Trainer(
            model_cfg, it, TrainSettings.from_cfg(cfg), save_dir=save_dir,
            device=DEVICE))
        log(f"  trainer (parameters, edge arrays, pair lookup): "
            f"{t_trainer:.2f} s [{card}]")
        packs = {}
        for variant in ("train", "test"):
            packs[variant], t_pack = host_s(
                lambda: trainer.variants.bit_pack(variant))
            log(f"  {variant}-variant bit packs (both directions): "
                f"{t_pack:.2f} s; user "
                f"{tuple(packs[variant]['user']['pf'].shape)}, item "
                f"{tuple(packs[variant]['item']['pf'].shape)} [{card}]")
        check(trainer.variants.bit_pack("valid") is packs["train"],
              "the valid variant should share the train variant's packs")
        pack_numbers = pack_bits_check(bd, trainer, packs, card)

        log("== 5. kernel check (ML-10M packs) and times")
        R = model_cfg.num_links
        F = model_cfg.embed_units + 1    # the ones column carries the bias
        e_worst, e_shapes = full_expand_checks(bd, packs["test"], R, F, card)
        r_worst, r_shapes = full_reduce_checks(bd, packs["train"], R, F,
                                               card)
        adjoint_check(bd, packs["train"], R, F)

        log("== 6. slice: ML-10M bitdense training (20 steps) + serving of "
            "the trained parameters")
        train_launches, train_numbers = run_training_slice(bd, trainer, card)

        # Built after phase 6, whose peak memory is the full-graph path's.
        log("== 5b. set-up of a KERNEL.BIT_IMPL: pallas16 trainer; 16-bit "
            "kernel check (row-interleaved ML-10M packs) and times")
        t16, t_t16 = host_s(lambda: Trainer(
            dataclasses.replace(model_cfg, bit_impl="pallas16"), it,
            TrainSettings.from_cfg(cfg), save_dir=save_dir, save_id=2,
            device=DEVICE))
        packs16 = {}
        for variant in ("train", "test"):
            packs16[variant], t_pack = host_s(
                lambda: t16.variants.bit_pack(variant))
            log(f"  {variant}-variant row_interleave=128 packs for a "
                f"KERNEL.BIT_IMPL: pallas16 trainer (built {t_t16:.2f} s): "
                f"{t_pack:.2f} s [{card}]")
        pack_layout_check(bd, packs16, packs, R)
        e16_worst, e16_shapes = full_expand_checks(
            bd, packs16["test"], R, F, card, "16", natural=packs["test"])
        r16_worst, r16_shapes = full_reduce_checks(
            bd, packs16["train"], R, F, card, "16", natural=packs["train"])
        adjoint_check(bd, packs16["train"], R, F, "16")

        log("== 6b. slice: ML-10M bitdense training, export and queries "
            "with KERNEL.BIT_IMPL: pallas16")
        launches16 = run_training16_slice(bd, trainer, t16, card,
                                          train_numbers)
        del t16, packs16
        launches16["pallas16 train CLI"] = run_pallas16_cli(bd, card,
                                                            save_dir)

        log("== 7. slice: ML-10M bitdense serving export + queries")
        export_launches = run_serving_slice(bd, trainer, card)

        log("== 8. slice: ML-10M sampled mini-batch training (batch 4096, "
            "fanout 8) through the ELL kernels")
        del packs
        torch.cuda.empty_cache()
        ell_launches, ell_worst, ell_shapes, sampled_numbers, strainer = \
            run_sampled_slice(bd, ek, cfg, it, model_cfg, trainer, save_dir,
                              card)

        log("== 13. slice: batch sampling and plan building on the card, "
            "and the prefetch threads")
        card_launches, card_numbers = run_sampling_on_card(
            bd, ek, cfg, it, model_cfg, trainer, save_dir, card, strainer,
            {"training": train_numbers, "sampled_training": sampled_numbers})
        torch.cuda.empty_cache()

        log("== 14. slice: the model options (bf16 compute, feature "
            "projection, per-edge dropout, sampled remat)")
        option_launches, option_numbers, walks = run_model_options(
            bd, ek, cfg, it, model_cfg, trainer, save_dir, card, strainer)
        torch.cuda.empty_cache()

        log("== 15. slice: ranking, the ell backend and resilience at "
            "ML-10M")
        phase15_numbers = run_phase15(bd, ek, trainer, save_dir, card)
        torch.cuda.empty_cache()

        log("== 16. slice: the profiler, the FLOP count, the reference step "
            "estimate and the host graph library at ML-10M")
        phase16_launches, phase16_numbers = run_phase16(bd, trainer, cfg,
                                                        save_dir, card)
        torch.cuda.empty_cache()

        log("== 17. slice: full-graph training on a device mesh at ML-10M "
            "(1x1 over NCCL; 1x2 and 2x1 over gloo on one card)")
        phase17_launches, phase17_numbers = run_phase17(
            bd, trainer, cfg, it, model_cfg, save_dir, card)
        torch.cuda.empty_cache()

        log("== 18. slice: sampled training on a device mesh at ML-10M "
            "(1x1 over NCCL; 1x2 and 2x1 over gloo on one card)")
        phase18_launches, phase18_numbers = run_phase18(
            ek, strainer, cfg, it, model_cfg, save_dir, card)
        del strainer
        torch.cuda.empty_cache()

        log("== 10. probes: probe_bitcast and probe_int8_mma")
        probe_launches, probe_worst, probe_shapes = run_probes(card)

        log("== 11. slice: ML-1M full-graph training on KERNEL.BACKEND auto "
            "(dense) and xla, serving, the train CLI")
        torch.cuda.empty_cache()
        dense_numbers = run_dense_xla_slice(bd, ek, card, save_dir)
        torch.cuda.empty_cache()
        log("== 11b. slice: one ML-10M training step on KERNEL.BACKEND xla")
        dense_numbers["ml10m_xla"] = run_ml10m_xla_step(bd, ek, trainer,
                                                        card)
        del trainer
        torch.cuda.empty_cache()
        log("== 12. slice: inductive ML-1M (items held out) from an archive "
            "on disk: dense, bitdense and sampled pallas training, serving, "
            "the train CLI")
        inductive_numbers, inductive_launches = run_inductive_slice(
            bd, ek, card, save_dir)

    kernel_ms = sum(sum(s["ms"] for s in shapes) * 2
                    for shapes in (e_shapes, r_shapes))
    log(f"  one training step: {train_numbers['step_ms']:.1f} ms on the "
        f"host clock, of which the 8 bit-kernel launches take about "
        f"{kernel_ms:.1f} ms on the card (per-launch times of phase 5) "
        f"[{card}]")
    ell_ms = 2 * sum(s["ms"] for n in ("ell_spmm_fwd_only",
                                        "ell_spmm_transpose")
                     for s in ell_shapes[n])
    log(f"  one sampled training step: "
        f"{sampled_numbers['pallas']['step_ms']:.1f} ms on the host clock, "
        f"of which the 8 ELL-kernel launches take about {ell_ms:.1f} ms on "
        f"the card (per-launch times of phase 9) [{card}]")
    rows = [
        kernel_row("bit_expand_matmul",
                   "stargcn_tpu_torch/ops/csrc/bit_expand.cu",
                   "stargcn_tpu/ops/bitdense.py:328",
                   train_launches["bit_expand_matmul"]
                   + export_launches["bit_expand_matmul"],
                   max(e_worst, worst["bit_expand_matmul"]), e_shapes),
        kernel_row("bit_reduce_matmul",
                   "stargcn_tpu_torch/ops/csrc/bit_reduce.cu",
                   "stargcn_tpu/ops/bitdense.py:360",
                   train_launches["bit_reduce_matmul"],
                   max(r_worst, worst["bit_reduce_matmul"]), r_shapes),
    ]
    rows[0]["launches_by_path"] = {"train_iteration": train_launches[
        "bit_expand_matmul"], "export": export_launches["bit_expand_matmul"]}
    rows[1]["launches_by_path"] = {"train_iteration": train_launches[
        "bit_reduce_matmul"]}
    # The 16-bit pair: the launches of one pallas16 step; its export and
    # the train CLI, each counted from 0, under launches_by_path.
    for name, source, replaces, shapes, worst16 in (
            ("bit_expand_matmul16", "bit_expand.cu", 391, e16_shapes,
             e16_worst),
            ("bit_reduce_matmul16", "bit_reduce.cu", 418, r16_shapes,
             r16_worst)):
        by_path = {path: counts[name] for path, counts in launches16.items()}
        rows.append(kernel_row(
            name, f"stargcn_tpu_torch/ops/csrc/{source}",
            f"stargcn_tpu/ops/bitdense.py:{replaces}",
            by_path["pallas16 train_iteration"], max(worst16, worst[name]),
            shapes))
        rows[-1]["launches_by_path"] = by_path
    # Every path was driven with the counts set to 0 just before it.  A
    # sampled training step launches no ell_sddmm (the plan's weights need
    # no gradient), so that kernel's count is the sum over its own two
    # callers; the other two report the training step's alone.
    for name, source, replaces in (
            ("ell_spmm_fwd_only", "ell_spmm.cu", 93),
            ("ell_spmm_transpose", "ell_spmm_t.cu", 225),
            ("ell_sddmm", "ell_sddmm.cu", 170)):
        by_path = {path: counts[name]
                   for path, counts in ell_launches.items()}
        launches = by_path["sampled train_iteration"] or sum(
            by_path.values())
        check(launches > 0, f"{name} was launched on no driven path")
        rows.append(kernel_row(
            name, f"stargcn_tpu_torch/ops/csrc/{source}",
            f"stargcn_tpu/ops/pallas_kernels.py:{replaces}",
            launches, max(ell_worst[name], worst[name]), ell_shapes[name]))
        rows[-1]["launches_by_path"] = by_path
    rows[-1]["seg_take_k_corr_case"] = sampled_numbers[
        "sddmm_seg_take_k_corr"]
    for name, source, replaces in (
            ("probe_bitcast", "probe_bitcast.cu", "scripts/probe_bitcast.py:37"),
            ("probe_mma", "probe_mma.cu", "scripts/probe_int8_mxu.py:26")):
        by_path = {path: counts[name]
                   for path, counts in probe_launches.items()}
        rows.append(kernel_row(
            name, f"stargcn_tpu_torch/ops/csrc/{source}", replaces,
            sum(by_path.values()), probe_worst[name], probe_shapes[name]))
        rows[-1]["launches_by_path"] = by_path
    # Phase 12 drives the bit pair and the ELL pair on inductive masks,
    # each path with the counts set to 0 just before it.
    for row in rows:
        for path, counts in inductive_launches.items():
            if counts.get(row["name"]):
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    # Phase 13's paths, each with the counts set to 0 just before it: the
    # bit pair under TRAIN.DEVICE_SAMPLER, the ELL pair in the prefetched
    # and serial sampled fit.  The plan_device paths launch no kernel.
    for row in rows:
        for path, counts in card_launches.items():
            if counts.get(row["name"]):
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    # Phase 14's paths, each with the counts set to 0 just before it: the
    # bit pair in bf16 and at F = 81, the ELL pair with features and under
    # remat; its F = 65 / 81 walk times on the ML-10M packs.
    for row in rows:
        for path, counts in option_launches.items():
            if counts.get(row["name"]):
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    # Phase 16's paths, each with the counts set to 0 just before it: the
    # profiled fit and the StepTimer's steps; phase 17's: the 1x1 mesh's
    # step, evaluation and export, each rank's step on 1x2 and 2x1, and the
    # --mesh 1x1 train CLI; phase 18's: the same of the sampled mesh (the
    # ELL pair), its evaluation and the sampled --mesh 1x1 train CLI.
    for row in rows:
        for path, counts in {**phase16_launches, **phase17_launches,
                             **phase18_launches}.items():
            if counts.get(row["name"]):
                row.setdefault("launches_by_path", {})[path] = counts[
                    row["name"]]
    for row, kind in ((rows[0], "expand"), (rows[1], "reduce")):
        row["walk_by_f"] = {str(F): walks[F][kind] for F in walks}
    log(json.dumps({"sampled_mesh": phase18_numbers}))
    log(json.dumps({"mesh": phase17_numbers}))
    log(json.dumps({"phase16": phase16_numbers}))
    log(json.dumps({"phase15": phase15_numbers}))
    log(json.dumps({"model_options": option_numbers}))
    log(json.dumps({"sampling_on_card": card_numbers}))
    log(json.dumps({"inductive_ml1m": inductive_numbers}))
    log(json.dumps({"full_graph_dense_xla": dense_numbers}))
    log(json.dumps({"pack_bits": pack_numbers}))
    log(json.dumps({"training": train_numbers}))
    log(json.dumps({"sampled_training": sampled_numbers}))
    log(json.dumps({"kernels": rows}))
    finish(card)


def finish(card):
    import torch

    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
