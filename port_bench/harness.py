"""One run of one cell: set-up, the measured window, the check, the result.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``: the shipped YAML as it runs, and
the graph it runs on) and a traffic mix (``traffic/<traffic>.json``: the
calls the window makes).  The run:

1. makes the graph from the seed (``graphs.py``) and hands it to the
   program's ``CSRMat``, ``HeterGraph`` and ``DataIterator`` (span
   ``graph_build``);
2. builds the program's ``Trainer`` on the card, puts the benchmark's own
   weights (drawn on the card from the seed) into it, and makes one
   warm-up call of the traffic's entry, ``Trainer.fit(max_iter=
   steps_per_call)``, whose first steps ``check.StepRecorder`` records
   (span ``trainer_warm``); set-up ends here;
3. calls the entry again and again until ``seconds`` have passed, and
   synchronises: the window is whole calls, each of ``steps_per_call``
   steps of a full batch (``--trace 1``: its first calls, up to
   ``trace.TRACE_SECONDS``, under the profiler, and the rest untraced,
   which the metrics that take a rate read);
4. reads the peak memory, frees the program, runs the reference over the
   recorded steps and compares (``check.py``).

Every per-layer metric is a reader in ``metrics/<name>.py`` that takes
the run's context (``Context``) and returns its number, or ``None`` where
it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from port_bench import check, graphs
from port_bench import trace as T
from port_bench.reference import model as RM
from port_bench.reference import train as RT

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stargcn_tpu")


class NoDevice(RuntimeError):
    """The cards a cell asks for are not there."""


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""

    spans: dict                  # name -> [seconds]
    trace: dict                  # trace.reduce_trace's result ({} untraced)
    steps: int                   # training steps in the traced calls
    free_steps: int              # training steps in the untraced calls
    free_s: float                # and their seconds, ending in a sync
    model_cfg: object            # the program's STARGCNConfig
    train_batch: int             # pairs a step
    edges: dict                  # edges of the 'train' graph


class Spans:
    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name, sync=False):
        sync = sync and torch.cuda.is_available()
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.record_function(f"port_bench.{name}"):
            yield
        if sync:
            torch.cuda.synchronize()
        self.spans.setdefault(name, []).append(time.perf_counter() - t)


def build_cfg(conf, traffic, seed32, cfg_override=None):
    from stargcn_tpu_torch.utils.config import default_cfg, merge_cfg

    cfg = default_cfg()
    merge_cfg(conf["yaml"], cfg)
    merge_cfg(traffic.get("cfg", {}), cfg)
    if cfg_override:
        merge_cfg(cfg_override, cfg)
    cfg.SEED = seed32
    return cfg


def build_data(g, cfg, seed32):
    """The program's graph and data iterator over the benchmark's graph
    ``g`` and its split."""
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.graph import CSRMat, HeterGraph

    csr = CSRMat.from_coo(g.user, g.item, g.rating, g.num_users,
                          g.num_items, multi_link=g.levels)
    hg = HeterGraph(features={"user": np.zeros((g.num_users, 1), np.float32),
                              "movie": np.zeros((g.num_items, 1),
                                                np.float32)},
                    csr_mat_dict={("user", "movie"): csr})

    def pairs(idx):
        return np.stack([g.user[idx], g.item[idx]]).astype(np.int32)

    p_zero = cfg.EMBED.P_ZERO
    return DataIterator(hg, "user", "movie", test_node_pairs=pairs(g.test),
                        valid_node_pairs=pairs(g.valid),
                        embed_P_mask=cfg.EMBED.MASK_PROP,
                        embed_p_zero=p_zero, embed_p_self=1.0 - p_zero,
                        seed=seed32)


def put_weights(trainer, weights):
    """Copy the benchmark's weights into the program's parameters, which
    must be the model's, leaf for leaf."""
    params = dict(trainer.model.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(v.shape) for k, v in weights.items()}
    if shapes != want:
        raise ValueError(f"the program's parameters {shapes} are not the "
                         f"model's {want}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])


@contextlib.contextmanager
def tf32(on: bool):
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def metric_reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A cell's configuration, traffic, the program built for it and what
    its warm-up call recorded."""

    def __init__(self, workload, seed, device="cuda", graph_override=None,
                 cfg_override=None, spans=None, bench=None,
                 traffic_override=None):
        bench = bench or manifest()
        self.work = next(w for w in bench["workloads"]
                         if w["name"] == workload)
        self.conf = load_json("configs", f"{self.work['config']}.json")
        self.traffic = dict(load_json("traffic",
                                      f"{self.work['traffic']}.json"),
                            **(traffic_override or {}))
        self.seed, self.device = int(seed), torch.device(device)
        self.seed32 = self.seed % 2**32
        self.spans = spans or Spans()
        spec = dict(self.conf["graph"], **(graph_override or {}))
        self.graph = graphs.generate(spec, self.seed)
        self.cfg = build_cfg(self.conf, self.traffic, self.seed32,
                             cfg_override)
        # Every step of a call trains on one full batch: the train sampler
        # yields whole batches only, and a call runs whole chunks.
        spc, k = self.traffic["steps_per_call"], self.cfg.TRAIN.SCAN_STEPS
        if spc % k:
            raise ValueError(f"steps_per_call {spc} is no multiple of "
                             f"TRAIN.SCAN_STEPS {k}")
        self.batch = min(self.cfg.TRAIN.RATING_BATCH_SIZE,
                         int(self.graph.train_mask().sum()))
        self.nonfinite = 0

    def log(self, msg):
        """``fit``'s log: counts its non-finite-loss reports."""
        if "Non-finite" in str(msg):
            self.nonfinite += 1

    def build(self, n_check=3, fault=None, max_iter=None):
        """The program's data (kept from an earlier build), trainer (with
        the benchmark's weights) and the warm-up call of ``max_iter``
        steps (default the traffic's), recording the first ``n_check``
        steps.  ``fault(trainer)``, where given, breaks the trainer before
        the warm-up call."""
        from stargcn_tpu_torch.models import build_model_config
        from stargcn_tpu_torch.train import Trainer, TrainSettings

        g, cfg = self.graph, self.cfg
        if getattr(self, "it", None) is None:
            with self.spans.span("graph_build"):
                self.it = build_data(g, cfg, self.seed32)
        self.model_cfg = build_model_config(
            cfg, g.num_users, g.num_items, g.levels.size,
            num_edges=g.num_edges)
        want = self.conf["expect_backend"]
        if cfg.KERNEL.BACKEND == "auto" and self.model_cfg.backend != want:
            raise ValueError(f"'auto' resolved to {self.model_cfg.backend}, "
                             f"not the cell's {want}")
        self.spec = RM.ModelSpec.from_yaml(
            self.conf["yaml"], g.num_users, g.num_items, g.levels.size,
            operand=self.conf.get("reference_operand", {}).get(
                self.device.type, "float32"))
        with self.spans.span("trainer_warm"):
            self.trainer = Trainer(self.model_cfg, self.it,
                                   TrainSettings.from_cfg(cfg), save_dir=None,
                                   device=self.device)
            weights = RM.make_params(self.spec, self.seed, self.device)
            put_weights(self.trainer, weights)
            self.weights0 = {k: v.cpu() for k, v in weights.items()}
            del weights
            if cfg.TRAIN.VALID_INTERVAL <= self.traffic["steps_per_call"]:
                raise NotImplementedError("the check compares training "
                                          "steps; a call that validates "
                                          "needs its evaluation compared")
            if fault is not None:
                fault(self.trainer)
            self.recorder = check.StepRecorder(self.trainer, n_check)
            try:
                self.call(max_iter)
            finally:
                self.recorder.close()
            self.recorder.raise_missing()
            if not self.recorder.done():
                raise RuntimeError("the warm-up call did not run the "
                                   "steps the check reads")
            self.sync()

    def call(self, max_iter=None):
        """One call of the traffic's entry."""
        self.trainer.fit(max_iter=max_iter or self.traffic["steps_per_call"],
                         log=self.log)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def program_side(self) -> dict:
        r = self.recorder
        return {"losses": r.losses, "grad1": r.grad1,
                "delta": RT.leaf_norms({k: r.params_n[k] - self.weights0[k]
                                        for k in r.params_n})}

    def free_program(self, keep_data=False):
        """Drop the program's state (after the peak memory is read); with
        ``keep_data`` its data iterator stays for another build."""
        self.trainer = None
        if not keep_data:
            self.it = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_side(self, allow_tf32=False) -> dict:
        """The reference over the recorded steps, float32 with TF32 off
        unless ``allow_tf32``."""
        g, cfg, r = self.graph, self.cfg, self.recorder
        dev = self.device
        rg = RM.Graph(g.user, g.item, g.level, g.num_users, g.num_items,
                      g.levels.size, dev)
        train_edges = torch.as_tensor(np.flatnonzero(g.train_mask()),
                                      device=dev)
        ratings = torch.as_tensor(g.rating, device=dev)
        with tf32(allow_tf32):
            return RT.follow(self.spec, rg, train_edges, ratings,
                             self.weights0, r.steps, lr=cfg.TRAIN.LR,
                             clip=cfg.TRAIN.GRAD_CLIP, wd=cfg.TRAIN.WD)


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        graph_override=None, cfg_override=None, bench=None, out=sys.stdout,
        traffic_override=None):
    """One run; returns the result's dict (``correct``, ...).  The
    overrides shrink a cell for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or manifest()
    work = next(w for w in bench["workloads"] if w["name"] == workload)
    if torch.device(device).type == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < work["chips"]):
        raise NoDevice(f"{workload} needs {work['chips']} CUDA device(s)")
    spans = Spans()
    cell = Cell(workload, seed, device, graph_override, cfg_override, spans,
                bench, traffic_override)
    cell.build()
    setup_s = time.perf_counter() - t_start
    spc = cell.traffic["steps_per_call"]
    # With ``trace`` the window's first calls, up to ``T.TRACE_SECONDS``,
    # run under the profiler; the rest of the window runs untraced.
    prof = T.start() if trace else None
    mark = torch.profiler.record_function(T.WINDOW)
    mark.__enter__()
    traced_calls = 0
    w0 = time.perf_counter()
    free0 = w0
    calls = []
    while True:
        t = time.perf_counter()
        cell.call()
        calls.append(time.perf_counter() - t)
        if prof is not None and not traced_calls and (
                time.perf_counter() - w0 >= min(seconds, T.TRACE_SECONDS)):
            cell.sync()
            mark.__exit__(None, None, None)
            traced_calls = len(calls)
            t = time.perf_counter()
            prof.stop()
            free0 = time.perf_counter()
            w0 += free0 - t             # the stop is not the window's
        if time.perf_counter() - w0 >= seconds:
            break
    cell.sync()
    w1 = time.perf_counter()
    if prof is None:
        mark.__exit__(None, None, None)
    print("calls_s: " + json.dumps(calls), file=sys.stderr)
    window_s = w1 - w0
    steps = len(calls) * spc
    if 0 < traced_calls < len(calls):
        print(f"traced calls {np.mean(calls[:traced_calls])!r} s, untraced "
              f"{np.mean(calls[traced_calls:])!r} s on average",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded after the window: {found}")
    dev = cell.device
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    reduced = T.read(prof) if prof is not None else {}
    ctx = Context(
        spans={k: v for k, v in spans.spans.items()}, trace=reduced,
        steps=traced_calls * spc, free_steps=steps - traced_calls * spc,
        free_s=w1 - free0,
        model_cfg=cell.model_cfg, train_batch=cell.batch,
        edges={"train": int(cell.graph.train_mask().sum())})
    prog = cell.program_side()
    cell.free_program()
    ref = cell.reference_side()
    numbers = check.compare(prog, ref)
    print("left out of change_gap: " + json.dumps(
        check.still_leaves(ref)), file=sys.stderr)
    limits = check.limits_for(work["config"])
    correct = all(v <= limits[k] for k, v in numbers.items())

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {
            "train_examples_per_s": {"value": steps * ctx.train_batch
                                     / window_s, "unit": "examples/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": work["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(steps),
              "failed": int(cell.nonfinite), "metrics": metrics,
              "device": device_info}
    if trace and reduced:
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
        result["breakdown"] = {
            "device_ops": T.top((k[0], k[1]) for k in reduced["kernels"]),
            "idle_gaps": T.top(reduced["idle"])}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    print("graph: " + json.dumps(graphs.describe(cell.graph)), file=out)
    return result
