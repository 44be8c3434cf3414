"""The program's own spans and counters (``stargcn_tpu_torch.utils.
profiling``) over one cell's run, at the cell's own size on the card (the
benchmark's own runs do not run this):

1. set-up as ``run.py`` makes it (``harness.Cell.build``), recording on:
   the ``stargcn.setup.*`` spans;
2. the first calls, up to ``trace.TRACE_SECONDS``, under the profiler and
   recording on: the traced window's idle gaps, each named by the main
   thread's innermost ``stargcn.*`` span at its middle and the operator
   that ``trace.reduce_trace`` names there (``name_gaps``);
3. ``--seconds`` of untraced calls, recording on from their start: the
   per-step numbers (``step_numbers``) and the calls' own seconds a step;
4. the cost of recording: ``--pairs`` pairs of untraced calls, one with
   recording off and one on, in alternating order; and the host cost of
   one span on its own (``span_cost_us``) times the spans a step.

    python3 port_bench/spans.py --workload ml10m.train --seed 3000000019 \\
        --seconds 30 --pairs 12

Prints one JSON line.  The reference check is not made.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench import trace as T  # noqa: E402

SPAN = "stargcn."
BETWEEN = "host (between operators)"
# metric -> the spans whose seconds it adds, a step.
PER_STEP = {
    "host_prep_ms_per_step": ("stargcn.fit.host_prep",),
    "prefetch_wait_ms_per_step": ("stargcn.fit.prefetch_wait",),
    "loss_and_grads_host_ms_per_step": ("stargcn.step.loss_and_grads",),
    "optimizer_host_ms_per_step": ("stargcn.step.optimizer",),
    "device_wait_ms_per_step": ("stargcn.step.to_device",
                                "stargcn.fit.stats_fetch"),
}
# metric -> the set-up span whose seconds it is.
SETUP = {"pair_lookup_build_s": "stargcn.setup.pair_lookup",
         "bit_pack_build_s": "stargcn.setup.bit_pack"}
# The main thread's spans that make up a step's wall time between them.
MAIN_STEP = ("prefetch_wait_ms_per_step", "device_wait_ms_per_step",
             "loss_and_grads_host_ms_per_step", "optimizer_host_ms_per_step")


def step_numbers(totals, counters, setup_totals):
    """Each metric of ``PER_STEP`` (1e3 x its spans' seconds over
    ``stargcn.fit.steps``) and ``SETUP`` (the set-up span's seconds), or
    None where its spans never ran."""
    steps = counters.get("stargcn.fit.steps", 0)
    out = {}
    for metric, names in PER_STEP.items():
        got = [totals[n][0] for n in names if n in totals]
        out[metric] = 1e3 * sum(got) / steps if got and steps else None
    for metric, name in SETUP.items():
        out[metric] = setup_totals[name][0] if name in setup_totals else None
    return out


def name_gaps(events):
    """The idle gaps of ``trace.reduce_trace``, each named
    ``"<span> / <operator>"``: the main thread's innermost ``stargcn.*``
    span at the gap's middle, and the innermost host event there other
    than a span (the main thread's, else another thread's, else
    ``BETWEEN``).  Where no span holds the middle, the name is the
    operator's alone.  ``[(name, seconds)]``."""
    win = [e for e in events if e.get("name") == T.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return []
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    busy, spans, ops = [], [], {}
    for e in events:
        if "dur" not in e:
            continue
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat"), e.get("name")
        if cat in T.DEVICE_CATS:
            if te > w0 and ts < w1:
                busy.append((max(ts, w0), min(te, w1)))
        elif cat in T.HOST_CATS and name != T.WINDOW:
            if str(name).startswith(SPAN):
                if e.get("tid") == main_tid:
                    spans.append((ts, te, name))
            else:
                ops.setdefault(e.get("tid"), []).append((ts, te, name))
    edges = [w0] + [x for s, e in T._union(busy) for x in (s, e)] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    mids = sorted(((s + e) / 2, k) for k, (s, e) in enumerate(gaps))
    times = [m for m, _ in mids]
    names = T._innermost(ops.pop(main_tid, []), times)
    for other in ops.values():
        names = [n or (o and f"{o} (another thread)")
                 for n, o in zip(names, T._innermost(other, times))]
    held = T._innermost(spans, times)
    out = [None] * len(gaps)
    for (_, k), op, span in zip(mids, names, held):
        op = op or BETWEEN
        out[k] = (f"{span} / {op}" if span else op,
                  (gaps[k][1] - gaps[k][0]) * 1e-6)
    return out


def unnamed_share(gaps):
    """The share of the gaps' seconds that no span names."""
    total = sum(s for _, s in gaps)
    if total <= 0:
        return None
    return sum(s for n, s in gaps if not n.startswith(SPAN)) / total


def _events(prof):
    tmp = tempfile.mkdtemp(prefix="port_bench_spans_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _calls(cell, n=None, seconds=None):
    """``n`` calls, or calls until ``seconds`` have passed, then a
    synchronise: ``(seconds of each call, seconds of them all with the
    synchronise)``."""
    out, t0 = [], time.perf_counter()
    while not (len(out) == n or (seconds is not None
                                 and time.perf_counter() - t0 >= seconds)):
        t = time.perf_counter()
        cell.call()
        out.append(time.perf_counter() - t)
    cell.sync()
    return out, time.perf_counter() - t0


def _traced(cell, rec, setup, seconds):
    """Step 2 of the module docstring: calls under the profiler, recording
    on, for up to ``seconds``; the summary of their trace (the trace's
    events are dropped here)."""
    rec.reset()
    prof = T.start()
    mark = torch.profiler.record_function(T.WINDOW)
    mark.__enter__()
    calls, _ = _calls(cell, seconds=seconds)
    mark.__exit__(None, None, None)
    prof.stop()
    events = _events(prof)
    gaps = name_gaps(events)
    base = T.reduce_trace(events)
    return {"calls": len(calls),
            "numbers": step_numbers(rec.totals(), rec.counters(), setup),
            "window_s": base.get("window_s"), "busy_s": base.get("busy_s"),
            "idle_s": sum(s for _, s in gaps),
            "unnamed_idle_share": unnamed_share(gaps),
            "idle_gaps": T.top(gaps, 20),
            "idle_gaps_as_reduce_trace": T.top(base.get("idle", []), 10)}


def span_cost_us(n=200_000):
    """Host microseconds of one empty span and one ``count``, recording
    off and on, on this thread alone."""
    from stargcn_tpu_torch.utils import profiling

    def one():
        t = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("stargcn.cost"):
                pass
            profiling.count("stargcn.cost")
        return (time.perf_counter() - t) / n * 1e6

    off = one()
    with profiling.recording():
        on = one()
    return {"off_us": off, "on_us": on}


def measure(workload, seed, seconds, pairs, device="cuda", **overrides):
    from stargcn_tpu_torch.utils import profiling

    out = {"workload": workload, "seed": seed}
    with profiling.recording() as rec:
        cell = harness.Cell(workload, seed, device, **overrides)
        cell.build()
        setup = rec.totals()
        out["setup_spans_s"] = {k: v[0] for k, v in setup.items()}
        spc = cell.traffic["steps_per_call"]
        out["traced"] = _traced(cell, rec, setup,
                                min(seconds, T.TRACE_SECONDS))
        gc.collect()
        # 3. the untraced calls, recording on.
        rec.reset()
        free, free_s = _calls(cell, seconds=seconds)
        totals, counters = rec.totals(), rec.counters()
    steps = counters.get("stargcn.fit.steps", 0)
    nums = step_numbers(totals, counters, setup)
    wall = 1e3 * free_s / steps if steps else None
    main = [nums[m] for m in MAIN_STEP]
    main = sum(main) if None not in main else None
    out["untraced"] = {
        "calls": len(free), "steps": steps, "steps_per_call": spc,
        "numbers": nums, "wall_ms_per_step": wall,
        "main_spans_ms_per_step": main,
        "main_spans_share": main / wall if wall and main else None,
        "spans": {k: list(v) for k, v in totals.items()},
        "threads": {k: sorted(v) for k, v in rec.threads().items()},
        "counters": counters}

    # 4. recording off against on, one call each, in alternating order
    # (off on, on off, ...); each call's seconds end in a synchronise.
    cost = {"off": [], "on": []}
    for p in range(pairs):
        for kind in (("off", "on") if p % 2 == 0 else ("on", "off")):
            with (profiling.recording() if kind == "on"
                  else contextlib.nullcontext()):
                cost[kind].append(_calls(cell, n=1)[1])
    micro = span_cost_us()
    spans_per_step = (sum(c for _, c in totals.values()) / steps
                      if steps else 0.0)
    out["cost"] = {
        "call_s_off": cost["off"], "call_s_on": cost["on"],
        "span_us": micro, "spans_per_step": spans_per_step,
        "span_us_per_step": micro["on_us"] * spans_per_step}
    if pairs:
        off, on = (float(np.mean(cost[k])) for k in ("off", "on"))
        diffs = [b - a for a, b in zip(cost["off"], cost["on"])]
        out["cost"].update(
            mean_off_s=off, mean_on_s=on, on_over_off=on / off - 1.0,
            pair_diffs_s=diffs, median_pair_diff_over_off=float(
                np.median(diffs)) / off)
    out["device"] = (torch.cuda.get_device_name(cell.device)
                     if cell.device.type == "cuda" else "cpu")
    cell.free_program()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--pairs", type=int, default=12)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             args.pairs)), flush=True)


if __name__ == "__main__":
    main()
