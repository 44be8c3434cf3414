"""The traced run's reading of the device: a ``torch.profiler`` trace of the
window's first calls (host operators, and the card's kernels, copies and
memsets), written as Chrome-trace JSON under ``TMPDIR`` and reduced to what
the per-layer metrics read:

* ``window_s``: the length of the window's own annotation;
* ``busy_s``: the union of device activity inside it;
* ``kernels``: ``[(name, seconds)]`` of every device activity in it;
* ``idle``: the gaps between device activity, each named by the innermost
  host event at its middle, on the main thread or else on another.

Input shapes are not recorded: they triple the cost of stopping, writing
and reading the trace.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import torch

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


# The traced part of a window: its first calls, up to this many seconds.
# Reading the trace costs several times its length, so a whole window's
# would bring a traced run near its time limit; and the profiler slows
# the host, so the metrics that take a rate read the untraced rest.
TRACE_SECONDS = 12.0


def start():
    """A started ``torch.profiler`` session: host operators, and the card's
    activity where there is a card.  Mark the traced window inside it with
    ``torch.profiler.record_function(WINDOW)`` and stop it before
    ``read``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def read(prof) -> dict:
    """``reduce_trace`` of a stopped session's trace, written under
    ``TMPDIR`` and removed."""
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return reduce_trace(events)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _innermost(ops, times):
    """For each time in ``times`` (sorted), the innermost of ``ops``
    (``(start, end, payload)``, any order) that holds it, or None."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_trace(events) -> dict:
    """See the module docstring.  Times in the result are seconds."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev, host = [], []
    for e in events:
        cat = e.get("cat")
        if "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            if ts + dur > w0 and ts < w1:
                dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    busy = _union((max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    kernels = [(e.get("name", "?"), float(e["dur"]) * 1e-6) for e in dev]

    # Idle gaps, named by the main thread's innermost host event at their
    # middle, else by another thread's (the autograd engine runs the
    # backward on its own thread).
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    by_tid = {}
    for e in host:
        if e.get("name") != WINDOW:
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e.get("name")))
    mids = sorted(((s + e) / 2, k) for k, (s, e) in enumerate(gaps))
    times = [m for m, _ in mids]
    names = _innermost(by_tid.pop(main_tid, []), times)
    for ops in by_tid.values():
        other = _innermost(ops, times)
        names = [n or (o and f"{o} (another thread)")
                 for n, o in zip(names, other)]
    idle = [None] * len(gaps)
    for (_, k), name in zip(mids, names):
        idle[k] = (name or "host (between operators)",
                   (gaps[k][1] - gaps[k][0]) * 1e-6)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernels": kernels, "idle": idle}


def top(pairs, n=10):
    """The ``n`` largest totals of ``(name, seconds)`` pairs by name."""
    tot = {}
    for name, s in pairs:
        tot[name] = tot.get(name, 0.0) + s
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], s] for name, s in best]

