"""Profiling and step timing.

``trace`` records a ``torch.profiler`` trace (host operators, and on a CUDA
device the card's kernels, copies and memsets through CUPTI) and writes it
as Chrome-trace JSON, which ``chrome://tracing`` or Perfetto open;
``annotate`` names a span in it; ``StepTimer`` keeps a rolling step time
with edges/s and examples/s.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code into ``logdir/trace_<pid>_<ns>.json``:
    CPU activity always, CUDA activity too where a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace span for host-side phases."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step timing with throughput accounting.

    ``edges_per_step`` / ``examples_per_step`` are fixed per config; call
    ``tick()`` once per optimisation step after the result is ready: on the
    card, after ``torch.cuda.synchronize()``, since launches return before
    the work is done.
    """

    def __init__(self, edges_per_step: int = 0, examples_per_step: int = 0,
                 window: int = 50):
        self.edges_per_step = edges_per_step
        self.examples_per_step = examples_per_step
        self.window = window
        self._times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self):
        return (sum(self._times) / len(self._times)) if self._times else 0.0

    def stats(self):
        s = self.mean_step_s
        return {
            "step_ms": s * 1e3,
            "edges_per_s": (self.edges_per_step / s) if s else 0.0,
            "examples_per_s": (self.examples_per_step / s) if s else 0.0,
        }
