"""Profiling and the program's spans and counters.

``trace`` records a ``torch.profiler`` trace (host operators, and on a CUDA
device the card's kernels, copies and memsets through CUPTI) and writes it
as Chrome-trace JSON, which ``chrome://tracing`` or Perfetto open.

``annotate(name)`` marks a span of the program and ``count(name, n)`` adds
to a counter; names take the form ``stargcn.<area>.<what>``.  Both are off
by default: ``annotate`` then checks one module flag and returns one shared
no-op context manager, and ``count`` returns after the same check.  Inside
``with recording() as rec:`` (and inside ``trace``) they are on:

* each span adds its host-clock seconds (``time.perf_counter``) and one
  call to its name's total, from any thread (the prefetch thread records
  too), also when its body raises;
* where a ``torch.profiler`` session is active on the span's thread, the
  span also opens ``torch.profiler.record_function(name)``, so that it
  shows in the Chrome trace on the clock of the card's kernels and copies;
* ``rec.totals()`` gives ``{name: (seconds, calls)}``, ``rec.counters()``
  ``{name: n}``, ``rec.threads()`` the names of the threads each span ran
  on, and ``rec.reset()`` empties all three.

Recording changes nothing that is computed.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_NOOP = contextlib.nullcontext()
# The open recording, or None: the one flag ``annotate`` and ``count`` read.
_recording = None


class Recording:
    """Per-name span totals, counters and threads; safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._totals, self._counters, self._threads = {}, {}, {}

    def add(self, name: str, seconds: float):
        thread = threading.current_thread().name
        with self._lock:
            s, c = self._totals.get(name, (0.0, 0))
            self._totals[name] = (s + seconds, c + 1)
            self._threads.setdefault(name, set()).add(thread)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def threads(self) -> dict:
        with self._lock:
            return {k: frozenset(v) for k, v in self._threads.items()}


class _Span:
    __slots__ = ("rec", "name", "t0", "rf")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.add(self.name, dt)
        return False


def annotate(name: str):
    """A span of the program named ``name`` (see the module docstring)."""
    rec = _recording
    if rec is None:
        return _NOOP
    return _Span(rec, name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while recording."""
    rec = _recording
    if rec is None:
        return
    rec.count(name, n)


@contextlib.contextmanager
def recording():
    """Turn the spans and counters on for the enclosed code; yields the
    ``Recording``.  Inside an open recording it yields that one."""
    global _recording
    outer = _recording
    rec = outer if outer is not None else Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code into ``logdir/trace_<pid>_<ns>.json``:
    CPU activity always, CUDA activity too where a card is present, and
    the program's spans (recording is on inside)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    with recording():
        prof.start()
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
