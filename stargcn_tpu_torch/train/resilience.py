"""Failure detection and elastic recovery for long training runs.

The port of ``stargcn_tpu/train/resilience.py``.  A training run fails in a
few characteristic ways, each with its own detector:

* **Numerical divergence** (NaN/Inf loss): detected in ``Trainer.fit``
  every log interval (restore the best checkpoint, halve the LR, give up
  after ``max_nan_recoveries``).
* **Device or runtime failure** (a CUDA error, an out-of-memory, a lost
  card): surfaces as an exception from a step.  ``ElasticStep`` catches it,
  runs ``device_health_check`` to decide whether the device still answers,
  restores the last crash-safe checkpoint and resumes, at most
  ``max_restarts`` times.
* **Silent hangs** (a deadlocked host thread, a kernel that never ends):
  no exception ever arrives.  ``HeartbeatMonitor`` watches a step-counter
  heartbeat from a daemon thread and, past ``hang_timeout_s``, writes every
  Python thread's stack to the log and a crash file.  It only diagnoses:
  the reaction to a stall is a report and a callback, never a kill.

A multi-process job cannot rejoin one lost process: every process exits
non-zero, a supervisor relaunches the world, and ``--resume`` restores the
``ckpt_last`` that ``Trainer.fit`` writes.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import sys
import threading
import time
import traceback

import torch


def device_health_check(timeout_s: float = 60.0,
                        device="cuda") -> tuple[bool, str]:
    """Run a tiny known-answer computation (an 8x8 product) on ``device``
    and wait for it (``torch.cuda.synchronize`` on a card).

    Returns ``(healthy, detail)``.  A wedged runtime either raises or
    returns garbage; both are reported, never raised: callers decide
    policy.
    """
    try:
        dev = torch.device(device)
        t0 = time.time()
        x = torch.full((8, 8), 2.0, device=dev)
        out = (x @ x).sum()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        val = float(out)
        dt = time.time() - t0
        if abs(val - 8 * 8 * 8 * 4.0) > 1e-3:
            return False, f"wrong probe result {val} (in {dt:.1f}s)"
        if dt > timeout_s:
            return False, f"probe took {dt:.1f}s (> {timeout_s}s)"
        return True, f"ok in {dt:.2f}s"
    except Exception as e:  # noqa: BLE001 — any failure = unhealthy
        return False, f"{type(e).__name__}: {e}"


def dump_all_stacks() -> str:
    """Every live Python thread's stack, as a string (hang forensics),
    built from ``sys._current_frames`` in memory."""
    names = {t.ident: t.name for t in threading.enumerate()}
    buf = io.StringIO()
    for ident, frame in sys._current_frames().items():
        buf.write(f"Thread {names.get(ident, '?')} ({ident}):\n")
        buf.write("".join(traceback.format_stack(frame)))
        buf.write("\n")
    return buf.getvalue()


class HeartbeatMonitor:
    """Detects training-loop stalls from a daemon thread.

    The training loop calls ``beat()`` once per step (or log window).  If
    no beat arrives for ``hang_timeout_s``, the monitor logs a diagnosis
    (all thread stacks plus a health probe of ``device``), appends it to
    ``crash_file`` and calls ``on_hang``.  It keeps watching afterwards
    (one diagnosis per stall episode).  The probe runs in a thread of its
    own and is given ``probe_timeout_s``: on a card stuck in a kernel its
    synchronise never returns, and the report must still be written.
    """

    probe_timeout_s = 60.0

    def __init__(self, hang_timeout_s: float = 600.0, on_hang=None,
                 log=logging.warning, poll_s: float = 5.0,
                 crash_file: str | None = None, device="cuda"):
        self.hang_timeout_s = float(hang_timeout_s)
        self.on_hang = on_hang
        self.log = log
        self.poll_s = poll_s
        self.crash_file = crash_file
        self.device = device
        self._last_beat = time.monotonic()
        self._beats = 0
        self._stalled = False
        self.stall_episodes = 0
        self._stop = threading.Event()
        self._thread = None

    def beat(self):
        self._last_beat = time.monotonic()
        self._beats += 1
        self._stalled = False

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stargcn-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self):
        while not self._stop.wait(self.poll_s):
            silent = time.monotonic() - self._last_beat
            if silent < self.hang_timeout_s or self._stalled:
                continue
            self._stalled = True
            self.stall_episodes += 1
            report = self._diagnose(silent)
            self.log(report)
            if self.crash_file:
                try:
                    with open(self.crash_file, "a") as f:
                        f.write(report + "\n")
                except OSError:
                    pass
            if self.on_hang is not None:
                try:
                    self.on_hang(report)
                except Exception:  # noqa: BLE001 — monitor must survive
                    self.log("on_hang callback raised:\n"
                             + traceback.format_exc())

    def _probe(self):
        out = []
        probe = threading.Thread(
            target=lambda: out.append(device_health_check(
                self.probe_timeout_s, device=self.device)),
            daemon=True, name="stargcn-health-probe")
        probe.start()
        probe.join(self.probe_timeout_s)
        return out[0] if out else (
            False, f"no answer within {self.probe_timeout_s:.0f}s")

    def _diagnose(self, silent_s: float) -> str:
        healthy, detail = self._probe()
        verdict = ("device answers (host-side stall — see stacks)"
                   if healthy else f"device probe FAILED: {detail}")
        return (f"[heartbeat] no step progress for {silent_s:.0f}s "
                f"(beats={self._beats}); {verdict}\n{dump_all_stacks()}")


@dataclasses.dataclass
class ElasticPolicy:
    max_restarts: int = 2
    max_nan_recoveries: int = 3
    backoff_s: float = 5.0


class ElasticStep:
    """Bounded-retry wrapper around a step callable.

    ``run(fn, *args)`` executes ``fn``; on an exception it probes the
    health of ``device``, backs off, and retries after ``on_restore``
    (reload a checkpoint): at most ``policy.max_restarts`` times over the
    wrapper's lifetime, then it re-raises.  An unhealthy device is probed
    once more after the backoff; if it still fails, the exception is
    re-raised (the supervisor's signal).
    """

    def __init__(self, policy: ElasticPolicy = None, on_restore=None,
                 log=logging.warning, device="cuda"):
        self.policy = policy or ElasticPolicy()
        self.on_restore = on_restore
        self.log = log
        self.device = device
        self.restarts = 0

    def run(self, fn, *args, **kwargs):
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — policy decides
                if self.restarts >= self.policy.max_restarts:
                    self.log(f"[elastic] giving up after "
                             f"{self.restarts} restarts")
                    raise
                self.restarts += 1
                healthy, detail = device_health_check(device=self.device)
                self.log(f"[elastic] step failed ({type(e).__name__}: "
                         f"{e}); device health: {detail}; "
                         f"restart {self.restarts}/"
                         f"{self.policy.max_restarts}")
                time.sleep(self.policy.backoff_s)
                if not healthy:
                    healthy, detail = device_health_check(
                        device=self.device)
                    if not healthy:
                        self.log("[elastic] device still unhealthy "
                                 f"({detail}); escalating")
                        raise
                if self.on_restore is not None:
                    self.on_restore()
