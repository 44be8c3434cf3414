"""The port's failure detection and recovery (``train/resilience.py``), the
parameter table (``utils/model_info.py``) and ``load_latest_cfg``, against
the JAX package's, on the CPU.

* ``ElasticStep`` on the same script of step failures and health probes
  (both packages' ``device_health_check`` replaced by one script) makes the
  JAX class's decisions: the same log lines, restarts, restores and
  outcome;
* ``HeartbeatMonitor`` fires ``on_hang`` with every thread's stack, writes
  the crash file and keeps watching;
* ``Trainer.fit`` whose step raises once restores ``ckpt_last`` and ends
  with the parameters of an uninterrupted run of the same batches from
  that checkpoint; with ``hang_timeout_s = 0`` it starts no thread;
* ``net0.txt`` and ``model_info`` equal the JAX package's text.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from _torch_slice import build_port_trainer, build_trainers
from stargcn_tpu.train import resilience as jres
from stargcn_tpu.utils import model_info as jinfo
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.train import resilience as tres
from stargcn_tpu_torch.utils import (default_cfg, load_latest_cfg,
                                     save_cfg_dir)
from stargcn_tpu_torch.utils import model_info as tinfo


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


class _Script:
    """A step that raises for its first ``fails`` calls, and a health probe
    that answers from a list (then healthy)."""

    def __init__(self, fails, health):
        self.fails, self.health = fails, list(health)
        self.calls = 0

    def step(self, x):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError(f"step {self.calls} failed")
        return x * 2

    def probe(self, *args, **kwargs):
        ok = self.health.pop(0) if self.health else True
        return ok, "ok" if ok else "probe failed"


def _run_script(module, monkeypatch, fails, health, max_restarts, runs=1):
    """Events of ``module.ElasticStep`` driven by one script: the log lines,
    restores, restarts and each run's result or exception."""
    script = _Script(fails, health)
    monkeypatch.setattr(module, "device_health_check", script.probe)
    events = []
    elastic = module.ElasticStep(
        module.ElasticPolicy(max_restarts=max_restarts),
        on_restore=lambda: events.append("restore"), log=events.append)
    for _ in range(runs):
        try:
            events.append(("ok", elastic.run(script.step, 3)))
        except RuntimeError as e:
            events.append(("raised", str(e)))
    events.append(("restarts", elastic.restarts, "calls", script.calls))
    return events


@pytest.mark.parametrize("fails,health,max_restarts,runs", [
    (1, [], 2, 1),                 # one failure, restored, retried
    (3, [], 2, 1),                 # gives up after max_restarts
    (1, [False, False], 2, 1),     # the device stays unhealthy: escalate
    (1, [False, True], 2, 1),      # unhealthy, then answers: restore
    (3, [], 2, 2),                 # restarts bounded over the lifetime
    (0, [], 0, 1),                 # no failure, no restart allowed
])
def test_elastic_step_decides_as_jax(monkeypatch, fails, health,
                                     max_restarts, runs):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    want = _run_script(jres, monkeypatch, fails, health, max_restarts, runs)
    got = _run_script(tres, monkeypatch, fails, health, max_restarts, runs)
    assert got == want


def _wait_for(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.02)
    return cond()


def test_heartbeat_monitor_reports_and_keeps_watching(tmp_path):
    reports = []
    crash = tmp_path / "crash.log"
    mon = tres.HeartbeatMonitor(0.3, on_hang=reports.append,
                                log=lambda *_: None, poll_s=0.05,
                                crash_file=str(crash), device="cpu")
    with mon:
        assert _wait_for(lambda: len(reports) == 1)
        mon.beat()
        assert _wait_for(lambda: len(reports) == 2)
        thread = mon._thread
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert mon.stall_episodes == 2
    for report in reports:
        assert "no step progress" in report
        assert "device answers" in report
        assert "Thread MainThread" in report
        assert "test_heartbeat_monitor_reports_and_keeps_watching" in report
    assert crash.read_text().count("[heartbeat]") == 2


def test_heartbeat_monitor_survives_a_failing_callback():
    logs = []

    def bad(report):
        raise ValueError("callback")

    mon = tres.HeartbeatMonitor(0.1, on_hang=bad, log=logs.append,
                                poll_s=0.05, device="cpu").start()
    try:
        assert _wait_for(lambda: any("on_hang callback raised" in x
                                     for x in logs))
    finally:
        mon.stop()
    assert not mon._thread.is_alive()


def test_device_health_check():
    healthy, detail = tres.device_health_check(device="cpu")
    assert healthy and detail.startswith("ok in")
    if not torch.cuda.is_available():
        healthy, detail = tres.device_health_check(device="cuda")
        assert not healthy and detail     # reported, never raised
    healthy, detail = tres.device_health_check(timeout_s=-1.0,
                                               device="cpu")
    assert not healthy and "took" in detail


def _fit_cfg():
    return {"TRAIN.SCAN_STEPS": 1, "TRAIN.LOG_INTERVAL": 5,
            "TRAIN.VALID_INTERVAL": 5}


def test_fit_restores_ckpt_last_after_a_failed_step(tmp_path, monkeypatch):
    """Step 7 of a 12-step ``fit`` raises once: ``fit`` restores
    ``ckpt_last`` (written by the validation at step 5), retries the batch
    and goes on.  Its parameters at the end equal those of a trainer that
    restores the same checkpoint and takes the same batches; its
    ``net0.txt`` equals the JAX package's table of the starting
    parameters; the heartbeat thread has stopped."""
    jtrainer, ttrainer = build_trainers("sum", save_dir=str(tmp_path),
                                        **_fit_cfg())
    ttrainer.s.hang_timeout_s = 60.0
    save = tmp_path / "torch"
    saved = str(tmp_path / "ckpt_at_failure.pt")
    real, calls, lines = ttrainer.train_iteration, [], []

    def flaky(rb, cb):
        calls.append((rb, cb))
        if len(calls) == 7:
            shutil.copy(save / "ckpt_last_0.pt", saved)
            raise RuntimeError("injected step failure")
        return real(rb, cb)

    ttrainer.train_iteration = flaky
    monkeypatch.setattr(time, "sleep", lambda s: None)    # the backoff
    try:
        ttrainer.fit(max_iter=12, log=lines.append)
    finally:
        del ttrainer.train_iteration
    assert len(calls) == 13 and ttrainer.elastic.restarts == 1
    assert calls[6][0] is calls[7][0]        # the failed batch, retried
    assert any("[elastic] step failed (RuntimeError: injected" in x
               for x in lines)
    assert not any(t.name == "stargcn-heartbeat" and t.is_alive()
                   for t in threading.enumerate())
    assert (save / "net0.txt").read_text() == jinfo.model_info(
        jtrainer.params, str(tmp_path / "jax_net.txt")) + "\n"

    twin = type(ttrainer)(ttrainer.model_cfg, ttrainer.data_iter,
                          ttrainer.s, device="cpu")
    twin.restore_checkpoint(saved)
    assert twin.opt.count == 5
    for rb, cb in calls[7:]:
        twin.train_iteration(rb, cb)
    got, want = ttrainer.model.state_dict(), twin.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert ttrainer.opt.count == twin.opt.count == 11


def test_fit_without_hang_timeout_starts_no_thread():
    ttrainer = build_port_trainer("sum", **_fit_cfg())
    ttrainer.s.hang_timeout_s = 0.0
    seen = []
    real = ttrainer.train_iteration

    def watching(rb, cb):
        seen.append(sorted(t.name for t in threading.enumerate()))
        return real(rb, cb)

    ttrainer.train_iteration = watching
    before = threading.active_count()
    try:
        ttrainer.fit(max_iter=2, log=lambda *_: None)
    finally:
        del ttrainer.train_iteration
    assert len(seen) == 2
    assert not any("stargcn-heartbeat" in names for names in seen)
    assert threading.active_count() == before
    assert ttrainer.elastic.restarts == 0


def test_model_info_matches_jax(tmp_path):
    jtrainer, ttrainer = build_trainers("stack")
    state = convert.params_from_flax(jtrainer.params)
    path = str(tmp_path / "sub" / "net3.txt")
    text = tinfo.model_info(state, path)
    assert text == jinfo.model_info(jtrainer.params,
                                    str(tmp_path / "jax.txt"))
    assert open(path).read() == text + "\n"
    assert tinfo.total_param_num(state) == jinfo.total_param_num(
        jtrainer.params) == sum(p.numel() for p in
                                ttrainer.model.parameters())
    assert text.splitlines()[0].startswith("embed_item/embedding: shape=")
    # Without a path the table is returned and nothing is written; the
    # JAX package's version opens ``None`` there (ROADMAP Queue 3).
    assert tinfo.model_info(state) == text
    with pytest.raises(TypeError):
        jinfo.model_info(jtrainer.params)


def test_parse_devices():
    assert tinfo.parse_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert tinfo.parse_devices("all") == [torch.device("cpu")]
        with pytest.raises(RuntimeError, match="CUDA"):
            tinfo.parse_devices("cuda:0")


def test_load_latest_cfg(tmp_path):
    for seed in (5, 6, 7):
        cfg = default_cfg()
        cfg.SEED = seed
        save_cfg_dir(str(tmp_path), cfg)
    os.rename(tmp_path / "cfg1.yml", tmp_path / "cfg10.yml")
    (tmp_path / "cfg_notes.yml").write_text("SEED: 99\n")
    assert load_latest_cfg(str(tmp_path)).SEED == 6
    merged = load_latest_cfg(str(tmp_path), default_cfg())
    assert merged.SEED == 6 and "TRAIN" in merged
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no cfg"):
        load_latest_cfg(str(empty))


def test_heartbeat_reports_a_probe_that_never_returns(monkeypatch):
    """A card stuck in a kernel never answers the probe's synchronise: the
    report is written all the same, after ``probe_timeout_s``."""
    gate = threading.Event()

    def stuck(*args, **kwargs):
        gate.wait(5.0)
        return True, "late"

    monkeypatch.setattr(tres, "device_health_check", stuck)
    reports = []
    mon = tres.HeartbeatMonitor(0.1, on_hang=reports.append,
                                log=lambda *_: None, poll_s=0.05,
                                device="cpu")
    mon.probe_timeout_s = 0.2
    with mon:
        assert _wait_for(lambda: len(reports) == 1)
    gate.set()
    assert "device probe FAILED: no answer within 0s" in reports[0]
    assert "Thread MainThread" in reports[0]
