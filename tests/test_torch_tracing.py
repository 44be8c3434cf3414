"""The port's spans and counters (``utils/profiling.py``): off, they are one
shared no-op; on, they add host-clock seconds and calls per name from any
thread; and inside the full-graph ``Trainer.fit`` and its set-up every
span runs where it should, on the CPU, without changing what is trained."""

import itertools
import os
import sys
import threading

import pytest
import torch

from _torch_slice import build_port_trainer
from stargcn_tpu_torch.utils import profiling

FIT_SPANS = ("stargcn.fit.host_prep", "stargcn.step.to_device",
             "stargcn.step.loss_and_grads", "stargcn.step.optimizer",
             "stargcn.fit.stats_fetch", "stargcn.fit.evaluate",
             "stargcn.setup.pair_lookup", "stargcn.setup.bit_pack")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads (see ``tests/test_torch_dense_xla.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def fake_clock(monkeypatch, step=0.5):
    clock = itertools.count(0.0, step)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))


def test_off_is_one_shared_noop(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    monkeypatch.setattr(profiling.time, "perf_counter", no_clock)
    a, b = profiling.annotate("stargcn.a"), profiling.annotate("stargcn.b")
    assert a is b
    with a:
        with b:
            profiling.count("stargcn.n", 3)
    with profiling.recording() as rec:
        pass
    assert rec.totals() == {} and rec.counters() == {}


def test_nested_spans_on_a_fake_clock(monkeypatch):
    fake_clock(monkeypatch)
    with profiling.recording() as rec:
        with profiling.annotate("stargcn.outer"):       # 0.0 .. 2.5
            for _ in range(2):
                with profiling.annotate("stargcn.inner"):  # 0.5 each
                    pass
        profiling.count("stargcn.steps", 2)
        profiling.count("stargcn.steps")
    assert rec.totals() == {"stargcn.outer": (2.5, 1),
                            "stargcn.inner": (1.0, 2)}
    assert rec.counters() == {"stargcn.steps": 3}
    assert rec.threads()["stargcn.inner"] == {
        threading.current_thread().name}
    # Off again after the block.
    assert profiling.annotate("stargcn.outer") is profiling._NOOP


def test_reset_and_an_inner_recording(monkeypatch):
    fake_clock(monkeypatch)
    with profiling.recording() as rec:
        with profiling.annotate("stargcn.a"):
            profiling.count("stargcn.n")
        rec.reset()
        assert rec.totals() == {} and rec.counters() == {}
        with profiling.recording() as inner:
            assert inner is rec
            with profiling.annotate("stargcn.b"):
                pass
        # The inner block leaves the outer one recording.
        with profiling.annotate("stargcn.b"):
            pass
    assert rec.totals() == {"stargcn.b": (1.0, 2)}
    assert rec.threads() == {"stargcn.b": {threading.current_thread().name}}


def test_a_raising_span_records_and_raises(monkeypatch):
    fake_clock(monkeypatch, 0.25)
    with profiling.recording() as rec:
        with pytest.raises(ValueError, match="boom"):
            with profiling.annotate("stargcn.fails"):
                raise ValueError("boom")
    assert rec.totals() == {"stargcn.fails": (0.25, 1)}


def test_spans_of_many_threads_lose_no_call():
    """More threads than cores, switching every microsecond."""
    n_threads, n_spans = (os.cpu_count() or 1) + 2, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work():
                for _ in range(n_spans):
                    with profiling.annotate("stargcn.worker"):
                        profiling.count("stargcn.worker_steps")

            threads = [threading.Thread(target=work, name=f"worker{i}")
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            with profiling.annotate("stargcn.main"):
                for t in threads:
                    t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    totals = rec.totals()
    assert totals["stargcn.worker"][1] == n_threads * n_spans
    assert totals["stargcn.main"][1] == 1
    assert rec.counters() == {"stargcn.worker_steps": n_threads * n_spans}
    assert rec.threads()["stargcn.worker"] == {
        f"worker{i}" for i in range(n_threads)}


def test_spans_enter_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.annotate("stargcn.traced"):
                torch.ones(8) + 1
        with profiling.annotate("stargcn.untraced"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert "stargcn.traced" in names
    assert set(rec.totals()) == {"stargcn.traced", "stargcn.untraced"}


OVER = {"TRAIN.LOG_INTERVAL": 2, "TRAIN.VALID_INTERVAL": 4,
        "GCN.DROPOUT": 0.2}


def recorded_fit(scan_steps, max_iter=8):
    with profiling.recording() as rec:
        tr = build_port_trainer(**OVER, **{"TRAIN.SCAN_STEPS": scan_steps})
        tr.fit(max_iter=max_iter)
    return tr, rec


@pytest.mark.parametrize("scan_steps", [2, 1], ids=["prefetched", "serial"])
def test_fit_runs_every_span(scan_steps):
    tr, rec = recorded_fit(scan_steps)
    totals, threads = rec.totals(), rec.threads()
    for name in FIT_SPANS:
        assert totals.get(name, (0.0, 0))[1] > 0, name
    steps = rec.counters()["stargcn.fit.steps"]
    assert steps == 8 == tr.opt.count
    assert totals["stargcn.step.optimizer"][1] == steps
    assert totals["stargcn.step.loss_and_grads"][1] == steps
    assert totals["stargcn.fit.stats_fetch"][1] == 8 // 2
    main = threading.current_thread().name
    assert threads["stargcn.step.optimizer"] == {main}
    if scan_steps > 1:
        assert totals["stargcn.fit.prefetch_wait"][1] == 8 // scan_steps
        assert totals["stargcn.fit.host_prep"][1] == 8 // scan_steps
        assert threads["stargcn.fit.host_prep"] == {"prefetch"}
    else:
        assert "stargcn.fit.prefetch_wait" not in totals
        # The draws in the loop and the pair lookup in train_iteration.
        assert totals["stargcn.fit.host_prep"][1] == 2 * steps
        assert threads["stargcn.fit.host_prep"] == {main}


def test_recording_changes_nothing_trained():
    recorded, _ = recorded_fit(2)
    plain = build_port_trainer(**OVER, **{"TRAIN.SCAN_STEPS": 2})
    plain.fit(max_iter=8)
    a, b = recorded.model.state_dict(), plain.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in recorded.opt.mu:
        assert torch.equal(recorded.opt.mu[k], plain.opt.mu[k]), k
