"""The prefetch threads of both trainers' ``fit``
(``stargcn_tpu_torch/train/prefetch.py``): the producer draws the batches
in the order a serial loop does and no more of them, so a prefetched
``fit`` trains the same parameters and leaves the samplers' streams where a
serial one does, and no producer thread outlives ``fit``, also when it
raises.  On the CPU, dropout 0."""

import threading

import numpy as np
import pytest
import torch

from _torch_slice import (build_trainers, sampled_cfgs, sampled_graphs,
                          sampled_iterator)
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
from stargcn_tpu_torch.train.prefetch import Prefetcher


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads (see ``tests/test_torch_dense_xla.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def producers():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def assert_same_parameters(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_full_graph_fit_prefetched_equals_serial():
    """``SCAN_STEPS`` 3 (chunks of 3 steps from the producer thread, which
    also runs their host pair lookup) trains the parameters that
    ``SCAN_STEPS`` 1 (serial) trains, with a validation in between."""
    over = {"TRAIN.LOG_INTERVAL": 3, "TRAIN.VALID_INTERVAL": 6}
    _, serial = build_trainers("sum", **over, **{"TRAIN.SCAN_STEPS": 1})
    _, chunked = build_trainers("sum", **over, **{"TRAIN.SCAN_STEPS": 3})
    assert not serial.s.device_sampler and not chunked.s.device_sampler
    seen = []
    real = Prefetcher.__init__

    def spy(self, make, count, depth=2):
        seen.append(count)
        real(self, make, count, depth)

    Prefetcher.__init__ = spy
    try:
        r1 = serial.fit(max_iter=12)
        assert seen == []
        r2 = chunked.fit(max_iter=12)
        assert seen == [4]                   # 4 chunks of 3 steps
    finally:
        Prefetcher.__init__ = real
    assert r1 == r2
    assert_same_parameters(serial, chunked)
    assert serial.opt.count == chunked.opt.count == 12
    assert producers() == []
    np.testing.assert_array_equal(serial.data_iter._rng.get_state()[1],
                                  chunked.data_iter._rng.get_state()[1])


def _sampled(plan_device, valid_interval):
    _, tg = sampled_graphs()
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8,
                      log_interval=4, valid_interval=valid_interval,
                      lr=1e-2, seed=3, remove_rating=True, scan_steps=2)
    return SampledTrainer(sampled_cfgs()[1],
                          sampled_iterator(DataIterator, tg), s, fanout=3,
                          device="cpu", plan_device=plan_device,
                          frontier_caps={"user": 256, "item": 256})


@pytest.mark.parametrize("plan_device,valid_interval", [
    (False, 100), (True, 4)])
def test_sampled_fit_prefetched_equals_serial(plan_device, valid_interval):
    """``fit(prefetch=True)`` trains what ``fit(prefetch=False)`` trains.
    With host plans the producer plans too, and evaluation draws from the
    same neighbour stream, so that case validates after the steps only
    (``valid_interval`` past ``max_iter``); with ``plan_device`` the
    producer plans nothing and validations fall in between."""
    from stargcn_tpu_torch.graph import kernels

    runs, streams = [], []
    for prefetch in (False, True):
        kernels.set_seed(5)
        tr = _sampled(plan_device, valid_interval)
        runs.append((tr, tr.fit(max_iter=8, prefetch=prefetch)))
        assert producers() == []
        streams.append((tr.data_iter._rng.get_state()[1],
                        kernels._fallback_rng.get_state()[1]))
    (a, ra), (b, rb) = runs
    assert ra == rb
    assert_same_parameters(a, b)
    for x, y in zip(*streams):
        np.testing.assert_array_equal(x, y)


def test_no_producer_outlives_a_fit_that_raises():
    """A step that raises, and a producer whose sampler raises: ``fit``
    raises that error, and the producer thread is gone."""
    _, tr = build_trainers("sum", **{"TRAIN.SCAN_STEPS": 2,
                                     "TRAIN.LOG_INTERVAL": 2,
                                     "TRAIN.VALID_INTERVAL": 2})

    def boom(prepped):
        raise RuntimeError("step failed")

    tr._train_prepped = boom
    with pytest.raises(RuntimeError, match="step failed"):
        tr.fit(max_iter=4)
    assert producers() == []

    st = _sampled(False, 100)

    def bad_batch(*args):
        raise ValueError("sampler failed")

    st._build_batch_safe = bad_batch
    with pytest.raises(ValueError, match="sampler failed"):
        st.fit(max_iter=4, prefetch=True)
    assert producers() == []


def test_prefetcher_runs_ahead_in_order_and_stops():
    counter = iter(range(1000))
    with Prefetcher(lambda: next(counter), 1000, depth=2) as p:
        assert [p.get() for _ in range(5)] == list(range(5))
    assert producers() == []
    assert next(counter) <= 8            # at most a queue and one in flight
    counter = iter(range(1000))
    with Prefetcher(lambda: next(counter), 3) as p:
        assert [p.get() for _ in range(3)] == [0, 1, 2]
        p._thread.join(timeout=10)
        assert not p._thread.is_alive()  # made its 3 and stopped
    assert next(counter) == 3
