"""The trace's reduction and the per-layer readers on a hand-made trace."""

from types import SimpleNamespace

import pytest

from port_bench import flops, trace
from port_bench.metrics import (bit_walks_roofline,
                                dense_bmm_roofline, device_idle_pct,
                                device_ms_per_step)


def ev(cat, name, ts, dur, tid=1, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


EVENTS = [
    ev("user_annotation", trace.WINDOW, 100, 1000),
    ev("cpu_op", "aten::bmm", 110, 50),
    ev("kernel", "cutlass_80_tensorop_s16816gemm_bf16_nt", 200, 100, tid=9),
    ev("cpu_op", "aten::item", 400, 300),
    ev("cpu_op", "aten::mm", 950, 150, tid=2),
    ev("kernel", "void walk_kernel<1, 8, false>(Walk)", 250, 150, tid=9),
    ev("kernel", "table_kernel", 900, 50, tid=9),
    ev("kernel", "outside", 2000, 50, tid=9),
]


def test_reduce_trace():
    r = trace.reduce_trace(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    # Device busy [200, 400) and [900, 950).
    assert r["busy_s"] == pytest.approx(250e-6)
    assert len(r["kernels"]) == 3                         # one lies outside
    idle = dict((n, s) for n, s in r["idle"])
    assert idle["aten::item"] == pytest.approx(500e-6)     # [400, 900)
    # [100, 200): the main thread is in aten::bmm; [950, 1100): only
    # another thread is in an operator at the gap's middle.
    assert idle["aten::bmm"] == pytest.approx(100e-6)
    assert idle["aten::mm (another thread)"] == pytest.approx(150e-6)
    assert sum(s for _, s in r["idle"]) == pytest.approx(750e-6)


def test_readers_on_the_trace():
    r = trace.reduce_trace(EVENTS)
    cfg = SimpleNamespace(num_links=2, num_users=16, num_items=8,
                          embed_units=2, agg_units=(5,))
    ctx = SimpleNamespace(trace=r, model_cfg=cfg, edges={"train": 0},
                          steps=5, free_steps=10, free_s=2e-3)
    # 50 us of device a step, 10 untraced steps in 2 ms: idle 75%.
    assert device_idle_pct.read(ctx) == pytest.approx(75.0)
    assert device_ms_per_step.read(ctx) == pytest.approx(250e-3 / 5)
    bmm = flops.bmm_least_s(2, 16, 8, 5) + flops.bmm_least_s(2, 8, 16, 5)
    assert dense_bmm_roofline.read(ctx) == pytest.approx(
        100 * bmm / 2 / 100e-6)
    both = (flops.bit_walk_least_s(2, 16, 8, 3, 0)
            + flops.bit_walk_least_s(2, 8, 16, 3, 0))
    assert bit_walks_roofline.read(ctx) == pytest.approx(
        100 * both / 2 / 200e-6)


def test_readers_find_nothing():
    ctx = SimpleNamespace(trace={}, model_cfg=None, edges={}, steps=5,
                          free_steps=10, free_s=1.0)
    assert device_idle_pct.read(ctx) is None
    assert device_ms_per_step.read(ctx) is None
    assert dense_bmm_roofline.read(ctx) is None
    assert bit_walks_roofline.read(ctx) is None
