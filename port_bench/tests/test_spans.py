"""``spans.py``: the per-step numbers of the program's spans, the idle gaps
named by the span that holds them, and a toy run on the CPU."""

import pytest

from port_bench import harness, spans, trace
from port_bench.tests.conftest import toy_overrides
from port_bench.tests.test_trace import EVENTS, ev


def test_step_numbers():
    totals = {"stargcn.fit.host_prep": (0.5, 10),
              "stargcn.fit.prefetch_wait": (0.1, 10),
              "stargcn.step.loss_and_grads": (2.0, 100),
              "stargcn.step.optimizer": (1.0, 100),
              "stargcn.step.to_device": (0.2, 100),
              "stargcn.fit.stats_fetch": (0.3, 10)}
    setup = {"stargcn.setup.pair_lookup": (4.0, 1),
             "stargcn.setup.bit_pack": (2.5, 1)}
    got = spans.step_numbers(totals, {"stargcn.fit.steps": 100}, setup)
    assert got == pytest.approx({
        "host_prep_ms_per_step": 5.0, "prefetch_wait_ms_per_step": 1.0,
        "loss_and_grads_host_ms_per_step": 20.0,
        "optimizer_host_ms_per_step": 10.0,
        "device_wait_ms_per_step": 5.0,
        "pair_lookup_build_s": 4.0, "bit_pack_build_s": 2.5})
    # A span that never ran, or no steps, reads None.
    got = spans.step_numbers({"stargcn.step.to_device": (0.2, 100)},
                             {"stargcn.fit.steps": 100}, {})
    assert got["device_wait_ms_per_step"] == pytest.approx(2.0)
    assert all(v is None for k, v in got.items()
               if k != "device_wait_ms_per_step")
    assert spans.step_numbers(totals, {}, setup)[
        "host_prep_ms_per_step"] is None


def test_name_gaps():
    events = EVENTS + [
        ev("user_annotation", "stargcn.step.optimizer", 380, 600),
        ev("cpu_op", "aten::div", 600, 100),
        # Another thread's span names no gap.
        ev("user_annotation", "stargcn.fit.host_prep", 100, 100, tid=2)]
    gaps = dict(spans.name_gaps(events))
    # [400, 900): the main thread is in the optimizer's span, and in
    # aten::item then aten::div; at the middle (650) in aten::div.
    assert gaps["stargcn.step.optimizer / aten::div"] == pytest.approx(
        500e-6)
    # Gaps that no span holds keep reduce_trace's names.
    assert gaps["aten::bmm"] == pytest.approx(100e-6)
    assert gaps["aten::mm (another thread)"] == pytest.approx(150e-6)
    assert spans.unnamed_share(list(gaps.items())) == pytest.approx(
        250 / 750)
    # Without the program's spans the names are reduce_trace's.
    assert sorted(spans.name_gaps(EVENTS)) == sorted(
        trace.reduce_trace(EVENTS)["idle"])
    assert spans.name_gaps([]) == []


def test_toy_run():
    toy = toy_overrides(harness.load_json("configs", "ml10m.json"))
    r = spans.measure("ml10m.train", 2**31 + 5, 0.2, 1, device="cpu",
                      **toy)
    nums = r["untraced"]["numbers"]
    assert set(nums) == set(spans.PER_STEP) | set(spans.SETUP)
    assert all(v is not None and v >= 0 for v in nums.values()), nums
    assert r["untraced"]["steps"] == 10 * r["untraced"]["calls"]
    assert r["untraced"]["threads"]["stargcn.fit.host_prep"] == [
        "prefetch"]
    assert r["traced"]["unnamed_idle_share"] is not None
    assert set(r["cost"]) >= {"mean_off_s", "mean_on_s", "span_us_per_step"}
