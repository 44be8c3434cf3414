"""The comparison that decides ``correct``: a sound run passes; the
control (the reference with TF32 on, which exists on a card only) fails;
a run with the timed path broken underneath fails, once for each fault a
training cell can have on one card; and a place where the check reads the
program that is gone fails by name."""

import pytest

from port_bench import check, control, harness
from port_bench.tests.conftest import toy_overrides

B = harness.manifest()
CONFIGS = sorted({w["config"] for w in B["workloads"]})


def cell_of(config):
    return next(w["name"] for w in B["workloads"]
                if w["config"] == config)


def readings(config, kinds, device="cpu", seed=2**31 + 21):
    toy = toy_overrides(harness.load_json("configs", f"{config}.json"))
    return control.readings(cell_of(config), seed, kinds, device=device,
                            **toy)


def fails(nums, limits):
    return [k for k, v in nums.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_passes_and_faults_fail(config):
    limits = check.limits_for(config)
    r = readings(config, {"program", "fault:unchanged", "fault:half_batch"})
    assert not fails(r["program"], limits), r["program"]
    assert fails(r["fault:unchanged"], limits)
    assert fails(r["fault:half_batch"], limits)


@pytest.mark.parametrize("config", CONFIGS)
def test_harness_run_with_a_broken_step_is_not_correct(config, monkeypatch):
    # The whole run, past its look for a card, with the optimiser step
    # broken underneath: ``correct`` comes out false.
    from stargcn_tpu_torch.train import loop

    monkeypatch.setattr(loop.ClipAdam, "step",
                        lambda self, grads, keep=None: torch_norm(grads))
    toy = toy_overrides(harness.load_json("configs", f"{config}.json"))
    r = harness.run(cell_of(config), 2**31 + 23, 0.2, False, device="cpu",
                    **toy)
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def torch_norm(grads):
    import torch

    return torch.sqrt(sum((g ** 2).sum() for g in grads.values()))


def test_missing_hook_is_named(monkeypatch):
    # An optimiser that keeps its first moment under another name between
    # steps.
    from stargcn_tpu_torch.train import loop

    orig = loop.ClipAdam.step

    def step(self, grads, keep=None):
        if "first_moment" in self.__dict__:
            self.mu = self.__dict__.pop("first_moment")
        out = orig(self, grads, keep)
        self.first_moment = self.__dict__.pop("mu")
        return out

    monkeypatch.setattr(loop.ClipAdam, "step", step)
    with pytest.raises(check.HookMissing, match="opt.mu"):
        readings(CONFIGS[0], {"program"})


@pytest.mark.card
@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_on_the_card(config, card):
    # At the cell's own size: the program passes and TF32 fails.
    limits = check.limits_for(config)
    for seed in (2**31 + 31, 2**31 + 37, 2**31 + 41):
        r = control.readings(cell_of(config), seed, {"program", "control"},
                             device="cuda")
        assert not fails(r["program"], limits), r["program"]
        assert fails(r["control"], limits), r["control"]


def test_dense_reference_rounds_where_the_program_does():
    # The ``dense`` path (``configs/ml1m.json``, no cell of its own yet) at
    # toy size: the reference that rounds the adjacency's operand where
    # the program states it does reads round-off; a float32 one reads the
    # rounding.
    import dataclasses

    bench = dict(B, workloads=[{"name": "ml1m.train", "config": "ml1m",
                                "traffic": "train", "chips": 1}])
    toy = toy_overrides(harness.load_json("configs", "ml1m.json"))
    cell = harness.Cell("ml1m.train", 2**31 + 29, "cpu",
                        toy["graph_override"], toy["cfg_override"],
                        bench=bench,
                        traffic_override=toy["traffic_override"])
    cell.build(max_iter=10)
    prog = cell.program_side()
    cell.free_program()
    near = check.compare(prog, cell.reference_side())
    cell.spec = dataclasses.replace(cell.spec, operand="float32")
    far = check.compare(prog, cell.reference_side())
    assert near["loss_gap"] < 1e-5 and near["grad_gap"] < 1e-3, near
    assert far["grad_gap"] > 3 * near["grad_gap"], (near, far)
