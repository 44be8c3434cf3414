"""The port's FLOP count (``utils/flops.py``), profiler (``utils/profiling.py``,
the train CLI's ``--profile``) and reference step estimate
(``utils/refestimate.py``) on the CPU, against the JAX package where it
has the same function: ``stargcn_step_flops`` for the 15 shipped configs,
each built by its own package's ``build_model_config``; ``op_count`` and
``estimate`` for the three datasets fed the same host milliseconds (equal
dicts)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu.utils import flops as jflops
from stargcn_tpu.utils import refestimate as jref
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.train import __main__ as train_cli
from stargcn_tpu_torch.utils import cfg_from_file, save_cfg_file
from stargcn_tpu_torch.utils import flops, profiling, refestimate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))
SHAPES = {"ml-100k": (943, 1682, 5), "ml-1m": (6040, 3706, 5),
          "ml-10m": (69_878, 10_677, 10)}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def test_fifteen_configs_shipped():
    assert len(CONFIGS) == 15


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_step_flops_match_jax(path):
    tcfg, jcfg = cfg_from_file(path), j_cfg_from_file(path)
    dims = SHAPES[tcfg.DATASET.NAME]
    ratings = {"ml-100k": 100_000, "ml-1m": 1_000_209,
               "ml-10m": 10_000_054}[tcfg.DATASET.NAME]
    tm = build_model_config(tcfg, *dims, num_edges=ratings)
    jm = j_build_model_config(jcfg, *dims, num_edges=ratings)
    batch = tcfg.TRAIN.RATING_BATCH_SIZE
    for e_active in (int(0.8 * ratings) - batch, 1, 12_345):
        got = flops.stargcn_step_flops(tm, e_active, batch)
        assert got == jflops.stargcn_step_flops(jm, e_active, batch)
        assert got["step"] == 3 * got["fwd"] > 0


def test_mfu_against_the_h100_peak():
    assert flops.H100_SXM_BF16_PEAK_FLOPS == 989e12
    assert flops.mfu(989e12, 1.0) == 1.0
    assert flops.mfu(989e12 / 4, 0.5) == 0.5
    assert flops.mfu(1e12, 0.0) == 0.0
    assert flops.mfu(197e12, 1.0, peak=197e12) == jflops.mfu(197e12, 1.0)
    assert 0 < flops.mfu(1e12, 1.0) < 0.01


def test_reference_machine_model_is_the_jax_packages():
    for name in ("HBM_BYTES_PER_S", "HBM_EFF_BOUND", "HBM_EFF_REALISTIC",
                 "FP32_FLOPS", "GEMM_EFF", "PCIE_BYTES_PER_S",
                 "LAUNCH_S_BOUND", "LAUNCH_S_REALISTIC", "HOST_SPEEDUP",
                 "ADAM_BYTES_PER_PARAM", "DATASETS", "NBLOCKS", "DIRECTIONS",
                 "LAYERS", "AGG_UNITS", "OUT_UNITS", "MID_MAP",
                 "TRAIN_FRAC"):
        assert getattr(refestimate, name) == getattr(jref, name), name


@pytest.mark.parametrize("levels", range(1, 13))
def test_op_count_matches_jax(levels):
    assert refestimate.op_count(levels) == jref.op_count(levels)


@pytest.mark.parametrize("name", list(refestimate.DATASETS))
def test_estimate_matches_jax(name):
    shapes = refestimate.DATASETS[name]
    for host_ms in (0.0, 50.0, 3804.7):
        assert refestimate.estimate(shapes, host_ms) == jref.estimate(
            shapes, host_ms)


def test_estimate_all_recorded():
    out = refestimate.estimate_all(measure=False)
    assert set(out) == set(refestimate.DATASETS)
    for name, est in out.items():
        assert est["host_ms_measured"] == round(
            refestimate.RECORDED_HOST_MS[name], 2)
        # the reference's full step can beat neither its kernel-only
        # roofline (720 M msgs/s) nor fall below 0.1 M msgs/s
        assert 1e5 < est["rate_bound"] < 7.2e8
        assert est == jref.estimate(jref.DATASETS[name],
                                    refestimate.RECORDED_HOST_MS[name])
    assert list(refestimate.estimate_all(False, ["ml-1m"])) == ["ml-1m"]


def test_measure_host_ms_runs_small():
    shapes = dict(nu=50, ni=40, ratings=2000, levels=5, embed=8,
                  batch=256)
    got = refestimate.measure_host_ms(shapes, iters=2)
    assert got["host_ms_measured"] > 0
    ten = dict(shapes, levels=10)
    assert refestimate.measure_host_ms(ten, iters=1)["host_ms_measured"] > 0


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_the_annotated_span(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("stargcn_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "stargcn_span" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_step_timer_keeps_its_window(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(edges_per_step=1000, examples_per_step=10,
                                window=3)
    assert timer.stats() == {"step_ms": 0.0, "edges_per_s": 0.0,
                             "examples_per_s": 0.0}
    timer.start()
    for _ in range(5):
        timer.tick()
    assert len(timer._times) == 3
    assert timer.mean_step_s == 0.5
    assert timer.stats() == {"step_ms": 500.0, "edges_per_s": 2000.0,
                             "examples_per_s": 20.0}


@pytest.mark.parametrize("mode", [[], ["--num_neighbors", "4",
                                       "--backend", "xla"]],
                         ids=["full_graph", "sampled"])
def test_train_cli_profile_writes_a_trace(tmp_path, mode):
    cfg = cfg_from_file(os.path.join(ROOT, "configs",
                                     "transductive_ml_100k.yml"))
    cfg.TRAIN.VALID_INTERVAL = 2
    cfg.TRAIN.LOG_INTERVAL = 1
    path = str(tmp_path / "tiny.yml")
    save_cfg_file(path, cfg)
    prof = str(tmp_path / "prof")
    result = train_cli.main([
        "--cfg", path, "--dataset", "synthetic", "--save_dir",
        str(tmp_path / "run"), "--max_iter", "2", "--device", "cpu",
        "--profile", prof, "--silent", *mode])
    assert result["best_iter"] == 2
    names = {e.get("name") for e in _trace_events(prof)}
    assert any(n and n.startswith("aten::") for n in names)
