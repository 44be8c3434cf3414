"""The train CLI on a device mesh (``--mesh``, ``--coordinator``,
``--num_processes``, ``--process_id``), the multiprocess twin
(``python -m stargcn_tpu_torch.parallel.multiprocess_train``), and the
sampled trainer's mesh, which an earlier slice refused, on 1 x 1.  Ranks meet through a
rendezvous file in the test's temporary directory, never a port; every
process has its own timeout."""

import dataclasses
import logging
import os
import subprocess
import sys

import pytest
import torch.distributed as dist
import yaml

import _torch_mesh_ranks as R
from stargcn_tpu_torch.data.synthetic import write_ml100k_format
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
from stargcn_tpu_torch.train import __main__ as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
           STARGCN_AUTO_DOWNLOAD="0")


@pytest.fixture
def fixture_run(tmp_path):
    """An ml-100k-format archive (as the JAX CLI test writes one) and a
    small config over it."""
    write_ml100k_format(str(tmp_path / "data" / "ml-100k"))
    cfg = tmp_path / "small.yml"
    cfg.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "ml-100k", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 200, "LOG_INTERVAL": 2,
                  "VALID_INTERVAL": 2, "HANG_TIMEOUT_S": 0}}))
    return ["--cfg", str(cfg), "--data_root", str(tmp_path / "data"),
            "--max_iter", "4", "--device", "cpu", "--silent"]


def test_train_cli_two_ranks_on_a_1x2_mesh(tmp_path, fixture_run):
    runs = tmp_path / "runs"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stargcn_tpu_torch.train", *fixture_run,
         "--save_dir", str(runs), "--backend", "bitdense", "--mesh", "1x2",
         "--coordinator", "file://" + str(tmp_path / "rdzv"),
         "--num_processes", "2", "--process_id", str(r)],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    # The first rank writes the run's files, once.
    names = sorted(os.listdir(runs))
    for name in ("cfg0.yml", "log0.log", "train_loss0.csv", "net0.txt",
                 "ckpt_best_0.pt", "ckpt_last_0.pt"):
        assert name in names, names
    assert "cfg1.yml" not in names
    text = (runs / "log0.log").read_text()
    assert "result: {" in text and "Iter=4," in text
    assert "result: {" in outs[1]


def test_train_cli_mesh_1x1_needs_no_coordinator(tmp_path, fixture_run):
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main(fixture_run + [
            "--save_dir", str(tmp_path / "one"), "--backend", "xla",
            "--mesh", "1x1"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] in (2, 4)
    assert not dist.is_initialized()
    assert (tmp_path / "one" / "ckpt_last_0.pt").exists()


def test_multiprocess_twin_passes():
    out = subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.multiprocess_train",
         "--device", "cpu", "--timeout", "200"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "MULTIPROCESS RUN PASSED" in out.stdout
    assert out.stdout.count("MULTIPROCESS OK") == 2


def test_sampled_mesh_refusals_name_the_next_slice(tmp_path, fixture_run):
    """What an earlier slice refused by name now runs, on a 1 x 1 mesh (a
    world of one, gloo): ``SampledTrainer(mesh=)`` (a step),
    ``sampled_forward(row_sharding=)`` (equal to the forward without a
    mesh) and the train CLI's ``--mesh`` in sampled mode; a mesh that is
    not a ``parallel.Mesh`` is refused."""
    import numpy as np
    import torch

    from stargcn_tpu_torch.models import sampled as tsm
    from stargcn_tpu_torch.parallel import make_mesh

    t = R.port_trainer("dense")
    cfg = dataclasses.replace(t.model_cfg, backend="xla")
    with pytest.raises(TypeError, match="parallel.Mesh"):
        SampledTrainer(cfg, t.data_iter, TrainSettings(), fanout=4,
                       device="cpu", mesh=object())
    settings = TrainSettings(rating_batch_size=64, recon_batch_size=16,
                             seed=3)
    mesh = make_mesh(1, 1, device="cpu")
    try:
        st = SampledTrainer(cfg, t.data_iter, settings, fanout=4,
                            device="cpu", mesh=mesh)
        rs = t.data_iter.rating_sampler(batch_size=st.train_batch,
                                        segment="train")
        rc = t.data_iter.recon_nodes_sampler(batch_size=16)
        batch = st._build_batch_safe(rs, rc)
        assert np.isfinite(float(st.train_iteration(batch)["loss"]))
        plan, _, _, _, nu, ni = batch
        with torch.no_grad():
            got = tsm.sampled_forward(st.model, cfg, plan, nu, ni,
                                      row_sharding=mesh)
            want = tsm.sampled_forward(st.model, cfg, plan, nu, ni)
        torch.testing.assert_close(got["pred_ratings"],
                                   want["pred_ratings"])
    finally:
        dist.destroy_process_group()
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main(fixture_run + [
            "--save_dir", str(tmp_path / "s"), "--num_neighbors", "4",
            "--mesh", "1x1"])
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    assert result["best_iter"] in (2, 4)
    assert not dist.is_initialized()
    assert (tmp_path / "s" / "ckpt_last_0.pt").exists()
