"""The sampled trainer's training schedule on a device mesh, on spawned
gloo CPU ranks (``tests/_torch_sampled_mesh_ranks.py:train_ranks``), each
held against the same calls in one process: ``train_chunk`` at 2 x 2
(``tests/test_sampled_parallel.py:96-116``; dropout 0.3, whose masks are
one process's), ``fit`` with evaluation and checkpoints (restored in one
process), ``plan_device`` (the plan bit-equal on every rank and to one
process's; the identity frontiers read their embedding rows from the
split tables), ``USE_FEA_PROJ``, counts no axis divides
(``tests/test_sampled_parallel.py:146-173``: batch 31 on a 45 x 37 graph,
dropout 0.5), cap growth forced on one rank only (no hang; every rank
ends on the first rank's caps and parameters), and the train CLI with
``--mesh 1x2 --num_neighbors 4`` on two processes.  Tolerances are
``tests/test_torch_sampled_mesh.py``'s."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import _torch_mesh_ranks as R
import _torch_sampled_mesh_ranks as S
from _torch_mesh_ref import LOSS_TOL, PARAM_TOL, assert_params_close
from stargcn_tpu_torch.graph import kernels as K

CAPS = {"user": 48, "item": 40}
ODD_CAPS = {"user": 45, "item": 37}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
           STARGCN_AUTO_DOWNLOAD="0")


def _single(name, ckpt, **kw):
    t = S.port_trainer(caps=kw.pop("caps", CAPS), **kw)
    t.restore_checkpoint(ckpt[name])
    return t


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sampled_mesh_train")
    ckpt = {"caps": CAPS, "odd_caps": ODD_CAPS}
    made = {}
    for name, kw in (("xla", {}), ("fea", {"model": S.FEA}),
                     ("odd", {"graph": S.ODD_GRAPH, "caps": ODD_CAPS,
                              "settings": {"rating_batch_size": 31}})):
        t = S.port_trainer(caps=kw.pop("caps", CAPS), **kw)
        t.save_dir = str(tmp / name)
        ckpt[name] = t.save_checkpoint("init")
        made[name] = t
    ckpt["pallas"] = ckpt["xla"]
    K.set_seed(7)
    batches = {"main": S.batches(made["xla"], 3),
               "odd": S.batches(made["odd"], 3)}
    dev = S.port_trainer(plan_device=True)
    batches["device"] = S.batches(dev, 1)[0]
    ranks = R.start(S.train_ranks, 4, tmp, ckpt, batches, str(tmp),
                    timeout=300)
    try:
        one = {}
        drop = {"gcn_dropout": 0.3}
        t = _single("pallas", ckpt, backend="pallas", model=drop)
        one["chunk"] = {"stats": t.train_chunk(batches["main"][:3]),
                        "params": t.whole_params()}
        t = _single("xla", ckpt, model=drop)
        t.save_dir = str(tmp / "fit_one")
        K.set_seed(17)
        one["fit"] = {"result": t.fit(max_iter=10, log=lambda *_: None),
                      "params": t.whole_params()}
        t = _single("xla", ckpt, caps=None, plan_device=True)
        one["plan_device_plan"] = S.device_plan(t, batches["device"])
        t = _single("xla", ckpt, caps=None, plan_device=True)
        one["plan_device"] = {
            "stats": t.train_iteration(batches["device"]),
            "params": t.whole_params()}
        t = _single("fea", ckpt, model=S.FEA)
        one["fea"] = S.step_found(t, batches["main"][0])
        t = _single("odd", ckpt, caps=ODD_CAPS, graph=S.ODD_GRAPH,
                    backend="pallas", model={"gcn_dropout": 0.5},
                    settings={"rating_batch_size": 31})
        one["odd"] = {"stats": [t.train_iteration(b)
                                for b in batches["odd"]],
                      "params": t.whole_params()}
    finally:
        ranks.wait()
    return {"one": one, "tmp": tmp, "ranks": [
        torch.load(tmp / f"train_r{r}.pt", weights_only=False)
        for r in range(4)]}


def _stats_close(got, want, keys=("loss", "sq_err", "gnorm")):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **LOSS_TOL)


def test_train_chunk_matches_one_process(trained):
    want = trained["one"]["chunk"]
    for found in trained["ranks"]:
        _stats_close(found["chunk"]["stats"], want["stats"])
        assert_params_close(found["chunk"]["params"], want["params"],
                            **PARAM_TOL)


def test_fit_matches_one_process_and_restores_in_one(trained):
    want = trained["one"]["fit"]
    for found in trained["ranks"]:
        got = found["fit"]
        assert got["count"] == 10
        assert got["result"]["best_iter"] == want["result"]["best_iter"]
        np.testing.assert_allclose(got["result"]["best_valid_rmse"],
                                   want["result"]["best_valid_rmse"],
                                   rtol=1e-4)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)
    fit_dir = trained["tmp"] / "fit"
    names = sorted(os.listdir(fit_dir))
    for name in ("ckpt_best_0.pt", "ckpt_last_0.pt", "train_loss0.csv",
                 "valid_loss0.csv", "net0.txt"):
        assert name in names, names
    one = S.port_trainer(caps=CAPS)
    one.restore_checkpoint(str(fit_dir / "ckpt_last_0.pt"))
    assert one.opt.count == 10
    for k, v in one.whole_params().items():
        assert torch.equal(v, trained["ranks"][0]["fit"]["params"][k]), k


def test_plan_device_plans_are_equal_on_every_rank_and_to_one(trained):
    from stargcn_tpu_torch.models.sampled import _flatten

    flat_want = []
    struct = _flatten(trained["one"]["plan_device_plan"], flat_want)
    for found in trained["ranks"]:
        flat = []
        assert _flatten(found["plan_device_plan"], flat) == struct
        for a, b in zip(flat, flat_want):
            assert torch.equal(a, b)


def test_plan_device_step_matches_one_process(trained):
    want = trained["one"]["plan_device"]
    for found in trained["ranks"]:
        _stats_close(found["plan_device"]["stats"], want["stats"])
        assert_params_close(found["plan_device"]["params"],
                            want["params"], **PARAM_TOL)


def test_fea_proj_step_matches_one_process(trained):
    want = trained["one"]["fea"]
    for found in trained["ranks"]:
        got = found["fea"]
        _stats_close(got["stats"], want["stats"])
        assert_params_close(got["grads"], want["grads"], rtol=1e-4,
                            atol=1e-6)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)


def test_odd_row_counts_stay_finite_and_match_one_process(trained):
    want = trained["one"]["odd"]
    for found in trained["ranks"]:
        got = found["odd"]
        assert got["sizes"][0] % 16 == 0
        assert all(v % 16 == 0 for v in got["sizes"][1].values())
        for g, w in zip(got["stats"], want["stats"]):
            assert np.isfinite(float(g["loss"]))
            assert np.isfinite(float(g["gnorm"]))
            _stats_close(g, w)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)


@pytest.mark.parametrize("cut", [0, 1], ids=["first-rank", "second-rank"])
def test_cap_growth_on_one_rank_is_the_first_ranks(trained, cut):
    first, second = (f[f"caps_cut_r{cut}"] for f in trained["ranks"][:2])
    assert first["caps"] == second["caps"]
    if cut == 0:
        # The first rank grew its cut caps; the second took them.
        assert first["caps"]["user"] > 8 and first["caps"]["item"] > 8
    else:
        assert first["caps"] == CAPS
    assert np.isfinite(first["result"]["best_valid_rmse"])
    for k, v in first["params"].items():
        assert torch.equal(v, second["params"][k]), k


def test_train_cli_sampled_on_a_1x2_mesh(tmp_path):
    """``python -m stargcn_tpu_torch.train --num_neighbors 4 --mesh 1x2
    --prefetch`` on two processes (the first rank's producer thread plans
    ahead; the second plans nothing): the first rank writes the run's
    files once."""
    from stargcn_tpu_torch.data.synthetic import write_ml100k_format

    write_ml100k_format(str(tmp_path / "data" / "ml-100k"))
    cfg = tmp_path / "small.yml"
    cfg.write_text(yaml.safe_dump({
        "DATASET": {"NAME": "ml-100k", "TEST_RATIO": 0.1},
        "EMBED": {"UNITS": 8},
        "GCN": {"AGG": {"UNITS": [16], "ACCUM": "sum"},
                "OUT": {"UNITS": [6]}, "DROPOUT": 0.3},
        "GEN_RATING": {"MID_MAP": 8},
        "TRAIN": {"RATING_BATCH_SIZE": 200, "RECON_BATCH_SIZE": 64,
                  "LOG_INTERVAL": 2, "VALID_INTERVAL": 2,
                  "HANG_TIMEOUT_S": 0}}))
    runs = tmp_path / "runs"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stargcn_tpu_torch.train", "--cfg", str(cfg),
         "--data_root", str(tmp_path / "data"), "--max_iter", "4",
         "--device", "cpu", "--silent", "--save_dir", str(runs),
         "--num_neighbors", "4", "--backend", "pallas", "--mesh", "1x2",
         "--prefetch",
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
    names = sorted(os.listdir(runs))
    for name in ("cfg0.yml", "log0.log", "train_loss0.csv", "net0.txt",
                 "ckpt_best_0.pt", "ckpt_last_0.pt"):
        assert name in names, names
    assert "cfg1.yml" not in names
    text = (runs / "log0.log").read_text()
    assert "result: {" in text and "Iter=4," in text
    assert "result: {" in outs[1]
