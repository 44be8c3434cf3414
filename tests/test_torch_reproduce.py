"""The paper-matrix runner (``stargcn_tpu_torch/train/reproduce.py``) and
the parse at scale (``data/parse_at_scale.py``), on the CPU, on the
fixture archives the tests write (``tests/_torch_slice.py:
write_ml100k_fixture``).

* The pre-flight refuses the fixture, which breaks ml-100k's published
  counts, as ``scripts/reproduce_paper.sh``'s does, before anything
  trains; an absent archive fails there too (nothing is downloaded).
* ``--parity`` on ``transductive_ml_100k`` (10 steps, the pre-flight
  skipped): its ``summary.tsv`` row equals the ``result`` of the port's
  train CLI run in this process on the same config and seed, and it writes
  nothing outside ``--out``.
"""

import logging
import os

import pytest

from _torch_slice import write_ml100k_fixture
from stargcn_tpu_torch.data import invariants
from stargcn_tpu_torch.data import parse_at_scale
from stargcn_tpu_torch.train import reproduce

CONFIG = "transductive_ml_100k"
STEPS = "10"


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    monkeypatch.setenv("STARGCN_AUTO_DOWNLOAD", "0")


def tree(root):
    """Every file under ``root`` with its size and modification time."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            st = os.stat(p)
            out[p] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """``python -m stargcn_tpu_torch.train.reproduce --parity`` on the
    fixture: ``(tmp root, data root, out dir, files before, files
    after)``."""
    base = tmp_path_factory.mktemp("repro")
    data_root = write_ml100k_fixture(str(base / "data"))
    out = str(base / "out")
    before = tree(str(base))
    old = os.environ.get("STARGCN_AUTO_DOWNLOAD")
    os.environ["STARGCN_AUTO_DOWNLOAD"] = "0"
    try:
        rc = reproduce.main(["--data_root", data_root, "--out", out,
                             "--parity", "--configs", CONFIG, "--max_iter",
                             STEPS, "--device", "cpu", "--no_preflight"])
    finally:
        if old is None:
            del os.environ["STARGCN_AUTO_DOWNLOAD"]
        else:
            os.environ["STARGCN_AUTO_DOWNLOAD"] = old
    assert rc == 0
    return base, data_root, out, before, tree(str(base))


def test_preflight_refuses_the_fixture(tmp_path):
    data_root = write_ml100k_fixture(str(tmp_path / "data"))
    out = str(tmp_path / "out")
    with pytest.raises(invariants.DataInvariantError, match="ml-100k"):
        reproduce.run(data_root, out, configs=[CONFIG], device="cpu",
                      log=lambda *a: None)
    assert not os.path.exists(out), "nothing trains after a refusal"
    # an archive that is not there is refused without a download
    with pytest.raises(FileNotFoundError, match="ml-1m"):
        reproduce.preflight(["ml-1m"], data_root, log=lambda *a: None)
    # the whole matrix reads all three datasets
    assert sorted({reproduce.dataset_of(n)
                   for n in reproduce.config_names()}) == [
        "ml-100k", "ml-10m", "ml-1m"]
    assert len(reproduce.config_names()) == 15
    assert reproduce.config_names(parity=True) == [
        "transductive_ml_100k", "transductive_ml_1m", "transductive_ml_10m"]


def test_row_equals_the_train_cli_result(parity_run, tmp_path):
    from stargcn_tpu_torch.train import __main__ as train_cli

    _, data_root, out, _, _ = parity_run
    with open(os.path.join(out, "summary.tsv")) as f:
        lines = f.readlines()
    assert lines[0] == reproduce.HEADER and len(lines) == 2
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        result = train_cli.main(reproduce.train_argv(
            CONFIG, data_root, str(tmp_path / "cli"), int(STEPS), "cpu")
            + ["--silent"])
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
    assert result["best_iter"] == int(STEPS)
    assert lines[1] == reproduce.summary_row(CONFIG, result)
    fields = lines[1].rstrip("\n").split("\t")
    assert fields[0] == CONFIG and fields[4] == "0.895"
    with open(os.path.join(out, f"{CONFIG}.out")) as f:
        assert reproduce.last_result(f.read()) == result


def test_parity_writes_nothing_outside_out(parity_run):
    base, data_root, out, before, after = parity_run
    new = {p for p in after if p not in before or after[p] != before[p]}
    assert new and all(p.startswith(out + os.sep) for p in new), sorted(new)
    with open(os.path.join(out, "parity.md")) as f:
        table = f.read()
    assert "| dataset | best test RMSE | paper |" in table
    assert "| ml-100k |" in table and "| 0.895 |" in table
    assert os.path.exists(os.path.join(out, CONFIG, "ckpt_best_0.pt"))


def test_parse_at_scale_on_a_small_archive(tmp_path):
    out = parse_at_scale.run(str(tmp_path), num_users=40, num_items=25,
                             num_edges=900)
    # every line of ratings.dat is one rating of the graph
    assert out["num_users"] == 40 and out["num_items"] == 25
    assert out["archive_ratings"] == out["graph_nnz"] > 0
    assert out["peak_rss_mb"] > 0
    assert out["ratings_per_s"] == pytest.approx(
        out["archive_ratings"] / out["parse_and_build_s"])


def test_a_run_past_its_timeout_is_killed_and_raises(tmp_path):
    """A config's child process that outlasts ``timeout_s`` is killed and
    the driver raises (here one that cannot start its imports in time)."""
    data_root = write_ml100k_fixture(str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="killed after"):
        reproduce.train_config(CONFIG, data_root, str(tmp_path), 10, "cpu",
                               log=lambda *a: None, timeout_s=0.05)
