"""Every cell of ``BENCHMARK.json`` runs through the harness at toy size on
the CPU and gives a result of the contract's shape; the command refuses
to report without a card."""

import io
import json
import os
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.tests.conftest import ROOT, toy_overrides

B = harness.manifest()
CELLS = [w["name"] for w in B["workloads"]]


def toy_run(name, trace, seed=2**31 + 5):
    w = next(w for w in B["workloads"] if w["name"] == name)
    toy = toy_overrides(harness.load_json("configs", f"{w['config']}.json"))
    buf = io.StringIO()
    r = harness.run(name, seed, 0.3, trace, device="cpu", out=buf, **toy)
    assert buf.getvalue().startswith("graph: ")
    return w, r


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_at_toy_size(name, trace):
    w, r = toy_run(name, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    line = json.loads(json.dumps(r))
    assert line == r
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in B["end_to_end"]
                                     if name in m.get("workloads", [name])}
        assert r["metrics"]["train_examples_per_s"]["value"] > 0
    else:
        # On the CPU the trace holds no device activity: only the host
        # spans' metrics are there.
        assert set(r["metrics"]) <= {m["name"] for m in B["per_layer"]}
        assert r["metrics"]["graph_build_s"]["value"] > 0
        assert "device_idle_pct" not in r["metrics"]
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    assert r["device"]["count"] == w["chips"]


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, *B["command"][1:], "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_command_fails_without_the_program(tmp_path):
    # A directory with only BENCHMARK.json and the benchmark's files.
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *B["command"][1:], "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "{" not in out.stdout
