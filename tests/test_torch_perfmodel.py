"""``parallel/perfmodel.py`` against the collectives the port issues, and
the mesh-scale twin (``python -m stargcn_tpu_torch.parallel.
mesh_scale_check``).

``modeled_collectives`` states the calls and bytes of one step by kind
and axis; ``collectives.counted()`` records what a step issued.  They
must be equal exactly (the JAX package held its model to the compiled
HLO within 8x, ``tests/test_perfmodel.py:127-131``), at 1 x 1 (a world
of one still issues every collective) and 2 x 2, for a full-graph step
on ``xla`` and ``bitdense`` and a sampled step on ``xla`` and ``pallas``
with and without ``remat``, in spawned gloo ranks.  No sampled step
gathers a whole embedding table.  The link time and the projection use
H100 constants only.  The twin runs at four ranks on 2 x 2 and 1 x 4."""

import os
import subprocess
import sys

import pytest
import torch

import _torch_mesh_ranks as R
import _torch_sampled_mesh_ranks as S
from stargcn_tpu_torch.parallel import perfmodel as P

SHAPES = ((1, 1), (2, 2))
CASES = [(d, m, c[0]) for d, m in SHAPES for c in S.COUNT_CASES]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
TWIN = ((4, 2, 2), (4, 1, 4))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The counted steps (one spawn of four ranks), while the twin runs
    at both shapes in processes of its own."""
    tmp = tmp_path_factory.mktemp("perfmodel")
    twins = {shape: subprocess.Popen(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.mesh_scale_check",
         *map(str, shape), "--device", "cpu", "--timeout", "200"],
        cwd=ROOT, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in TWIN}
    try:
        R.spawn(S.count_ranks, 4, tmp, SHAPES, str(tmp))
        outs = {shape: p.communicate(timeout=240)[0]
                for shape, p in twins.items()}
    finally:
        for p in twins.values():
            p.kill()
    found = {}
    for r in range(4):
        for key, v in torch.load(tmp / f"count_r{r}.pt",
                                 weights_only=False).items():
            found.setdefault(key, []).append(v)
    return {"found": found, "twin": {shape: (twins[shape].returncode, out)
                                     for shape, out in outs.items()}}


@pytest.mark.parametrize("d, m, name", CASES,
                         ids=[f"{d}x{m}-{n}" for d, m, n in CASES])
def test_model_equals_the_counted_collectives(counted, d, m, name):
    ranks = counted["found"][(d, m, name)]
    assert len(ranks) == d * m
    first = ranks[0]
    modeled = P.modeled_collectives(first["model_cfg"], d, m,
                                    first["backend"],
                                    sampled=first["sampled"])
    for got in ranks:
        assert got["counts"] == modeled
    # Every kind on every axis, even where the axis has one rank.
    assert "all_reduce" in modeled and "broadcast" in modeled


@pytest.mark.parametrize("d, m", SHAPES, ids=["1x1", "2x2"])
def test_no_sampled_step_gathers_a_table(counted, d, m):
    for name in ("sampled-xla", "sampled-pallas", "sampled-pallas-remat"):
        for got in counted["found"][(d, m, name)]:
            cfg = got["model_cfg"]
            tables = {n * cfg.embed_units * 4
                      for n in (cfg.num_users, cfg.num_items)}
            for kind, axis, nbytes in got["calls"]:
                assert not (kind == "all_gather" and axis == "model"), name
                assert not (kind == "all_gather" and nbytes in tables)


def test_remat_issues_the_same_collectives(counted):
    for d, m in SHAPES:
        for backend in ("xla", "pallas"):
            plain = counted["found"][(d, m, f"sampled-{backend}")][0]
            remat = counted["found"][(d, m, f"sampled-{backend}-remat")][0]
            assert plain["counts"] == remat["counts"]


@pytest.mark.parametrize("shape", TWIN, ids=["2x2", "1x4"])
def test_mesh_scale_check(counted, shape):
    rc, out = counted["twin"][shape]
    assert rc == 0, out[-3000:]
    ranks, d, m = shape
    assert f"MESH SCALE OK {ranks} ranks {d}x{m} on cpu over gloo" in out


def test_link_seconds_and_projection_use_h100_links():
    vol = {"all_reduce": {"data": [1, 450e9], "model": [2, 900e9]},
           "all_gather": {"model": [1, 900e9]},
           "broadcast": {"all": [1, 450e9]}}
    # 2 B (n - 1) / n for the all-reduce, B (n - 1) / n for the gather,
    # B for the broadcast, over 450 GB/s; nothing over an axis of one.
    assert P.link_seconds(vol, 1, 2) == pytest.approx(
        900e9 / 450e9 + 900e9 / 2 / 450e9 + 450e9 / 450e9)
    assert P.link_seconds(vol, 1, 1) == 0.0
    assert P.link_seconds(vol, 2, 1, P.PCIE_BYTES_PER_S) == pytest.approx(
        450e9 / 64e9 + 450e9 / 64e9)
    assert (P.NVLINK_BYTES_PER_S, P.PCIE_BYTES_PER_S) == (450e9, 64e9)
    first = S.iterator(S.DataIterator, S.synthetic_graph)
    cfg = S.model_cfg(S.STARGCNConfig, first, backend="bitdense")
    rows = P.project(cfg, step_s_1card=0.030, split_s_1card=0.020,
                     batch=64, meshes=((1, 1), (1, 2), (2, 2)))
    assert [r["cards"] for r in rows] == [1, 2, 4]
    assert rows[0]["link_ms"] == 0.0 and rows[0]["step_ms"] == \
        pytest.approx(30.0)
    # The measured 20 ms halve over 'model', the other 10 ms stay.
    assert rows[1]["link_ms"] > 0 and rows[1]["step_ms"] == pytest.approx(
        20.0 + rows[1]["link_ms"])
    assert rows[2]["scaling_efficiency"] < rows[1]["scaling_efficiency"]
    with pytest.raises(ValueError):
        P.project(cfg, step_s_1card=0.030, split_s_1card=0.040, batch=64)


def test_scaling_projection_prints_one_row_per_mesh():
    out = subprocess.run(
        [sys.executable, "-m", "stargcn_tpu_torch.parallel.scaling",
         "--project", "--step-ms", "29", "--split-ms", "20", "--batch",
         "100000", "--meshes", "1x1,1x2,2x2"], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(rows) == 3 and '"mesh": "2x2"' in rows[2]
