"""One full-graph step on the ``dense`` backend on 1 x 2 and 2 x 1 meshes of
spawned CPU ranks (gloo), held against the JAX package's mesh ``Trainer``
of the same shape and against the port's step on one process
(``tests/_torch_mesh_ref.py``)."""

import pytest

import _torch_mesh_ranks as R
from _torch_mesh_ref import check_against_jax, check_against_single, \
    step_results

BACKEND = "dense"
MESHES = R.MESHES
IDS = [f"{d}x{m}" for d, m in MESHES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return step_results(BACKEND, tmp_path_factory.mktemp(BACKEND), MESHES)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_step_matches_jax_mesh_step(results, shape):
    check_against_jax(results, shape)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_step_matches_port_single_process(results, shape):
    check_against_single(results, shape)
