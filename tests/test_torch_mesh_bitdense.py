"""One full-graph step on the ``bitdense`` backend on 1 x 2, 2 x 1 and 2 x 2
meshes of spawned CPU ranks (gloo), held against the JAX package's mesh
``Trainer`` of the same shape and against the port's step on one
process (``tests/_torch_mesh_ref.py``); the same on 1 x 2 on the 16-bit
route where each direction keeps one layout whole and splits the other;
and the row-shard forms of the bit wrappers (their plain versions here)
against the whole pack's."""

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from _torch_mesh_ref import check_against_jax, check_against_single, \
    step_results
from stargcn_tpu_torch.ops import bitdense as bd

BACKEND = "bitdense"
MESHES = R.MESHES_2X2
IDS = [f"{d}x{m}" for d, m in MESHES]
# 1100 items pad to 2048 (d8 = 256, 1280 packed rows) and 64 users to 1024
# (d8 = 128, 640 rows): on the 16-bit route a half holds whole 128-row
# blocks of the item-row layouts (640) but not of the user-row ones (320).
MIXED = dict(num_items=1100, **{"KERNEL.BIT_IMPL": "pallas16"})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return step_results(BACKEND, tmp_path_factory.mktemp(BACKEND), MESHES)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_step_matches_jax_mesh_step(results, shape):
    check_against_jax(results, shape)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_step_matches_port_single_process(results, shape):
    check_against_single(results, shape)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_each_model_rank_holds_its_rows_of_the_packs(results, shape):
    """As the JAX test checks ``pf``'s sharding: each rank holds ``rows /
    m`` packed rows of both layouts of both directions (64 users and 64
    items pad to 1024, so d8 = 128 packed rows a rating level)."""
    d, m = shape
    rows = results["single"]["num_links"] * 128
    for got in results["port"][shape]:
        for t in ("user", "item"):
            for k in ("pf", "pb"):
                assert got["shapes"][f"pack/{t}/{k}"] == (rows // m, 1024)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return step_results(BACKEND, tmp_path_factory.mktemp("mixed"),
                        ((1, 2),), **MIXED)


@pytest.mark.parametrize("check", [check_against_jax, check_against_single],
                         ids=["jax_mesh_step", "port_single_process"])
def test_step_with_one_layout_split_and_one_whole(mixed, check):
    check(mixed, (1, 2))


def test_layouts_split_each_on_its_own(mixed):
    """The user-row layouts (the user direction's ``pf``, the item
    direction's ``pb``) stay whole; the item-row ones are split in half."""
    R5 = mixed["single"]["num_links"]
    for got in mixed["port"][(1, 2)]:
        s = got["shapes"]
        assert (s["split/user/pf"], s["split/item/pb"]) == (False, False)
        assert (s["split/item/pf"], s["split/user/pb"]) == (True, True)
        assert s["pack/user/pf"] == (R5 * 128, 2048)
        assert s["pack/item/pb"] == (R5 * 128, 2048)
        assert s["pack/item/pf"] == (R5 * 256 // 2, 1024)
        assert s["pack/user/pb"] == (R5 * 256 // 2, 1024)


@pytest.mark.parametrize("route, cuts", [
    ("", (0, 300, 700, 1280)), ("", (0, 640, 1280)),
    ("16", (0, 256, 1280))], ids=["across_levels", "halves", "blocks16"])
def test_row_shards_stack_and_add_up_to_the_whole_pack(rng, route, cuts):
    """On row shards an expand gives the shard's packed rows, which stacked
    in row order are the whole pack's output; the reduces' partial sums
    add up to the whole pack's (R = 5, d8 = 256)."""
    R5, D, S, F, E = 5, 2000, 1500, 9, 3000
    P, d8 = bd.pack_bits(rng.randint(0, D, E), rng.randint(0, S, E),
                         rng.randint(0, R5, E), R5, D, S,
                         row_interleave=128 if route else 0)
    P = torch.from_numpy(P)
    x = torch.from_numpy(rng.randn(P.shape[1], F).astype(np.float32))
    g = torch.from_numpy(rng.randn(R5, P.shape[1], F).astype(np.float32))
    expand = getattr(bd, f"bit_expand_matmul{route}")
    reduce = getattr(bd, f"bit_reduce_matmul{route}")
    whole_e = expand(P, x, R5, d8).permute(0, 2, 1, 3).reshape(-1, 8, F)
    parts_e, sum_r = [], torch.zeros(8, d8, F)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        shard = P[lo:hi].contiguous()
        parts_e.append(expand(shard, x, R5, d8, row0=lo))
        sum_r += reduce(shard, g, R5, d8, row0=lo)
    assert torch.equal(torch.cat(parts_e), whole_e)
    torch.testing.assert_close(sum_r, reduce(P, g, R5, d8), rtol=0,
                               atol=1e-5)
