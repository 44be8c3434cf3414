"""The device mesh of the port (``stargcn_tpu_torch/parallel``) on spawned
CPU ranks over gloo: the mesh's rank grid against the JAX package's device
grid, each placement against the JAX shard of the same position, the
collectives' conjugate pairs and the clip's global norm at axis size 2,
and a mesh ``Trainer``'s evaluation (against the JAX package's mesh
``Trainer``), checkpoint round trip, serving export and dropout lockstep.
The ranks run ``tests/_torch_mesh_ranks.py``; the steps of each backend
are ``tests/test_torch_mesh_{xla,dense,bitdense}.py``."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mesh_ranks as R
from _torch_mesh_ref import jax_params, jax_trainer, port_single
from stargcn_tpu.parallel import make_mesh as jmake_mesh
from stargcn_tpu_torch.parallel import make_mesh
from stargcn_tpu_torch.serve import export_serving


def test_make_mesh_world_of_one_and_refusals():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="2 ranks"):
        make_mesh(2, 1, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coords == (0, 0) and mesh.leader
        assert mesh.backend == "gloo"
        assert mesh.grid.tolist() == [[0]]
        for axis in ("data", "model", "all"):
            assert dist.get_world_size(mesh.group(axis)) == 1
        with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
            make_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="ascending"):
            make_mesh(1, 1, devices=[1, 0], device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("place")
    R.spawn(R.place_ranks, 4, tmp, str(tmp), timeout=120)
    return [torch.load(tmp / f"place_r{r}.pt", weights_only=False)
            for r in range(4)]


def test_rank_grid_matches_jax_device_grid(placed):
    """Rank r sits where ``np.asarray(devices).reshape(data, model)`` puts
    device r."""
    jgrid = np.vectorize(lambda d: d.id)(jmake_mesh(2, 2).devices)
    for r, found in enumerate(placed):
        assert found["grid"].tolist() == jgrid.tolist()
        assert tuple(np.argwhere(jgrid == r)[0]) == found["coords"]


@pytest.mark.parametrize("name, n, spec", [
    ("edges", 512, P("model")), ("embed", 64, P("model", None)),
    ("bit", 1280, P("model", None)), ("batch", 64, P("data")),
    ("replicated", 64, P())])
def test_placements_match_jax_shards(placed, name, n, spec):
    """Each rank's rows are the index of the JAX shard on the device of the
    same position, and ``Shard.whole`` puts the array back together."""
    jmesh = jmake_mesh(2, 2)
    shape = (n,) if len(spec) < 2 else (n, 4)
    index = NamedSharding(jmesh, spec).devices_indices_map(shape)
    by_id = {d.id: idx for d, idx in index.items()}
    for r, found in enumerate(placed):
        lo, hi, whole = found[name]
        rows = by_id[r][0]
        assert (lo, hi) == (rows.start or 0, n if rows.stop is None
                            else rows.stop)
        assert whole


def test_bit_pack_rows_stay_whole_where_blocks_do_not_split(placed):
    """A row-interleaved pack splits only into whole 128-row blocks: 1280
    rows split over 2 ranks, 1000 rows stay replicated."""
    for found in placed:
        assert found["pack_axes"] == ("model", None)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    R.spawn(R.collective_ranks, 2, tmp, str(tmp), timeout=120)
    return [torch.load(tmp / f"collectives_r{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("pair", ["enter_leave", "gather_rows"])
def test_collective_pairs_give_the_single_process_gradient(collectives,
                                                           pair):
    """A replicated input entering a split computation and the partial sums
    leaving it, or row shards made whole: values and gradients equal the
    one-process function's.  A pair the wrong way round is off by the axis
    size (2) here."""
    for found in collectives:
        got, want, got_grad, want_grad = found[pair]
        torch.testing.assert_close(got, want)
        torch.testing.assert_close(got_grad, want_grad)


def test_clip_norm_adds_split_rows_once_each(collectives):
    for found in collectives:
        got, want = found["global_sq_norm"]
        torch.testing.assert_close(got, want)


def test_from_first_gives_every_rank_the_first_ranks_bits(collectives):
    for found in collectives:
        got, want = found["from_first"]
        assert torch.equal(got, want)


def test_replicas_take_the_first_replicas_gradients(trained):
    """Gradients that differ from rank to rank (as atomics make them on the
    card; here rank r's are all r + 1) leave ``_replica_grads`` equal to
    the first replica's: rank 0's for replicated parameters, each rank's
    own for the embedding rows split over 'model' (on 1 x 2 no other rank
    holds them)."""
    for rank, found in enumerate(trained["ranks"]):
        for k, g in found["replica_grads"].items():
            want = rank + 1.0 if k.startswith(("embed_user", "embed_item")) \
                else 1.0
            assert torch.equal(g, torch.full_like(g, want)), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two ranks: a 1 x 2 ``dense`` trainer (evaluation, a step, its
    checkpoint, the export) and 2 x 1 trainers (evaluation; three
    ``bitdense`` steps with dropout 0.5), from the JAX package's initial
    parameters."""
    tmp = tmp_path_factory.mktemp("trainer")
    jt = {shape: jax_trainer("dense", shape) for shape in ((1, 2), (2, 1))}
    state = jax_params(jt[(1, 2)])
    single = port_single("dense", tmp / "dense", state)
    port_single("bitdense", tmp / "bitdense", state)
    it = single.data_iter
    ratings = it.rating_sampler(batch_size=64, segment="train")
    recon = it.recon_nodes_sampler(batch_size=10**6)
    batches = []
    for _ in range(3):
        rb = next(ratings)
        noise, _, ids = next(recon)
        batches.append((rb, single.prepare_recon_batch(noise, ids)))
    R.spawn(R.trainer_ranks, 2, tmp, str(tmp), batches, str(tmp))
    return {"jax_valid": {k: t.evaluate("valid") for k, t in jt.items()},
            "ranks": [torch.load(tmp / f"trainer_r{r}.pt",
                                 weights_only=False) for r in range(2)],
            "state": state, "batches": batches, "tmp": tmp}


@pytest.mark.parametrize("key, shape", [("valid_init", (1, 2)),
                                        ("valid_init_2x1", (2, 1))],
                         ids=["1x2", "2x1"])
def test_evaluate_matches_jax_mesh_trainer(trained, key, shape):
    for found in trained["ranks"]:
        np.testing.assert_allclose(found[key], trained["jax_valid"][shape],
                                   rtol=1e-5, atol=1e-6)


def test_checkpoint_restores_on_every_rank_and_in_one_process(trained):
    saved = trained["ranks"][0]["params_saved"]
    for found in trained["ranks"]:
        for k, v in found["params_restored"].items():
            assert torch.equal(v, saved[k]), k
        for k, v in found["local_restored"].items():
            assert torch.equal(v, found["local_saved"][k]), k
        assert found["opt_count"] == 1
        # The tables are split by rows over 'model': 64 rows, 32 a rank.
        assert found["shapes_saved"]["embed_user.weight"] == (32, 8)
    one = R.port_trainer("dense")
    one.restore_checkpoint(trained["ranks"][0]["ckpt"])
    for k, v in one.whole_params().items():
        assert torch.equal(v, saved[k]), k
    assert one.opt.count == 1


def test_export_from_a_mesh_trainer_matches_one_process(trained):
    one = R.port_trainer("dense")
    one.restore_checkpoint(trained["ranks"][0]["ckpt"])
    art = export_serving(one)
    for found in trained["ranks"]:
        users, items = found["export"]
        np.testing.assert_allclose(users, art.user_feats, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(items, art.item_feats, rtol=1e-5,
                                   atol=1e-6)


def test_per_edge_dropout_on_edge_shards_matches_one_process(trained):
    """``GCN.DROPOUT_PER_EDGE`` on a 1 x 2 ``xla`` mesh: each rank masks its
    edges with its rows of the whole edge set's mask, so loss and
    gradients are one process's."""
    one = port_single("xla", trained["tmp"] / "per_edge", trained["state"],
                      **R.PER_EDGE)
    one.seed_dropout(7)
    stats, grads = one.loss_and_grads(*trained["batches"][0])
    for found in trained["ranks"]:
        loss, got = found["per_edge"]
        np.testing.assert_allclose(float(loss), float(stats["loss"]),
                                   rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dropout_steps_keep_ranks_bit_equal(trained):
    """Three ``bitdense`` steps with ``GCN.DROPOUT`` 0.5 on 2 x 1: every
    rank draws the same masks, so the replicated parameters stay bit-equal,
    and they follow the one-process steps on the same batches."""
    first, second = (f["dropout_params"] for f in trained["ranks"])
    for k in first:
        assert torch.equal(first[k], second[k]), k
    one = port_single("bitdense", trained["tmp"] / "one", trained["state"],
                      **{"GCN.DROPOUT": 0.5})
    for rb, cb in trained["batches"]:
        one.train_iteration(rb, cb)
    for k, v in one.whole_params().items():
        np.testing.assert_allclose(first[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=5e-5, err_msg=k)
