"""``BlockSampler(planner="native")`` (``kernels.sample_block_ell`` of the
port's host extension) against the port's ``'loop'`` and ``'vectorised'``
routes and the JAX package's ``_sample_native`` (its own extension, built
into a temporary directory), and ``SampledTrainer`` on the native route.

At a fanout of at least the largest degree nothing is left to chance, so
the routes give the same plan: frontiers, ELL indices and ratings and
target positions equal; weights equal to the JAX package's native planner
bit for bit (the same float32 products) and within rtol 1e-6 (atol 1e-7)
of the NumPy routes', which round ``1/sqrt(d_r d_c)`` from float64, as
``tests/test_sampled.py::test_native_plan_matches_numpy`` holds them.
Trainer steps are held to ``tests/test_torch_sampled_trainer.py``'s
tolerances."""

import threading
from unittest import mock

import jax
import numpy as np
import pytest

import chip_smoke
from _torch_slice import (build_jax_native, build_sampled_trainers,
                          reference_on_cpu, sampled_batches, sampled_cfgs,
                          sampled_graphs, sampled_iterator, seed_planners)
from stargcn_tpu.graph import kernels as jk
from stargcn_tpu.graph.sampling import BlockSampler as JBlockSampler
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data.synthetic import synthetic_graph
from stargcn_tpu_torch.graph import kernels as tk
from stargcn_tpu_torch.graph.sampling import BlockSampler
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings

STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")


@pytest.fixture(scope="module")
def jext(tmp_path_factory):
    return build_jax_native(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(scope="module")
def graphs():
    return sampled_graphs()


def max_degree(g):
    return int(max(np.diff(g["user", "movie"].ind_ptr).max(),
                   np.diff(g["movie", "user"].ind_ptr).max()))


def _plan(sampler, pairs, remove, removal_args=None):
    kw = {}
    if remove:
        keys, rem = (removal_args or sampler.removal_args)(pairs[0], pairs[1])
        kw = dict(exclude_keys=keys, removal_counts=rem)
    return sampler.sample(np.unique(pairs[0]), np.unique(pairs[1]), **kw)


@pytest.mark.parametrize("remove", [False, True])
def test_native_plan_equals_the_other_routes_at_full_fanout(graphs, jext,
                                                            remove):
    jg, tg = graphs
    fanout = max_degree(tg)
    pairs = tg["user", "movie"].node_pair_ids[:, ::7]
    kw = dict(num_layers=2, fanout=fanout,
              frontier_caps={"user": 64, "item": 64})
    plans = {p: _plan(BlockSampler(tg, planner=p, **kw), pairs, remove)
             for p in ("native", "loop", "vectorised")}
    with mock.patch.object(jk, "_native", jext):
        jplan = _plan(JBlockSampler(jg, **kw), pairs, remove)
    assert chip_smoke.plans_equal(plans["native"], jplan)
    for p in ("loop", "vectorised"):
        assert chip_smoke.plans_equal(plans["native"], plans[p],
                                      weight_rtol=1e-6), p
    last = plans["native"].blocks[-1]["user"]
    assert last.weight.sum() > 0
    if remove:
        assert (last.weight[:last.num_dst_real] == 0).any()


def _medium_graph():
    return synthetic_graph(num_users=2000, num_items=400, num_edges=24_000,
                           rating_values=(1, 2, 3, 4, 5), seed=4)


def test_native_plan_keeps_its_contract_below_the_degrees():
    """Fanout 8 on a graph of rows both shorter and longer than 8:
    ``chip_smoke.native_plan_properties`` (phase 8's check on the card)."""
    g = _medium_graph()
    sampler = BlockSampler(g, num_layers=2, fanout=8, planner="native")
    pairs = g["user", "movie"].node_pair_ids[:, ::40]
    keys, rem = sampler.removal_args(pairs[0], pairs[1])
    tk.set_seed(3)
    plan = sampler.sample(np.unique(pairs[0]), np.unique(pairs[1]),
                          exclude_keys=keys, removal_counts=rem)
    counts = chip_smoke.native_plan_properties(sampler, plan, keys, rem)
    assert counts["whole_rows"] > 0 and counts["sampled_rows"] > 0
    assert counts["excluded_slots"] > 0
    # A slot with another rating level than its edge's is caught.
    blk = plan.blocks[0]["user"]
    blk.rating[0, 0] = (blk.rating[0, 0] + 1) % 5
    with pytest.raises(SystemExit):
        chip_smoke.native_plan_properties(sampler, plan, keys, rem)


def test_native_plans_follow_the_seed_in_any_team_and_thread():
    """Frontiers of more than 2048 rows, so that the extension draws them
    in a team (shorter loops run on the calling thread)."""
    g = synthetic_graph(num_users=6000, num_items=600, num_edges=48_000,
                        rating_values=(1, 2, 3, 4, 5), seed=5)
    sampler = BlockSampler(g, num_layers=2, fanout=5, planner="native")
    pairs = g["user", "movie"].node_pair_ids[:, ::6]
    keys, rem = sampler.removal_args(pairs[0], pairs[1])
    plans = {}

    def plan(key, n):
        tk.set_omp_threads(n)
        tk.set_seed(17)
        plans[key] = [sampler.sample(np.unique(pairs[0]), np.unique(pairs[1]),
                                     exclude_keys=keys, removal_counts=rem)
                      for _ in range(2)]

    team = tk.set_omp_threads(0)
    try:
        for n in (1, 2, 8):
            plan(("main", n), n)
            t = threading.Thread(target=plan, args=(("thread", n), n))
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        tk.set_omp_threads(team)
    first, second = plans[("main", 1)]
    assert first.blocks[-1]["user"].num_dst_real > 2048
    assert not chip_smoke.plans_equal(first, second)   # the stream moves on
    for key, (a, b) in plans.items():
        assert chip_smoke.plans_equal(a, first), key
        assert chip_smoke.plans_equal(b, second), key


def _native_trainer():
    _, tg = sampled_graphs()
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8,
                      log_interval=3, valid_interval=100, lr=1e-2, seed=3,
                      remove_rating=True)
    return SampledTrainer(sampled_cfgs()[1],
                          sampled_iterator(DataIterator, tg), s, fanout=3,
                          planner="native", device="cpu",
                          frontier_caps={"user": 256, "item": 256})


def test_prefetched_native_fit_equals_the_serial_one():
    """Dropout 0, host-fed, fanout 3 (below the degrees: the draws count):
    the producer thread plans the same batches as the serial loop, under
    its own OpenMP cap."""
    runs = []
    for prefetch in (False, True):
        tk.set_seed(5)
        tr = _native_trainer()
        assert tr.samplers["train"].planner == "native"
        runs.append((tr, tr.fit(max_iter=6, prefetch=prefetch,
                                prefetch_omp_threads=1)))
    (a, ra), (b, rb) = runs
    assert ra == rb
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert p.equal(q), k
    assert not [t for t in threading.enumerate() if t.name == "prefetch"]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_native_steps_equal_loop_and_jax_steps(graphs, jext, backend):
    """At a fanout of the largest degree the three routes plan alike: five
    steps of the port's trainer on its native plans, on its loop plans
    and the JAX package's trainer on its own native plans."""
    _, tg = graphs
    fanout = max_degree(tg)
    with reference_on_cpu():
        jt, native_t = build_sampled_trainers(backend, fanout=fanout,
                                              planner="native")
        _, loop_t = build_sampled_trainers(backend, fanout=fanout,
                                           planner="loop")
        stats = {}
        for name, t in (("native", native_t), ("loop", loop_t)):
            seed_planners(21)
            stats[name] = [{k: v.numpy() for k, v in
                            t.train_iteration(b).items()}
                           for b in sampled_batches(t, 5)]
        with mock.patch.object(jk, "_native", jext):
            seed_planners(21)
            stats["jax"] = [jax.device_get(jt.train_iteration(b))
                            for b in sampled_batches(jt, 5)]
    for other in ("loop", "jax"):
        for name in STATS:
            np.testing.assert_allclose(stats[other][0][name],
                                       stats["native"][0][name], rtol=1e-4,
                                       atol=0, err_msg=f"{other} {name}")
        np.testing.assert_allclose([s["loss"] for s in stats[other]],
                                   [s["loss"] for s in stats["native"]],
                                   rtol=1e-3, err_msg=other)
    for (k, p), q in zip(native_t.model.state_dict().items(),
                         loop_t.model.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=0,
                                   atol=1e-3 * np.abs(q.numpy()).max(),
                                   err_msg=k)
