"""Sampled training past the card's memory
(``stargcn_tpu_torch/train/beyond_hbm.py``), on the CPU.

* The device planner past int32: on a 100,000 x 30,000 graph of 200k
  edges (id product 3.0e9 > 2^31) under caps below both node counts (its
  dedup path), with REMOVE_RATING on, the port's ``plan_device`` plan
  equals the JAX package's ``DevicePlanner`` fed the same uniforms
  (indices re-encoded as ``tests/test_torch_device_sampling.py`` does),
  and every sampled slot that names a batch edge, found by a set of the
  batch's (user, item) pairs, is the exclusion's and no other.
* A cap at its type's node count (the dense path) samples every node of
  that type, in both packages: the other type's frontier grows.
* The twin's JSON line at a tiny scale on both routes, and the full-graph
  arithmetic at the JAX script's scale against an 80 GB card.
"""

import numpy as np
import pytest
import torch

from stargcn_tpu_torch.graph import device_sampling as tds
from stargcn_tpu_torch.train import beyond_hbm
from test_torch_device_sampling import (assert_plans_equal, both_plans, cfgs,
                                        graphs)

BIG = dict(user=100_000, item=30_000)
CAPS = {"user": 8192, "item": 8192}


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def test_device_planner_past_int32(monkeypatch):
    assert BIG["user"] * BIG["item"] > 2**31
    jg, tg = graphs(BIG["user"], BIG["item"], 200_000, 3)
    csr = tg["user", "movie"]
    assert (np.asarray(csr.row_ids) == np.arange(BIG["user"])).all()
    # Batch pairs are real edges of high-numbered users, so that their keys
    # pass int32 and the exclusion has slots to remove.
    pairs = csr.node_pair_ids
    rng = np.random.RandomState(5)
    high = np.nonzero(pairs[0] >= 90_000)[0]
    sel = rng.choice(high, 256, replace=False)
    pu = pairs[0, sel].astype(np.int32)
    pi = pairs[1, sel].astype(np.int32)
    batch = set(zip(pu.tolist(), pi.tolist()))

    calls = []
    real = tds.keep_mask

    def recording(keys, rows, nbr, n_other):
        kept = real(keys, rows, nbr, n_other)
        calls.append((keys, rows, nbr, n_other, kept))
        return kept

    monkeypatch.setattr(tds, "keep_mask", recording)
    jout, tout = both_plans(jg, tg, cfgs(BIG["user"], BIG["item"]), pu, pi,
                            CAPS, 4, True)
    aux = tout[2]
    assert not bool(aux["overflow"]) and not bool(jout[2]["overflow"])
    for t in ("user", "item"):
        assert 0 < int(aux[f"needed_{t}"]) <= CAPS[t] < BIG[t]
    assert aux["identity"] == {"user": False, "item": False}
    assert_plans_equal(jout, tout, CAPS, BIG)

    removed = 0
    for keys, rows, nbr, n_other, kept in calls:
        assert int(keys[keys != tds._KEY_SENTINEL].max()) > 2**31
        users_are_rows = n_other == BIG["item"]
        n_rows = BIG["user"] if users_are_rows else BIG["item"]
        r, c, kept = rows.tolist(), nbr.tolist(), kept.tolist()
        for i in range(len(r)):
            if r[i] >= n_rows:           # the sentinel of an invalid row
                continue
            for k in range(len(c[i])):
                pair = (r[i], c[i][k]) if users_are_rows else (c[i][k], r[i])
                assert kept[i][k] == (pair not in batch), (pair, i, k)
                removed += pair in batch
    assert len(calls) == 2 * 2 and removed > 0


def test_json_contract_on_both_routes():
    kw = dict(users=600, items=400, edges=8000, iters=2, batch=64, scan=1,
              holdout=1000)
    built = beyond_hbm.build_graph(kw["users"], kw["items"], kw["edges"], 7,
                                   kw["holdout"], log=lambda *a: None)
    it = built[0]
    assert it.valid_node_pairs.shape[1] == it.test_node_pairs.shape[1] == 500
    jax_keys = {"metric", "graph", "bitdense_layout_gb", "full_graph_possible",
                "plan_device", "scan_steps", "steps_per_s", "ms_per_step",
                "rating_pairs_per_s", "loss_first10", "loss_last10",
                "loss_decreased", "valid_rmse", "graph_build_s",
                "trainer_setup_s", "frontier_caps", "dedup_regime",
                "remove_rating"}
    port_keys = {"first_step_s", "card", "card_memory_gb", "peak_step_gib",
                 "host_peak_rss_gib", "full_graph_bytes", "launches",
                 "overflow_steps", "id_product", "probed_caps"}
    for route in ("host", "device"):
        out = beyond_hbm.run(**kw, plan_device=route == "device",
                             device="cpu", built=built, log=lambda *a: None)
        assert jax_keys | port_keys <= set(out)
        assert "compile_s" not in out and "hbm_gb" not in out
        assert out["plan_device"] == (route == "device")
        assert out["backend"] == ("xla" if route == "device" else "pallas")
        assert out["graph"] == "600x400, 8000 edges, 10 levels"
        assert out["card"] is None and out["full_graph_possible"] is None
        assert out["peak_step_gib"] is None
        assert out["losses_finite"] and out["overflow_steps"] == 0
        assert len(out["valid_rmse"]) == 2
        assert all(0.5 <= r <= 5.0 for r in out["valid_rmse"])
        assert out["id_product"] == 600 * 400
        # the CPU route counts no launch
        assert set(out["launches"]) == {"ell_spmm_fwd_only",
                                        "ell_spmm_transpose", "ell_sddmm"}
        assert ("feed_mb" in out) == (route == "device")


@pytest.mark.parametrize("caps,needed,want", [
    # the full-scale device route: the item cap 74,240 passes 50,000 items
    # while the probed frontier (cap / 1.6) does not
    ({"user": 251_904, "item": 74_240}, {"user": 157_440, "item": 46_400},
     {"user": 251_904, "item": 49_920}),
    # a need at or past the largest cap below the count keeps the cap
    ({"user": 251_904, "item": 57_600}, {"user": 157_440, "item": 49_920},
     {"user": 251_904, "item": 57_600}),
    # a cap past the user count too, the need below it
    ({"user": 460_800, "item": 40_960}, {"user": 344_045, "item": 25_600},
     {"user": 399_872, "item": 40_960}),
])
def test_dedup_caps_stay_below_the_counts_where_the_need_does(caps, needed,
                                                              want):
    nodes = {"user": 400_000, "item": 50_000}
    got = beyond_hbm.dedup_caps(caps, nodes, needed)
    assert got == want
    for t in got:
        assert got[t] % 256 == 0
        assert (got[t] < nodes[t]) == (needed[t] < (nodes[t] - 1) // 256
                                       * 256 or caps[t] < nodes[t])


def test_full_graph_arithmetic_at_the_jax_scale():
    """400,000 x 50,000, 50M edges, 10 levels: a bit layout is R Nu Ni / 8
    (25 GB, padded), two a variant; the train variant alone fits an 80 GB
    card, train and test do not; bf16 dense never does; the edge-sized
    operands do."""
    fg = beyond_hbm.full_graph_bytes(400_000, 50_000, 10, 50_000_000)
    layout = 10 * 400_000 * 50_000 / 8
    assert 2 * layout <= fg["bitdense"]["train"] < 2 * layout * 1.01
    assert fg["bitdense"]["train_and_eval"] == 2 * fg["bitdense"]["train"]
    assert fg["dense"]["train"] == 2 * 10 * 400_000 * 50_000
    e_pad = -(-50_000_000 // 256) * 256
    # four shared edge arrays (no pair lookup past int32) + a mask and
    # the degrees a variant
    assert fg["xla"]["train"] == 4 * 4 * e_pad + 4 * e_pad + 4 * 450_000
    assert fg["ell"]["train"] < 2e9
    possible = beyond_hbm.full_graph_possible(fg, 80e9)
    assert possible["bitdense"] == {"train": True, "train_and_eval": False}
    assert possible["dense"] == {"train": False, "train_and_eval": False}
    assert possible["xla"] == possible["ell"] == {"train": True,
                                                  "train_and_eval": True}


def test_a_cap_at_the_node_count_samples_every_node():
    """A property of both packages' device planners that the full-scale run
    met: a frontier cap at (or past) its type's node count takes the dense
    path, which samples the neighbours of EVERY node of that type, so the
    other type's frontier needs far more than under a cap one below the
    count (the dedup path), for the same batch and draws.  At 400,000 x
    50,000 the item cap that the trainer's rule (1.6 times the probed
    frontier) gives passes 50,000, and the users' need grew from 251,904
    probed to 344,045 (PERF.md section 6); the twin's ``dedup_caps`` keeps
    it below."""
    jg, tg = graphs(4000, 300, 20_000, 3)
    csr = tg["user", "movie"]
    pairs = csr.node_pair_ids
    sel = np.random.RandomState(0).choice(pairs.shape[1], 16, replace=False)
    pu = pairs[0, sel].astype(np.int32)
    pi = pairs[1, sel].astype(np.int32)
    pair = cfgs(4000, 300)
    need = {}
    for item_cap in (300, 299):
        caps = {"user": 3000, "item": item_cap}
        jout, tout = both_plans(jg, tg, pair, pu, pi, caps, 2, True)
        assert_plans_equal(jout, tout, caps, dict(user=4000, item=300))
        assert not bool(tout[2]["overflow"])
        assert tout[2]["identity"]["item"] == (item_cap == 300)
        need[item_cap] = int(tout[2]["needed_user"])
    assert need[300] > 4 * need[299] > 0
