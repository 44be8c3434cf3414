"""The port's device planner (``stargcn_tpu_torch/graph/device_sampling.py``)
against the JAX package's (``stargcn_tpu/graph/device_sampling.py``), on
the CPU.

The two draw from different RNG streams, so the port's ``DevicePlanner``
takes its uniforms as an argument: fed the JAX package's own uniforms (the
same key splits) it must build the same plan, array for array (weights
within 1e-6: ``rsqrt`` may differ in the last bit), on the dense and the
dedup path, with REMOVE_RATING on and off, in each of the JAX package's
three exclusion regimes (forced by ``monkeypatch`` on its two budget
constants; the port keeps one exact formulation).  At ``fanout >= max
degree`` the draws do not matter.  With the port's own draws the plan is
held in distribution.  Forward and gradient tolerances are those of
``tests/test_torch_sampled.py``: outputs 2e-4, gradients 1e-4 of each
parameter tensor's largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_slice import (build_sampled_trainers, random_params,
                          reference_on_cpu, sampled_batches, sampled_cfgs,
                          sampled_graphs, sampled_iterator)
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.graph import device_sampling as jds
from stargcn_tpu.graph.device import BipartiteGraphData
from stargcn_tpu.models import STARGCN as JSTARGCN
from stargcn_tpu.models import STARGCNConfig as JSTARGCNConfig
from stargcn_tpu.models import sampled as jsm
from stargcn_tpu.train import sampled_loop as jsl
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.graph import device_sampling as tds
from stargcn_tpu_torch.models import STARGCN, STARGCNConfig
from stargcn_tpu_torch.models import sampled as tsm
from stargcn_tpu_torch.train import SampledTrainer, TrainSettings
from stargcn_tpu_torch.train import sampled_loop as tsl

OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 1e-4
STATS = ("loss", "gnorm", "rating_loss", "recon_loss", "sq_err")
RECON_U = np.array([3, 5, -1, -1], np.int32)
RECON_I = np.array([2, 7, 9, -1], np.int32)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads (see ``tests/test_torch_dense_xla.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def jax_uniforms(key):
    """``uniform(shape)`` giving the port's planner the uniforms the JAX
    planner draws from ``key``: one ``split(key, 3)`` per level, the user
    draw from the second key and the item draw from the third."""
    state = {"key": key, "keys": []}

    def uniform(shape):
        if not state["keys"]:
            state["key"], ku, ki = jax.random.split(state["key"], 3)
            state["keys"] = [ku, ki]
        return t(jax.random.uniform(state["keys"].pop(0), shape))

    return uniform


def graphs(num_users, num_items, num_edges, seed):
    kw = dict(num_users=num_users, num_items=num_items, num_edges=num_edges,
              rating_values=(1, 2, 3), seed=seed)
    return jsyn.synthetic_graph(**kw), tsyn.synthetic_graph(**kw)


def cfgs(num_users, num_items, **kw):
    kw = dict(num_users=num_users, num_items=num_items, num_links=3,
              nblocks=2, embed_units=8, agg_units=(12,), out_units=(10,),
              gcn_dropout=0.0, gen_rating_mid_map=6, agg_accum="sum", **kw)
    return JSTARGCNConfig(**kw), STARGCNConfig(**kw)


def max_degree(g):
    csr = g["user", "movie"]
    return int(max(np.diff(csr.ind_ptr).max(), np.diff(csr.T.ind_ptr).max()))


def jax_plan(jg, jcfg, pu, pi, caps, fanout, exclude, key=7,
             recon=(RECON_U, RECON_I)):
    """The JAX package's ``(plan, pairs_pos, aux)`` of one batch."""
    tab = jds.DeviceGraphTables.build(jg, "user", "movie")
    planner = jds.DevicePlanner(jcfg, caps, fanout, symm=jcfg.agg_norm_symm)
    # one compiled program: cheaper on the CPU than the ops one by one
    def build(*a):
        plan, pairs_pos, aux = planner.build(*a, exclude=exclude)
        del aux["identity"]              # static, not an array
        return plan, pairs_pos, aux

    plan, pairs_pos, aux = jax.jit(build)(
        tab, jax.random.PRNGKey(key),
        jnp.take(tab.id2ind["user"], jnp.asarray(pu)),
        jnp.take(tab.id2ind["item"], jnp.asarray(pi)),
        jnp.ones(len(pu), jnp.float32), jnp.asarray(recon[0]),
        jnp.asarray(recon[1]))
    aux["identity"] = {t_: bool(min(caps[t_], tab.n[t_]) >= tab.n[t_])
                       and bool(tab.ids_iota[i])
                       for i, t_ in enumerate(("user", "item"))}
    return plan, pairs_pos, aux


def port_plan(tg, tcfg, pu, pi, caps, fanout, exclude, key=7,
              recon=(RECON_U, RECON_I)):
    """The port's ``(plan, pairs_pos, aux)`` of the same batch, fed the
    JAX package's uniforms for ``key``."""
    tab = tds.DeviceGraphTables.build(tg, "user", "movie", "cpu")
    return tds.DevicePlanner(tcfg, caps, fanout, symm=tcfg.agg_norm_symm
                             ).build(
        tab, jax_uniforms(jax.random.PRNGKey(key)),
        tab.id2ind["user"][t(pu).long()], tab.id2ind["item"][t(pi).long()],
        torch.ones(len(pu)), t(recon[0]), t(recon[1]), exclude=exclude)


def both_plans(jg, tg, cfg_pair, *args, **kw):
    return (jax_plan(jg, cfg_pair[0], *args, **kw),
            port_plan(tg, cfg_pair[1], *args, **kw))


def assert_trees_equal(got, want, path="plan"):
    """Every array equal (float arrays within 1e-6), the same structure."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    else:
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape, path
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def reencode(jplan, caps, n):
    """The JAX plan with each block's combined index ``rating * c + pos``
    (``c`` = the source type's clamped cap) re-encoded as ``rating *
    len(source level) + pos``, the host plans' contract that the port keeps
    and that both packages' forwards decode; and how many blocks changed.
    The two differ only where a level is shorter than its cap
    (``test_short_levels_keep_the_host_index_contract``)."""
    other = {"user": "item", "item": "user"}
    blocks_out, changed = [], 0
    for b, blocks in enumerate(jplan["blocks"]):
        out = []
        for li, lvl in enumerate(blocks):
            new = {}
            for t_, o in other.items():
                n_src = (np.asarray(jplan["frontiers"][b][o]).shape[0]
                         if li == 0 else np.asarray(blocks[li - 1][o]["idx"]
                                                    ).shape[0])
                c = min(caps[o], n[o])
                idx = np.asarray(lvl[t_]["idx"])
                changed += int(n_src != c)
                new[t_] = dict(lvl[t_], idx=idx // c * n_src + idx % c)
            out.append(new)
        blocks_out.append(out)
    return dict(jplan, blocks=blocks_out), changed


def assert_plans_equal(jout, tout, caps, n):
    """Every array of the port's plan equals the JAX package's (indices
    re-encoded by ``reencode``); returns the count of re-encoded blocks."""
    (jp, jpp, jaux), (tp, tpp, taux) = jout, tout
    jp, changed = reencode(jp, caps, n)
    assert_trees_equal(tp, jp)
    assert_trees_equal(tpp, jpp, "pairs_pos")
    for k in ("needed_user", "needed_item", "overflow"):
        assert int(taux[k]) == int(jaux[k]), k
    assert taux["identity"] == jaux["identity"]
    return changed


def live_slots(plan):
    """Slots of positive weight: the exclusion zeroes the batch's own
    edges (the removal-adjusted supports of the rest grow)."""
    return sum(int((lvl[t]["weight"] > 0).sum()) for blocks in plan["blocks"]
               for lvl in blocks for t in ("user", "item"))


# ------------------------------ helpers --------------------------------


def test_capped_unique_and_positions():
    rng = np.random.RandomState(0)
    for trial in range(3):
        n = int(rng.randint(5, 60))
        x = rng.randint(0, n + 1, size=int(rng.randint(1, 80))).astype(
            np.int32)
        x[rng.rand(x.size) < 0.2] = n                 # sentinels
        for cap in (3, n + 4):             # the first cuts the tail
            ju, jn = jds._capped_unique(jnp.asarray(x), cap, n)
            tu, tn = tds._capped_unique(t(x), cap, n)
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
            assert int(tn) == int(jn)
            q = rng.randint(-2, n + 3, size=(7, 3)).astype(np.int32)
            qv = rng.rand(7, 3) < 0.8
            for valid in (None, qv):
                jpos, jok = jds._positions(
                    ju, n, jnp.asarray(q),
                    None if valid is None else jnp.asarray(valid))
                tpos, tok = tds._positions(
                    tu, n, t(q), None if valid is None else t(valid))
                np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
                np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # needed > cap: the count of distinct real values, the tail cut
    u, n = tds._capped_unique(t(np.array([5, 3, 5, 9, 9, 7, 3], np.int32)),
                              2, 99)
    assert int(n) == 4 and u.tolist() == [3, 5]


@pytest.mark.parametrize("remap", [False, True])
def test_graph_tables_match_jax(remap):
    jg, tg = graphs(30, 22, 260, 2)
    if remap:
        # a subgraph keeps its parents' ids: rows are no longer 0..n-1
        keep_u = np.arange(0, 30, 2)
        jg = jg.sel_subgraph_by_id("user", keep_u)
        tg = tg.sel_subgraph_by_id("user", keep_u)
    jtab = jds.DeviceGraphTables.build(jg, "user", "movie")
    ttab = tds.DeviceGraphTables.build(tg, "user", "movie", "cpu")
    assert ttab.ids_iota == jtab.ids_iota == ((False, True) if remap
                                              else (True, True))
    assert ttab.n == jtab.n
    for f in dataclasses.fields(jtab):
        if f.name == "ids_iota":
            continue
        for side in ("user", "item"):
            got = getattr(ttab, f.name)[side]
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jtab, f.name)[side]),
                err_msg=f"{f.name}.{side}")


# ------------------------------- plans ---------------------------------


@pytest.fixture(scope="module")
def small():
    """The 30 x 22 graph of the JAX package's tests: both types dense
    under caps of 64."""
    jg, tg = graphs(30, 22, 260, 2)
    rng = np.random.RandomState(1)
    pu = rng.randint(0, 30, 12).astype(np.int32)
    pi = rng.randint(0, 22, 12).astype(np.int32)
    return jg, tg, pu, pi


@pytest.fixture(scope="module")
def wide():
    """A 200 x 150 graph under caps below the node counts: the dedup
    path."""
    jg, tg = graphs(200, 150, 600, 9)
    rng = np.random.RandomState(1)
    pu = rng.randint(0, 200, 8).astype(np.int32)
    pi = rng.randint(0, 150, 8).astype(np.int32)
    return jg, tg, pu, pi


# (path, JAX exclusion regime, exclusion, draws).  The regime is forced
# through the JAX package's budgets (None: its own choice, the one-hot
# product on the dense path and the slot-space product on the dedup path);
# the dense path reaches all three regimes, the dedup path the last two.
CASES = ([(path, None, exclude, draws) for path in ("dense", "dedup")
          for exclude in (False, True) for draws in ("full", "injected")]
         + [("dense", "slot", True, "injected"),
            ("dense", "ranktab", True, "injected"),
            ("dedup", "ranktab", True, "injected")])


def force_regime(monkeypatch, regime):
    if regime in ("slot", "ranktab"):
        monkeypatch.setattr(jds, "EXCLUDE_ONEHOT_MAX_ELEMS", 0)
    if regime == "ranktab":
        monkeypatch.setattr(jds, "EXCLUDE_SLOT_ONEHOT_MAX_ELEMS", 0)


@pytest.mark.parametrize("path,regime,exclude,draws", CASES)
def test_plans_equal_jax(small, wide, monkeypatch, path, regime, exclude,
                         draws):
    """At full fanout, and at fanout 2 with the JAX package's uniforms,
    every array of the plan equals the JAX package's, and with exclusion
    the keep-mask of each JAX regime (the weights carry it)."""
    force_regime(monkeypatch, regime)
    jg, tg, pu, pi = small if path == "dense" else wide
    n = (30, 22) if path == "dense" else (200, 150)
    caps = ({"user": 64, "item": 64} if path == "dense"
            else {"user": 192, "item": 144})
    fanout = max_degree(jg) if draws == "full" else 2
    pair = cfgs(*n)
    jout, tout = both_plans(jg, tg, pair, pu, pi, caps, fanout, exclude)
    assert not bool(jout[2]["overflow"])
    if path == "dense":
        assert tout[2]["identity"] == {"user": True, "item": True}
    else:
        assert 0 < int(tout[2]["needed_user"]) <= 192
    assert_plans_equal(jout, tout, caps, dict(zip(("user", "item"), n)))
    if exclude:
        # the exclusion fired: the same draws without it keep more slots
        plain = port_plan(tg, pair[1], pu, pi, caps, fanout, False)
        assert live_slots(tout[0]) < live_slots(plain[0])


def test_plans_equal_jax_with_overflow(small):
    """Caps below what the batch needs: the same truncated plan, the same
    ``needed`` counts and the overflow flag."""
    jg, tg, pu, pi = small
    jout, tout = both_plans(jg, tg, cfgs(30, 22), pu, pi,
                            {"user": 8, "item": 8}, 3, True)
    assert bool(tout[2]["overflow"]) and bool(jout[2]["overflow"])
    assert int(tout[2]["needed_user"]) > 8 or int(tout[2]["needed_item"]) > 8
    assert_plans_equal(jout, tout, {"user": 8, "item": 8},
                       {"user": 30, "item": 22})


def test_plans_equal_jax_on_remapped_ids(small):
    """Row ids that are not 0..n-1: the identity flags are off and the
    frontier ids come from ``row_ids``."""
    jg, tg, pu, pi = small
    keep_u = np.arange(1, 30)
    jg = jg.sel_subgraph_by_id("user", keep_u)
    tg = tg.sel_subgraph_by_id("user", keep_u)
    pu = np.where(pu == 0, 1, pu).astype(np.int32)
    jout, tout = both_plans(jg, tg, cfgs(30, 22), pu, pi,
                            {"user": 64, "item": 64}, 3, True,
                            recon=(np.array([3, 5, -1], np.int32), RECON_I))
    assert tout[2]["identity"] == {"user": False, "item": True}
    assert_plans_equal(jout, tout, {"user": 64, "item": 64},
                       {"user": 29, "item": 22})


def test_plan_beyond_int32_id_product():
    """60,000 x 50,000 users x items (the id product passes 2^31) builds
    WITH exclusion, equal to the JAX package's plan, and the exclusion
    fires."""
    nu, ni = 60_000, 50_000
    jg, tg = graphs(nu, ni, 5000, 3)
    rng = np.random.RandomState(0)
    pu = rng.randint(0, nu, 64).astype(np.int32)
    pi = rng.randint(0, ni, 64).astype(np.int32)
    jcfg, tcfg = cfgs(nu, ni)
    tcfg = dataclasses.replace(tcfg, nblocks=1)
    pair = (dataclasses.replace(jcfg, nblocks=1), tcfg)
    caps = {"user": 512, "item": 512}
    none = np.full(4, -1, np.int32)
    jout, tout = both_plans(jg, tg, pair, pu, pi, caps, 4, True, key=0,
                            recon=(none, none))
    assert not bool(tout[2]["overflow"])
    # every level here is shorter than its cap of 512
    assert assert_plans_equal(jout, tout, caps, {"user": nu, "item": ni}) > 0
    plain = port_plan(tg, tcfg, pu, pi, caps, 4, False, key=0,
                      recon=(none, none))
    assert live_slots(tout[0]) < live_slots(plain[0])


def test_short_levels_keep_the_host_index_contract(wide):
    """A level shorter than its cap (few targets, small fanout): the port's
    combined index is ``rating * len(source level) + pos``, the contract of
    host plans, and the forward equals the one over the host plan of the
    same neighbourhoods (fanout >= max degree).  The JAX package's plan of
    the same batch encodes with the cap, and its own forward over it reads
    other rows (ROADMAP Queue 3)."""
    jg, tg, pu, pi = wide
    jcfg, tcfg = (dataclasses.replace(c, nblocks=1) for c in cfgs(200, 150))
    caps = {"user": 192, "item": 144}
    fanout = max_degree(tg)
    pu, pi = pu[:2], pi[:2]
    none = (RECON_U[:0], RECON_I[:0])
    plan, pairs_pos, _ = port_plan(tg, tcfg, pu, pi, caps, fanout, False,
                                   recon=none)
    levels = {t_: plan["blocks"][0][0][t_]["idx"].shape[0]
              for t_ in ("user", "item")}
    assert levels["user"] < caps["user"], levels   # the short level
    gd = BipartiteGraphData.from_csr(jg["user", "movie"], pad_multiple=64)
    z = jnp.zeros(4, jnp.int32)
    params = random_params(JSTARGCN(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        gd, gd.edge_pad_mask, jnp.arange(200, dtype=jnp.int32),
        jnp.arange(150, dtype=jnp.int32), z, z, train=False)["params"])
    model = STARGCN(tcfg)
    model.load_state_dict(convert.params_from_flax(params))
    noise = (np.arange(200, dtype=np.int32), np.arange(150, dtype=np.int32))
    host = tsm.StackedPlan.build(tg, tcfg, pu, pi, fanout=fanout).to("cpu")
    with torch.no_grad():
        want = tsm.sampled_forward(model, tcfg, host, t(noise[0]),
                                   t(noise[1]))["pred_ratings"].numpy()
        got = tsm.sampled_forward(model, tcfg, dict(plan, pairs_pos=pairs_pos),
                                  t(noise[0]), t(noise[1]))["pred_ratings"]
    assert np.abs(want).max() > 50 * OUT_TOL["atol"]
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
    jplan, jpp, _ = jax_plan(jg, jcfg, pu, pi, caps, fanout, False,
                             recon=none)
    jgot = np.asarray(jsm.sampled_forward(
        params, jcfg, dict(jplan, pairs_pos=jpp), *map(jnp.asarray, noise))[
        "pred_ratings"])
    assert np.abs(jgot - want).max() > 10 * OUT_TOL["atol"]


def test_own_draws_are_uniform_over_neighbours():
    """The port's own draws: a row of degree d > K takes K neighbours with
    replacement, each neighbour 1/d of the time (within 5 standard
    deviations), with the edge's rating level and support; a row of
    degree <= K takes each neighbour once."""
    _, tg = graphs(30, 22, 260, 2)
    tab = tds.DeviceGraphTables.build(tg, "user", "movie", "cpu")
    reps = 20_000
    deg = tab.row_deg["user"]
    big, small_row = int(deg.argmax()), int(deg.argmin())
    d, K = int(deg[big]), int(deg[small_row])
    assert d > K
    planner = tds.DevicePlanner(cfgs(30, 22)[1], {"user": 64, "item": 64}, K)
    rows = torch.tensor([big] * reps + [small_row], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    nbr, rating, weight, ok = planner._sample_level(
        tab, "user", "item", rows, tds.uniform_from(gen)((reps + 1, K)),
        None)
    ptr = tab.ind_ptr["user"]
    edges = range(int(ptr[big]), int(ptr[big + 1]))
    rating_of = {int(tab.end_points["user"][e]): int(tab.rating_idx["user"][e])
                 for e in edges}
    assert ok[:reps].all()
    counts = np.bincount(nbr[:reps].reshape(-1).numpy(), minlength=22)
    want = reps * K / d
    sd = np.sqrt(reps * K * (1 / d) * (1 - 1 / d))
    for v in rating_of:
        assert abs(counts[v] - want) < 5 * sd, (v, counts[v], want)
    assert counts.sum() == reps * K and set(np.nonzero(counts)[0]) == set(
        rating_of)
    got = [rating_of[v] for v in nbr[:reps].reshape(-1)[:300].tolist()]
    assert rating[:reps].reshape(-1)[:300].tolist() == got
    want_w = torch.rsqrt(float(d) * tab.col_deg["user"][nbr[:reps].long()]
                         .float())
    np.testing.assert_allclose(weight[:reps].numpy(), want_w.numpy(),
                               rtol=1e-6)
    d_small = int(deg[small_row])
    s = int(ptr[small_row])
    assert ok[reps].tolist() == [j < d_small for j in range(K)]
    assert nbr[reps, :d_small].tolist() == tab.end_points["user"][
        s:s + d_small].tolist()
    # a whole plan on the port's own stream: weights finite, non-negative,
    # indices inside their source levels
    rng = np.random.RandomState(1)
    pu = torch.from_numpy(rng.randint(0, 30, 12).astype(np.int32))
    pi = torch.from_numpy(rng.randint(0, 22, 12).astype(np.int32))
    plan, _, aux = planner.build(tab, tds.uniform_from(gen), pu, pi,
                                 torch.ones(12), t(RECON_U), t(RECON_I),
                                 exclude=True)
    for blocks in plan["blocks"]:
        for lvl in blocks:
            for t_, n_src in (("user", 22), ("item", 30)):
                w, idx = lvl[t_]["weight"], lvl[t_]["idx"]
                assert torch.isfinite(w).all() and (w >= 0).all()
                assert (idx >= 0).all() and (idx < 3 * n_src).all()


# ----------------------- sampled forward on device plans ----------------


@pytest.fixture(scope="module")
def forward_case(small):
    """A device plan on the dense path, converted parameters, noise with
    masked rows."""
    jg, tg, pu, pi = small
    jcfg, tcfg = cfgs(30, 22)
    gd = BipartiteGraphData.from_csr(jg["user", "movie"], pad_multiple=64)
    z = jnp.zeros(4, jnp.int32)
    params = random_params(JSTARGCN(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        gd, gd.edge_pad_mask, jnp.arange(30, dtype=jnp.int32),
        jnp.arange(22, dtype=jnp.int32), z, z, train=False)["params"])
    caps = {"user": 64, "item": 64}
    jplan, jpp, jaux = jax_plan(jg, jcfg, pu, pi, caps, 3, True)
    plan, pp, aux = port_plan(tg, tcfg, pu, pi, caps, 3, True)
    noise_u = np.arange(30, dtype=np.int32)
    noise_u[::3] = -1
    noise_i = np.arange(22, dtype=np.int32)
    noise_i[[2, 5]] = -1
    return (jcfg, tcfg, params, dict(jplan, pairs_pos=jpp), jaux,
            dict(plan, pairs_pos=pp), aux, noise_u, noise_i)


def _scalar(out, xp, rng=np.random.RandomState(4)):
    """A random functional of the outputs, so every parameter gets a
    gradient."""
    w = rng.randn(*np.shape(out["pred_ratings"])).astype(np.float32)
    total = xp.sum(out["pred_ratings"] * xp.asarray(w))
    for blk in out["pred_embed"]:
        for key in ("user", "item"):
            total = total + xp.sum(blk[key] ** 2) * 0.01
    return total


def test_identity_frontiers_match_gather_path_and_jax(forward_case):
    """``identity_frontiers`` (the table read as a row mask, cross-block
    features passed through) gives the gather path's outputs and
    gradients, and both give the JAX package's ``sampled_forward`` on its
    own plan of the same draws, with the same flags."""
    (jcfg, tcfg, params, jplan, jaux, plan, aux, noise_u,
     noise_i) = forward_case
    assert aux["identity"] == jaux["identity"] == {"user": True,
                                                   "item": True}
    state = convert.params_from_flax(params)
    model = STARGCN(tcfg)
    model.load_state_dict(state)
    named = dict(model.named_parameters())

    def run(identity):
        out = tsm.sampled_forward(model, tcfg, plan, t(noise_u), t(noise_i),
                                  identity_frontiers=identity)
        loss = _scalar(out, torch, np.random.RandomState(4))
        return out, dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))

    out_i, g_i = run(aux["identity"])
    out_g, g_g = run(None)
    np.testing.assert_allclose(out_i["pred_ratings"].detach().numpy(),
                               out_g["pred_ratings"].detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for k in named:
        np.testing.assert_allclose(g_i[k].numpy(), g_g[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)

    def jloss(p):
        out = jsm.sampled_forward(p, jcfg, jplan, jnp.asarray(noise_u),
                                  jnp.asarray(noise_i),
                                  identity_frontiers=jaux["identity"])
        return _scalar(out, jnp, np.random.RandomState(4)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    np.testing.assert_allclose(out_i["pred_ratings"].detach().numpy(),
                               np.asarray(jout["pred_ratings"]), **OUT_TOL)
    for b in range(tcfg.nblocks):
        for key in ("user", "item"):
            np.testing.assert_allclose(
                out_i["pred_embed"][b][key].detach().numpy(),
                np.asarray(jout["pred_embed"][b][key]), **OUT_TOL)
    want = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(want) == sorted(g_i)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(g_i[k].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(), err_msg=k)


# --------------------- SampledTrainer(plan_device=True) -----------------


@pytest.fixture(scope="module")
def dev_trainers():
    """Both packages' device-planned trainers (dropout 0) over the same
    graph, split, sampler seeds, caps and parameters."""
    with reference_on_cpu():
        return build_sampled_trainers(plan_device=True)


def _state(tr):
    opt = tr.opt.state_dict()
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            opt["count"], {k: v.clone() for k, v in opt["mu"].items()},
            {k: v.clone() for k, v in opt["nu"].items()})


def _assert_state_equal(a, b):
    assert a[1] == b[1]
    for x, y in ((a[0], b[0]), (a[2], b[2]), (a[3], b[3])):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_device_planned_step_matches_jax(dev_trainers):
    """One step's batch equals the JAX trainer's (the cap probe made the
    same draws from the shared stream), and with the JAX package's plan
    draws its loss, statistics and every gradient equal those of the JAX
    package's device-planned step."""
    jtr, ttr = dev_trainers
    assert ttr.caps == jtr.caps and ttr.plan_device
    (jbatch,), (tbatch,) = (sampled_batches(tr, 1) for tr in (jtr, ttr))
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], jbatch[k], err_msg=k)

    ibuf, fbuf, spec = jtr._pack_batch(jbatch)
    jfeed = jsm.unpack_tree(jnp.asarray(ibuf), jnp.asarray(fbuf), spec)
    rng = jax.random.PRNGKey(11)
    caps = (jtr.caps["user"], jtr.caps["item"], jtr.exclude_cap)

    @jax.jit
    def jstep(params):
        dplan, pairs_pos, aux, rng2 = jsl._device_plan_phase(
            jtr, caps, jtr._dev_tables, jfeed, rng)

        def loss(p):
            stats = jsl._loss_update(
                jtr, p, jtr.opt_state, dplan, pairs_pos, jfeed["noise_u"],
                jfeed["noise_i"], jfeed["gt"], jfeed["valid"], rng2,
                identity=aux["identity"])[2]
            return stats["loss"], stats

        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, jstats), jgrads = jstep(jtr.params)
    ttr.plan_uniform = jax_uniforms(jax.random.split(rng)[1])
    feed = ttr._feed(ttr._pack_batch(tbatch))
    plan, pp, aux = ttr._device_plan(feed)
    assert not bool(aux["overflow"])
    stats, grads = tsl._loss_and_grads(
        ttr, dict(feed, plan=dict(plan, pairs_pos=pp)),
        identity=aux["identity"])
    for name in ("loss", "rating_loss", "recon_loss", "sq_err"):
        np.testing.assert_allclose(stats[name].numpy(),
                                   np.asarray(jstats[name]), rtol=1e-4,
                                   err_msg=name)
    want = convert.params_from_flax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(), err_msg=k)


def _dev_trainer(**kw):
    _, tg = sampled_graphs()
    kw = {"fanout": 3, "device": "cpu", "plan_device": True, **kw}
    s = TrainSettings(rating_batch_size=24, recon_batch_size=8, max_iter=8,
                      log_interval=4, valid_interval=8, lr=1e-2, seed=3,
                      remove_rating=True)
    return SampledTrainer(sampled_cfgs(gcn_dropout=0.1)[1],
                          sampled_iterator(DataIterator, tg), s, **kw)


def test_overflow_rejects_the_update_and_fit_grows_the_caps():
    """A step whose frontiers overflow the caps leaves the parameters and
    the optimiser state bit-equal and reports gnorm 0 and what it needed;
    ``fit`` grows the caps at its next log line and goes on."""
    tr = _dev_trainer()
    rs = tr.data_iter.rating_sampler(batch_size=tr.train_batch,
                                     segment="train")
    recon = tr.data_iter.recon_nodes_sampler(batch_size=8)
    tr.train_iteration(tr._make_batch(rs, recon))
    before = _state(tr)
    tr.caps = {"user": 8, "item": 8}
    stats = tr.train_iteration(tr._make_batch(rs, recon))
    assert bool(stats["overflow"]) and float(stats["gnorm"]) == 0.0
    assert max(int(stats["needed_user"]), int(stats["needed_item"])) > 8
    for k in ("sq_err", "rating_loss", "recon_loss"):
        assert float(stats[k].abs().sum()) == 0.0, k
    _assert_state_equal(_state(tr), before)
    assert tr.opt.count == 1
    lines = []
    res = tr.fit(max_iter=8, log=lines.append)
    assert np.isfinite(res["best_valid_rmse"])
    assert any("skipped on frontier-cap overflow" in ln for ln in lines)
    assert min(tr.caps.values()) > 8


def test_train_chunk_equals_single_iterations():
    a, b = _dev_trainer(), _dev_trainer()
    batches = [sampled_batches(tr, 3) for tr in (a, b)]
    for x, y in zip(*batches):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    steps = [a.train_iteration(x) for x in batches[0]]
    chunk = b.train_chunk(batches[1])
    for name in STATS:
        np.testing.assert_allclose(
            chunk[name].numpy(), torch.stack([s[name] for s in steps]).numpy(),
            rtol=1e-6, atol=1e-7, err_msg=name)
    _assert_state_equal(_state(a), _state(b))


def test_plan_device_refuses_pallas():
    with pytest.raises(NotImplementedError, match="plan_device"):
        _dev_trainer(backend="pallas")


def test_clip_adam_keep_applies_or_rejects_an_update():
    """``ClipAdam.step(keep=)``: a kept update is the host step's (the bias
    correction from a count on the device), a rejected one changes no
    parameter, moment or count; ``count`` reads the device count."""
    from stargcn_tpu_torch.train.loop import ClipAdam

    gen = torch.Generator().manual_seed(0)
    params = [{"w": torch.randn(5, 3, generator=gen),
               "b": torch.randn(3, generator=gen)} for _ in range(2)]
    params[1] = {k: v.clone() for k, v in params[0].items()}
    host = ClipAdam(params[0], lr=0.01, grad_clip=1.0, wd=0.01)
    dev = ClipAdam(params[1], lr=0.01, grad_clip=1.0, wd=0.01)
    for step in range(4):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params[0].items()}
        if step == 2:
            before = {k: v.clone() for k, v in params[1].items()}
            moments = {k: v.clone() for k, v in dev.mu.items()}
            dev.step(grads, keep=torch.tensor(False))
            for k in before:
                assert torch.equal(params[1][k], before[k])
                assert torch.equal(dev.mu[k], moments[k])
            assert dev.count == 2
            continue
        host.step(grads)
        dev.step(grads, keep=torch.tensor(True))
    assert host.count == dev.count == 3
    for k in params[0]:
        np.testing.assert_allclose(params[1][k].numpy(), params[0][k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert dev.state_dict()["count"] == 3
