"""The crossover sweep (``stargcn_tpu_torch/probes/ell_crossover_sweep.py``)
and the card's ``auto`` table (``train/sampled_loop.py:
resolve_sampled_backend``), on the CPU.

The sweep's rows are checked for their structure at a tiny grid through
the plain versions (the wrappers' CPU route); each point's two
formulations are held against the JAX script's
(``scripts/sweep_pallas_crossover.py``): its ``xla`` gather and its
gradient computed by ``jnp``, and the JAX package's Pallas ``ell_spmm`` in
interpret mode, on the same ``RandomState(0)`` inputs, within 1e-5.  The
table is checked in both columns, with ``plan_device`` and on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stargcn_tpu.ops import pallas_kernels as jpallas
from stargcn_tpu_torch.ops import ell_kernels as ek
from stargcn_tpu_torch.probes import ell_crossover_sweep as sweep
from stargcn_tpu_torch.train import sampled_loop as tsl
from stargcn_tpu_torch.train.sampled_loop import resolve_sampled_backend

TINY_GRID = ((64,), (4, 8), (8, 16))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def test_pool_rows_structure():
    rows = sweep.pool_rows(TINY_GRID, "cpu", log=lambda line: None)
    assert [(r["D"], r["K"], r["F"]) for r in rows] == [
        (64, k, f) for k in (4, 8) for f in (8, 16)]
    for r in rows:
        assert r["S"] == r["D"] and "error" not in r
        # on the CPU the wrappers are their plain versions
        assert r["max_abs_err"] == {"ell_spmm_fwd_only": 0.0,
                                    "ell_spmm_transpose": 0.0}
        for kind in ("fwd", "fb"):
            for route in ("pallas", "xla"):
                assert r[f"{route}_{kind}_ms"] > 0
                assert r[f"{route}_{kind}_spread_ms"] >= 0
            assert r[f"{kind}_speedup"] == pytest.approx(
                r[f"xla_{kind}_ms"] / r[f"pallas_{kind}_ms"])
            assert r[f"{kind}_winner"] in ("pallas", "xla", "tie")
    out = sweep.summary(rows, [], "cpu")
    assert out["clock"] == "host" and out["errors"] == []
    assert "card" not in out


@pytest.mark.parametrize("K,F", [(4, 8), (8, 16)])
def test_point_formulations_match_the_jax_script(K, F):
    """The two pools of a point and their values gradients against the JAX
    script's on the same inputs."""
    D = 64
    vals, idx, w, cot = sweep.point_inputs(D, K, F, "cpu")
    rng = np.random.RandomState(0)
    assert np.array_equal(idx.numpy(), rng.randint(0, D, size=(D, K)))
    jv, ji, jw, jc = (jnp.asarray(t.numpy()) for t in (vals, idx, w, cot))

    def jax_xla(v):
        return (jw[..., None] * jnp.take(v, ji, axis=0)).sum(1)

    def jax_pallas(v):
        return jpallas.ell_spmm(v, ji, jw, True)

    for jfn, tfn in ((jax_xla, sweep._gather_pool), (jax_pallas, ek.ell_spmm)):
        np.testing.assert_allclose(tfn(vals, idx, w).numpy(),
                                   np.asarray(jfn(jv)), **TOL)
        jgrad = jax.grad(lambda v: (jfn(v) * jc).sum())(jv)
        v = vals.clone().requires_grad_(True)
        tgrad, = torch.autograd.grad((tfn(v, idx, w) * cot).sum(), v)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)


def test_a_point_out_of_memory_is_written_down(monkeypatch):
    def oom(*a):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(ek, "ell_spmm_fwd_only", oom)
    row = sweep.pool_point(64, 4, 8, "cpu")
    assert row["error"].startswith("OutOfMemoryError")
    assert "pallas_fwd_ms" not in row

    def bad(*a):
        raise ValueError("not a memory error")

    monkeypatch.setattr(ek, "ell_spmm_fwd_only", bad)
    with pytest.raises(ValueError):
        sweep.pool_point(64, 4, 8, "cpu")


@pytest.mark.parametrize("p,ps,x,xs,want", [
    (1.0, 0.1, 1.5, 0.2, "pallas"), (1.5, 0.1, 1.0, 0.1, "xla"),
    (1.0, 0.3, 1.2, 0.1, "tie"), (1.0, 0.0, 1.0, 0.0, "tie")])
def test_winner_needs_more_than_the_spread(p, ps, x, xs, want):
    assert sweep.winner(p, ps, x, xs) == want


def test_model_row_times_both_backends_on_one_plan():
    cfg, it, model_cfg = sweep.build_cell("ml-1m", num_users=60,
                                          num_items=40, num_edges=900)
    row = sweep.model_row("tiny", cfg, it, model_cfg, 4, "cpu", batch=64,
                          recon=16)
    assert row["cell"] == "tiny" and row["fanout"] == 4
    assert row["d_max"] == max(row["caps"].values())
    assert row["nodes"] == [60, 40] and row["num_links"] == 5
    # the two backends compute one function
    assert row["fwd_sq_err_rel_diff"] < 1e-4
    for what in ("fwd", "step"):
        for backend in ("pallas", "xla"):
            assert row[f"{backend}_{what}_ms"] > 0
        assert row[f"{what}_winner"] in ("pallas", "xla", "tie")


# ------------------------------ the table --------------------------------

ML1M_CAPS = {"user": 9984, "item": 6144}
ML10M_K16_CAPS = {"user": 107264, "item": 17408}


@pytest.mark.parametrize("for_training", [True, False])
def test_table_columns_follow_the_measured_windows(for_training):
    """Each column picks ``pallas`` exactly inside its ``PALLAS_WINDOWS`` on
    the card, at and around each window's edges."""
    kw = dict(for_training=for_training, device="cuda")
    windows = tsl.PALLAS_WINDOWS["training" if for_training else "forward"]
    for (lo, hi), (k_lo, k_hi) in windows:
        for d in (lo, hi):
            for k in (k_lo, k_hi):
                caps = {"user": max(d, 1), "item": 1}
                assert resolve_sampled_backend("auto", caps, k,
                                               **kw) == "pallas"
        outside = [({"user": hi + 256, "item": 1}, k_lo),
                   ({"user": max(lo, 1), "item": 1}, k_hi + 1),
                   ({"user": max(lo, 1), "item": 1}, k_lo - 1)]
        if lo:
            outside.append(({"user": lo - 256, "item": 1}, k_lo))
        for caps, k in outside:
            assert resolve_sampled_backend("auto", caps, k, **kw) == "xla"
    # the largest cap decides, whichever type holds it
    assert resolve_sampled_backend("auto", {"user": 17408, "item": 107264},
                                   16, **kw) == "pallas"


def test_the_columns_differ_only_at_small_caps_and_fanout_8():
    """Forward-only ``pallas`` at ML-1M's caps (the only small cap measured
    to win every run) and fanout 8, where the training step did not win
    every run; the ML-10M windows are shared."""
    train, fwd = (tsl.PALLAS_WINDOWS[k] for k in ("training", "forward"))
    assert set(train) < set(fwd)
    assert set(fwd) - set(train) == {((9984, 9984), (8, 8))}
    # ML-100k's caps (3,072) did not win every run
    assert resolve_sampled_backend("auto", {"user": 1792, "item": 3072}, 8,
                                   for_training=False, device="cuda") == "xla"


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu"])
def test_auto_never_trains_on_pallas_with_plan_device(device):
    for caps in (ML1M_CAPS, ML10M_K16_CAPS):
        for fanout in (4, 8, 16, 32, 64):
            assert resolve_sampled_backend(
                "auto", caps, fanout, device=device,
                plan_device=True) == "xla"


@pytest.mark.parametrize("for_training", [True, False])
def test_auto_on_the_cpu_is_xla(for_training):
    for caps in (ML1M_CAPS, ML10M_K16_CAPS, {}):
        for fanout in (8, 16, 32):
            assert resolve_sampled_backend(
                "auto", caps, fanout, for_training=for_training,
                device="cpu") == "xla"


def test_trainer_with_plan_device_never_reaches_the_refusal(monkeypatch):
    """A ``plan_device`` trainer on ``auto`` whose caps lie in a forward
    window: training resolves to ``xla`` (no refusal), evaluation to
    ``pallas``; a trainer without ``plan_device`` in a window of both
    columns resolves both to ``pallas``.  The CPU is read as the card for
    the resolution alone."""
    from _torch_slice import sampled_cfgs, sampled_graphs, sampled_iterator
    from stargcn_tpu_torch.data import DataIterator
    from stargcn_tpu_torch.train import SampledTrainer, TrainSettings

    real = tsl.resolve_sampled_backend
    monkeypatch.setattr(tsl, "resolve_sampled_backend",
                        lambda *a, **kw: real(*a, **dict(kw, device="cuda")))
    _, tg = sampled_graphs()
    t = SampledTrainer(sampled_cfgs()[1], sampled_iterator(DataIterator, tg),
                       TrainSettings(rating_batch_size=24,
                                     recon_batch_size=8),
                       fanout=8, backend="auto", device="cpu",
                       plan_device=True, frontier_caps=ML1M_CAPS)
    assert (t.backend, t.eval_backend) == ("xla", "pallas")
    # without plan_device the same caps train on xla too (the step's column)
    t = SampledTrainer(sampled_cfgs()[1], sampled_iterator(DataIterator, tg),
                       TrainSettings(rating_batch_size=24,
                                     recon_batch_size=8),
                       fanout=16, backend="auto", device="cpu",
                       frontier_caps=ML10M_K16_CAPS)
    assert (t.backend, t.eval_backend) == ("pallas", "pallas")
    with pytest.raises(NotImplementedError):
        SampledTrainer(sampled_cfgs()[1], sampled_iterator(DataIterator, tg),
                       TrainSettings(rating_batch_size=24,
                                     recon_batch_size=8),
                       fanout=8, backend="pallas", device="cpu",
                       plan_device=True, frontier_caps=ML1M_CAPS)


def test_no_caps_resolve_to_xla():
    assert resolve_sampled_backend("auto", {}, 8, device="cuda") == "xla"
