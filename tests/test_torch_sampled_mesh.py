"""The sampled trainer on a device mesh (``SampledTrainer(mesh=)``,
``sampled_forward(row_sharding=)``): one step at 2 x 1, 1 x 2 and 2 x 2,
on ``xla`` and ``pallas`` (the plain pools on the CPU), in spawned gloo
ranks, held against the JAX package's ``SampledTrainer(mesh=make_mesh(d,
m))`` on its virtual CPU devices and against the port's step in one
process, from the same parameters and the same batch and plan.

Tolerances are ``tests/test_sampled_parallel.py:80-93``'s: loss and
``sq_err`` within rtol 1e-4, parameters after the step within rtol 5e-4
/ atol 5e-5; each rank's gradients against one process's within rtol
1e-4.  The frontier caps are the node counts (48, 40), so every 'data'
rank pools real rows (the default caps of 256 would leave them all on
the first).  A conjugate pair the wrong way round (``enter`` swapped for
the identity) gives gradients off by a factor of the axis and fails the
same comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
import _torch_sampled_mesh_ranks as S
from _torch_mesh_ref import LOSS_TOL, PARAM_TOL, assert_params_close
from _torch_slice import random_params, reference_on_cpu, seed_planners
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data.synthetic import synthetic_graph as jsynthetic_graph
from stargcn_tpu.models import STARGCNConfig as JSTARGCNConfig
from stargcn_tpu.parallel import make_mesh as jmake_mesh
from stargcn_tpu.train.loop import TrainSettings as JTrainSettings
from stargcn_tpu.train.sampled_loop import SampledTrainer as JSampledTrainer
from stargcn_tpu_torch import convert

CAPS = {"user": 48, "item": 40}
BACKENDS = ("xla", "pallas")
CASES = [(b, shape) for b in BACKENDS for shape in S.MESHES]
IDS = [f"{b}-{d}x{m}" for b, (d, m) in CASES]
# The other model options on 2 x 2 against one process: (name, backend,
# model overrides, trainer keywords, bf16 bounds).  On xla in bf16 the
# ranks' partial cotangents of the source rows are rounded to bf16 before
# their sum (models/sampled.py), unlike one process's whole cotangent:
# its gradients are held to 1e-3 of each parameter's largest entry (8.4e-5
# read on the CPU on this set-up) and the parameters after Adam's step to PR 13's
# bf16 bound, 3e-2 of the largest.  On pallas the rows are summed in
# float32, and every other case is held to the float32 tolerances.
OPTIONS = (
    ("remat", "xla", {"gcn_dropout": 0.3}, {"remat": True}, None),
    ("recurrent", "pallas", {"use_recurrent": True,
                             "gcn_use_recurrent": True}, {}, None),
    ("bf16-pallas", "pallas", {"compute_dtype": "bfloat16"}, {}, None),
    ("bf16-xla", "xla", {"compute_dtype": "bfloat16"}, {}, (1e-3, 3e-2)))

def jax_trainer(backend, params=None, mesh_shape=None):
    """The JAX package's ``SampledTrainer`` of the set-up, with ``params``
    (None: its own)."""
    it = S.iterator(JDataIterator, jsynthetic_graph)
    mesh = None if mesh_shape is None else jmake_mesh(*mesh_shape)
    t = JSampledTrainer(S.model_cfg(JSTARGCNConfig, it), it,
                        JTrainSettings(**S.SETTINGS), fanout=S.FANOUT,
                        backend=backend, frontier_caps=CAPS, mesh=mesh)
    if params is not None:
        # A copy of its own: the JAX step donates its parameters.
        params = jax.tree.map(jnp.asarray, params)
        t.params = (params if t.shardings is None
                    else t.shardings.place_params(params))
        t.opt_state = t.opt.init(t.params)
    return t


def _stats(stats):
    return {k: np.asarray(v) for k, v in jax.device_get(stats).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's step in the port's ranks (one spawn of four, running
    while this process builds the rest), in one port process and in the
    JAX package, from one batch and plan."""
    tmp = tmp_path_factory.mktemp("sampled_mesh")
    out = {"jax": {}, "single": {}, "ranks": {}}
    with reference_on_cpu():
        jt = jax_trainer("xla")
        params = jax.device_get(random_params(jt.params))
        state = convert.params_from_flax(params)
        ckpt = {"caps": CAPS}
        single = {}
        for name, backend, model, kw in (
                [(b, b, None, {}) for b in BACKENDS]
                + [o[:4] for o in OPTIONS]):
            t = S.port_trainer(backend, caps=CAPS, model=model, **kw)
            if not (model or {}).get("use_recurrent"):
                t.model.load_state_dict(state)
            t.save_dir = str(tmp / name)
            ckpt[name] = t.save_checkpoint("init")
            single[name] = t
        seed_planners(7)
        batch = S.batches(single["xla"], 1)[0]
        cases = ([(f"{b}_{d}x{m}", b, (d, m), None, False, {})
                  for b, (d, m) in CASES]
                 + [("swap", "xla", (2, 1), None, True, {})]
                 + [(name, b, (2, 2), model, False, kw)
                    for name, b, model, kw, _ in OPTIONS])
        for name, backend, *_ in cases:
            ckpt.setdefault(name, ckpt[backend])
        ranks = R.start(S.step_ranks, 4, tmp, cases, ckpt, batch, str(tmp))
        try:
            for name, t in single.items():
                out["single"][name] = S.step_found(t, batch)
            it = jt.data_iter
            seed_planners(7)
            jbatch = jt._make_batch(
                it.rating_sampler(batch_size=jt.train_batch,
                                  segment="train"),
                it.recon_nodes_sampler(batch_size=jt.s.recon_batch_size))
            for backend, shape in CASES:
                jm = jax_trainer(backend, params, shape)
                out["jax"][(backend, shape)] = {
                    "stats": _stats(jm.train_iteration(jbatch)),
                    "params": convert.params_from_flax(
                        jax.device_get(jm.params))}
        finally:
            ranks.wait()
    for name, _, (d, m), *_ in cases:
        out["ranks"][name] = [torch.load(tmp / f"{name}_r{r}.pt",
                                         weights_only=False)
                              for r in range(d * m)]
    return out


def _close_to_largest(got, want, rel):
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=k)


def against_single(got, want, bf16=None):
    for k in ("loss", "sq_err", "rating_loss", "recon_loss", "gnorm"):
        np.testing.assert_allclose(got["stats"][k].numpy(),
                                   want["stats"][k].numpy(), err_msg=k,
                                   **LOSS_TOL)
    if bf16 is not None:
        _close_to_largest(got["grads"], want["grads"], bf16[0])
        _close_to_largest(got["params"], want["params"], bf16[1])
        return
    assert_params_close(got["grads"], want["grads"], rtol=1e-4, atol=1e-6)
    assert_params_close(got["params"], want["params"], **PARAM_TOL)


@pytest.mark.parametrize("backend, shape", CASES, ids=IDS)
def test_step_matches_jax_mesh_step(results, backend, shape):
    want = results["jax"][(backend, shape)]
    d, m = shape
    for got in results["ranks"][f"{backend}_{d}x{m}"]:
        for k in ("loss", "sq_err"):
            np.testing.assert_allclose(got["stats"][k].numpy(),
                                       want["stats"][k], err_msg=k,
                                       **LOSS_TOL)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)


@pytest.mark.parametrize("backend, shape", CASES, ids=IDS)
def test_step_matches_port_single_process(results, backend, shape):
    d, m = shape
    ranks = results["ranks"][f"{backend}_{d}x{m}"]
    assert sorted(r["coords"] for r in ranks) == sorted(
        (i, j) for i in range(d) for j in range(m))
    for got in ranks:
        against_single(got, results["single"][backend])
        # Every rank holds its rows of the split tables (48 and 40 rows).
        assert got["local"]["embed_user.weight"] == (48 // m, 8)
        assert got["local"]["embed_item.weight"] == (40 // m, 8)


def test_swapped_enter_fails_the_comparison(results):
    """Source rows entering the split work without their 'data' sum: the
    gradients upstream of the first level are one rank's share."""
    for got in results["ranks"]["swap"]:
        with pytest.raises(AssertionError):
            against_single(got, results["single"]["xla"])


@pytest.mark.parametrize("option", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_model_options_match_port_single_process(results, option):
    name, bf16 = option[0], option[4]
    for got in results["ranks"][name]:
        against_single(got, results["single"][name], bf16)
