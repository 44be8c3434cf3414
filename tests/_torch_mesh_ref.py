"""The reference side of the mesh tests: the JAX package's ``Trainer`` on
its virtual CPU devices (``tests/conftest.py``), and the port's trainer in
this process, on ``tests/test_parallel.py``'s set-up, with the parameters
carried across by ``convert.py``.  ``step_results`` runs one backend's
steps on every mesh it is given in both packages (the port's in spawned
ranks) and on one process."""

import jax
import numpy as np
import torch

import _torch_mesh_ranks as R
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data.synthetic import synthetic_graph as jsynthetic_graph
from stargcn_tpu.parallel import make_mesh as jmake_mesh
from stargcn_tpu.train import Trainer as JTrainer
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.train.loop import TrainSettings as JTrainSettings
from stargcn_tpu.utils import default_cfg as j_default_cfg
from stargcn_tpu_torch import convert

# The tolerances of tests/test_parallel.py:74-83 and :152-161.
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)


def jax_trainer(backend, mesh_shape=None, num_items=64, **overrides):
    """The JAX package's ``Trainer`` of the set-up (``bitdense`` through
    its plain ``xla`` bit route, as its own mesh test runs it, whatever
    route the port takes)."""
    if backend == "bitdense":
        overrides = {**overrides, "KERNEL.BIT_IMPL": "xla"}
    cfg = R.mesh_cfg(backend, j_default_cfg, **overrides)
    it = R.iterator(JDataIterator, jsynthetic_graph, num_items)
    csr = it.all_graph["user", "movie"]
    model_cfg = j_build_model_config(cfg, csr.shape[0], csr.shape[1],
                                     len(csr.multi_link))
    assert model_cfg.backend == backend
    mesh = None if mesh_shape is None else jmake_mesh(*mesh_shape)
    return JTrainer(model_cfg, it, JTrainSettings.from_cfg(cfg), mesh=mesh)


def host_batch(trainer):
    """The first rating batch and the whole recon batch of a trainer's
    samplers (either package's), as ``tests/test_parallel.py`` draws
    them."""
    it = trainer.data_iter
    batch = next(it.rating_sampler(64, "train"))
    noise, _, ids = next(it.recon_nodes_sampler(batch_size=10**6))
    return batch, trainer.prepare_recon_batch(noise, ids)


def jax_params(trainer):
    """A JAX trainer's parameters in the port's ``state_dict`` layout."""
    return convert.params_from_flax(jax.device_get(trainer.params))


def port_single(backend, save_dir, state, **overrides):
    """The port's one-process trainer with ``state`` loaded, its initial
    checkpoint written to ``save_dir`` (``ckpt_init_0.pt``)."""
    t = R.port_trainer(backend, save_dir=str(save_dir), **overrides)
    t.model.load_state_dict(state)
    t.save_checkpoint("init")
    return t


def step_results(backend, tmp, meshes, num_items=64, **overrides):
    """One step on ``backend`` in the JAX package on every mesh of
    ``meshes`` and in the port on one process and on every mesh (spawned
    ranks), on the set-up with ``num_items`` items and the port's
    configuration ``overrides``."""
    out = {"jax": {}, "port": {}}
    for shape in meshes:
        jt = jax_trainer(backend, shape, num_items, **overrides)
        if not out["jax"]:
            # The parameters from the seed and the batch are the same on
            # every mesh and on one device (tests/test_parallel.py).
            state = jax_params(jt)
            rb, cb = host_batch(jt)
        stats = jax.device_get(jt.train_iteration(rb, cb))
        out["jax"][shape] = {"loss": float(stats["loss"]),
                             "sq_err": np.asarray(stats["sq_err"]),
                             "params": jax_params(jt)}
    pt = port_single(backend, tmp / backend, state, num_items=num_items,
                     **overrides)
    stats0, grads = pt.loss_and_grads(rb, cb)
    stats = pt.train_iteration(rb, cb)
    out["single"] = {"stats": stats, "grads": grads,
                     "params": pt.whole_params(),
                     "num_links": pt.model_cfg.num_links}
    world = max(d * m for d, m in meshes)
    R.spawn(R.step_ranks, world, tmp, [backend], meshes, str(tmp), (rb, cb),
            str(tmp), num_items, overrides)
    for d, m in meshes:
        out["port"][(d, m)] = [
            torch.load(tmp / f"{backend}_{d}x{m}_r{r}.pt", weights_only=False)
            for r in range(d * m)]
    return out


def assert_params_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


def check_against_jax(results, shape):
    """Every rank's loss, ``sq_err`` and whole parameters after the step
    against the JAX package's step on the same mesh."""
    want = results["jax"][shape]
    for got in results["port"][shape]:
        np.testing.assert_allclose(float(got["stats"]["loss"]), want["loss"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(got["stats"]["sq_err"].numpy(),
                                   want["sq_err"], **LOSS_TOL)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)


def check_against_single(results, shape):
    """Every rank's loss, ``sq_err``, gradient norm, whole gradients and
    parameters against the port's step on one process."""
    want = results["single"]
    for got in results["port"][shape]:
        for k in ("loss", "sq_err", "rating_loss", "recon_loss", "gnorm"):
            np.testing.assert_allclose(got["stats"][k].numpy(),
                                       want["stats"][k].numpy(), err_msg=k,
                                       **LOSS_TOL)
        assert_params_close(got["grads"], want["grads"], rtol=1e-4,
                            atol=1e-6)
        assert_params_close(got["params"], want["params"], **PARAM_TOL)
        # Every rank holds its rows of the split embedding tables.
        d, m = shape
        for t in ("user", "item"):
            whole = want["params"][f"embed_{t}.weight"].shape
            assert got["shapes"][f"embed_{t}.weight"] == (
                whole[0] // m, whole[1])
