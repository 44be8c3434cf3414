"""Shared set-up for the tests that hold the port's slices against the JAX
package: one small ML-10M-shaped configuration (10 rating levels, 2 blocks,
``leaky``, the ``bitdense`` backend, narrow widths), one synthetic graph
split the same way in both packages, a JAX ``Trainer`` and the port's
``ServingState`` or ``Trainer`` on the same parameters; for sampled
mode, a 30 x 22 graph with both packages' ``SampledTrainer``; and, for
inductive splits, an ml-100k-format fixture archive that both packages'
``build_dataset`` read into the same graph and split."""

import contextlib
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np

from experiments import common as jcommon
from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.graph import kernels as jkernels
from stargcn_tpu.models import STARGCNConfig as JSTARGCNConfig
from stargcn_tpu.ops import pallas_kernels as jpallas
from stargcn_tpu.train import Trainer
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.train.loop import TrainSettings
from stargcn_tpu.train.sampled_loop import SampledTrainer
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch import convert
from stargcn_tpu_torch import predict as tpredict
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.graph import kernels as tkernels
from stargcn_tpu_torch.models import STARGCNConfig, build_model_config
from stargcn_tpu_torch.serve import ServingState
from stargcn_tpu_torch.train import Trainer as TTrainer
from stargcn_tpu_torch.train import SampledTrainer as TSampledTrainer
from stargcn_tpu_torch.train import TrainSettings as TTrainSettings
from stargcn_tpu_torch.utils import cfg_from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML10M_CFG = os.path.join(ROOT, "configs", "transductive_ml_10m.yml")
RATINGS_10 = tuple(np.arange(0.5, 5.01, 0.5))
GRAPH = dict(num_users=40, num_items=30, num_edges=420,
             rating_values=RATINGS_10, seed=3)


def small_ml10m_cfg(load, accum="sum", **overrides):
    """``transductive_ml_10m.yml`` on the synthetic graph at small width;
    ``load`` is either package's ``cfg_from_file``.  ``overrides`` sets
    dotted keys, e.g. ``{"GCN.DROPOUT": 0.0}``."""
    cfg = load(ML10M_CFG)
    cfg.DATASET.NAME = "synthetic"
    cfg.KERNEL.BACKEND = "bitdense"
    cfg.EMBED.UNITS = 8
    cfg.GCN.AGG.UNITS = [20 if accum == "stack" else 16]
    cfg.GCN.AGG.ACCUM = accum
    cfg.GCN.OUT.UNITS = [6]
    cfg.GEN_RATING.MID_MAP = 8
    cfg.TRAIN.RATING_BATCH_SIZE = 64
    cfg.TRAIN.RECON_BATCH_SIZE = 64
    return set_keys(cfg, overrides)


def set_keys(cfg, overrides):
    """Set dotted keys of a config, e.g. ``{"GCN.DROPOUT": 0.0}``."""
    for dotted, value in overrides.items():
        node = cfg
        *path, leaf = dotted.split(".")
        for key in path:
            node = node[key]
        node[leaf] = value
    return cfg


def _iterator(cls, graph):
    csr = graph["user", "movie"]
    pairs = csr.node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    n = pairs.shape[1] // 10
    return cls(graph, "user", "movie",
               test_node_pairs=pairs[:, perm[:n]],
               valid_node_pairs=pairs[:, perm[n:2 * n]],
               embed_P_mask=0.1, embed_p_zero=0.0, embed_p_self=1.0, seed=11)


def random_params(tree, seed=0):
    """A parameter tree of the same structure with O(1) activations:
    normal embeddings, kernels scaled by 1/sqrt(fan-in), small biases.
    The seeded init makes outputs of ~1e-5, where ties and rounding would
    hide what the tests check."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        shape = np.shape(leaf)
        a = rng.randn(*shape)
        if path[-1] == "bias":
            a *= 0.1
        elif path[-1] != "embedding":
            a /= np.sqrt(np.prod(shape[:-1]))
        return jnp.asarray(a.astype(np.float32))

    def walk(node, path=()):
        return {k: (walk(v, path + (k,)) if hasattr(v, "items")
                    else draw(path + (k,), v)) for k, v in node.items()}

    return walk(tree)


def build_pair(accum="sum"):
    """``(trainer, state)``: a JAX ``Trainer`` and the port's
    ``ServingState`` (on the CPU) over the same graph and the same
    parameters (``random_params``)."""
    jcfg = small_ml10m_cfg(j_cfg_from_file, accum)
    jit_ = _iterator(JDataIterator, jsyn.synthetic_graph(**GRAPH))
    csr = jit_.all_graph["user", "movie"]
    dims = (csr.shape[0], csr.shape[1], len(csr.multi_link))
    trainer = Trainer(j_build_model_config(jcfg, *dims), jit_,
                      TrainSettings.from_cfg(jcfg))
    assert trainer.model_cfg.backend == "bitdense"
    trainer.params = random_params(trainer.params)

    tcfg = small_ml10m_cfg(cfg_from_file, accum)
    tit = _iterator(DataIterator, tsyn.synthetic_graph(**GRAPH))
    state = ServingState(build_model_config(tcfg, *dims), tit, device="cpu",
                         state_dict=convert.params_from_flax(trainer.params))
    return trainer, state


def build_trainers(accum="sum", save_dir=None, **overrides):
    """``(jax_trainer, torch_trainer)`` over the same graph, split, sampler
    seed and parameters (``random_params``), the port's on the CPU.
    Dropout is off unless ``overrides`` turns it on: the two packages draw
    different masks from the same seed."""
    overrides = {"GCN.DROPOUT": 0.0, **overrides}
    jcfg = small_ml10m_cfg(j_cfg_from_file, accum, **overrides)
    jit_ = _iterator(JDataIterator, jsyn.synthetic_graph(**GRAPH))
    csr = jit_.all_graph["user", "movie"]
    dims = (csr.shape[0], csr.shape[1], len(csr.multi_link))
    settings = TrainSettings.from_cfg(jcfg)
    settings.hang_timeout_s = 0.0
    jtrainer = Trainer(j_build_model_config(jcfg, *dims), jit_, settings,
                       save_dir=None if save_dir is None
                       else os.path.join(save_dir, "jax"))
    jtrainer.params = random_params(jtrainer.params)
    jtrainer.opt_state = jtrainer.opt.init(jtrainer.params)

    tcfg = small_ml10m_cfg(cfg_from_file, accum, **overrides)
    tit = _iterator(DataIterator, tsyn.synthetic_graph(**GRAPH))
    ttrainer = TTrainer(build_model_config(tcfg, *dims), tit,
                        TTrainSettings.from_cfg(tcfg), device="cpu",
                        save_dir=None if save_dir is None
                        else os.path.join(save_dir, "torch"))
    ttrainer.model.load_state_dict(convert.params_from_flax(jtrainer.params))
    return jtrainer, ttrainer


def build_port_trainer(accum="sum", save_dir=None, **overrides):
    """The port's ``Trainer`` of ``build_trainers`` alone (on the CPU, its
    own seeded parameters), for tests that hold the port against itself."""
    overrides = {"GCN.DROPOUT": 0.0, **overrides}
    tcfg = small_ml10m_cfg(cfg_from_file, accum, **overrides)
    tit = _iterator(DataIterator, tsyn.synthetic_graph(**GRAPH))
    csr = tit.all_graph["user", "movie"]
    dims = (csr.shape[0], csr.shape[1], len(csr.multi_link))
    return TTrainer(build_model_config(tcfg, *dims), tit,
                    TTrainSettings.from_cfg(tcfg), device="cpu",
                    save_dir=save_dir)


def host_batches(trainer, n):
    """The first ``n`` ``(rating_batch, recon_batch)`` pairs of a trainer's
    samplers, as ``fit`` draws them (either package's trainer)."""
    it = trainer.data_iter
    ratings = it.rating_sampler(batch_size=trainer.s.rating_batch_size,
                                segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    out = []
    for _ in range(n):
        rb = next(ratings)
        noise, _, ids = next(recon)
        out.append((rb, trainer.prepare_recon_batch(noise, ids)))
    return out


# ------------------------------ sampled mode ------------------------------

SAMPLED_GRAPH = dict(num_users=30, num_items=22, num_edges=260,
                     rating_values=(1, 2, 3), seed=2)
SAMPLED_MODEL = dict(num_users=30, num_items=22, num_links=3, nblocks=2,
                     embed_units=8, agg_units=(12,), out_units=(10,),
                     gcn_dropout=0.0, gen_rating_mid_map=6, agg_accum="sum")
SAMPLED_SETTINGS = dict(rating_batch_size=24, recon_batch_size=8,
                        max_iter=20, log_interval=5, valid_interval=10,
                        lr=1e-2, seed=3, remove_rating=True)


@contextlib.contextmanager
def reference_on_cpu():
    """While open, the JAX package plans with its NumPy path (as if its
    native extension were not built) and runs its Pallas ELL pooling in
    interpret mode; nothing in the package changes."""
    real = jpallas.ell_spmm

    def interpreted(values, nbr_idx, nbr_weight, interpret=False):
        return real(values, nbr_idx, nbr_weight, True)

    with mock.patch.object(jkernels, "_native", None), \
            mock.patch.object(jpallas, "ell_spmm", interpreted):
        yield


def seed_planners(seed):
    """Restart both packages' neighbor-sampling streams from ``seed``."""
    jkernels.set_seed(seed)
    tkernels.set_seed(seed)


def sampled_graphs():
    """The 30 x 22 synthetic graph of ``tests/test_sampled.py`` in both
    packages: ``(jax_graph, port_graph)``."""
    return (jsyn.synthetic_graph(**SAMPLED_GRAPH),
            tsyn.synthetic_graph(**SAMPLED_GRAPH))


def sampled_cfgs(**overrides):
    """``(jax_cfg, port_cfg)``: the same small two-block model config."""
    kw = {**SAMPLED_MODEL, **overrides}
    return JSTARGCNConfig(**kw), STARGCNConfig(**kw)


def sampled_iterator(cls, graph):
    pairs = graph["user", "movie"].node_pair_ids
    perm = np.random.RandomState(0).permutation(pairs.shape[1])
    return cls(graph, "user", "movie",
               test_node_pairs=pairs[:, perm[:40]],
               valid_node_pairs=pairs[:, perm[40:80]],
               embed_P_mask=0.2, seed=0, embed_p_zero=1.0, embed_p_self=0.0)


def build_sampled_trainers(backend="xla", save_dir=None, fanout=4,
                           planner="loop", model=None, plan_device=False,
                           **settings):
    """``(jax_trainer, torch_trainer)``: both packages' ``SampledTrainer``
    over the same graph, split, sampler seeds, caps and parameters
    (``random_params``), the port's on the CPU with the loop planner, whose
    draws are the reference's; ``plan_device`` for both.  Call inside
    ``reference_on_cpu()``."""
    jg, tg = sampled_graphs()
    jcfg, tcfg = sampled_cfgs(**(model or {}))
    kw = {**SAMPLED_SETTINGS, **settings}
    seed_planners(5)
    jtrainer = SampledTrainer(
        jcfg, sampled_iterator(JDataIterator, jg), TrainSettings(**kw),
        fanout=fanout, backend=backend, plan_device=plan_device,
        save_dir=None if save_dir is None else os.path.join(save_dir, "jax"))
    jtrainer.params = random_params(jtrainer.params)
    jtrainer.opt_state = jtrainer.opt.init(jtrainer.params)
    seed_planners(5)
    ttrainer = TSampledTrainer(
        tcfg, sampled_iterator(DataIterator, tg), TTrainSettings(**kw),
        fanout=fanout, backend=backend, planner=planner, device="cpu",
        plan_device=plan_device, save_dir=None if save_dir is None
        else os.path.join(save_dir, "torch"))
    ttrainer.model.load_state_dict(convert.params_from_flax(jtrainer.params))
    seed_planners(7)
    return jtrainer, ttrainer


def sampled_batches(trainer, n):
    """The first ``n`` batches of a ``SampledTrainer`` (either package's),
    as ``fit`` builds them."""
    it = trainer.data_iter
    rs = it.rating_sampler(batch_size=trainer.train_batch, segment="train")
    recon = it.recon_nodes_sampler(batch_size=trainer.s.recon_batch_size)
    return [trainer._make_batch(rs, recon) for _ in range(n)]


# ----------------------------- inductive splits -----------------------------

ML100K_FIXTURE = dict(num_users=50, num_items=30, num_edges=1200, seed=0)


def write_ml100k_fixture(root):
    """An ml-100k-format archive, extracted under ``root``: 50 users, 30
    items, every one rated."""
    tsyn.write_ml100k_format(os.path.join(root, "ml-100k"), **ML100K_FIXTURE)
    return root


def use_float32_adjacency(jtrainer, ttrainer):
    """Both trainers on float32 dense adjacencies (the JAX trainer's built
    as it builds its own), for the "dense-f32" route."""
    import torch

    from stargcn_tpu.ops.agg import build_dense_adjacency as j_build

    g = jtrainer.graph_data
    jtrainer.dense_adj = {
        k: j_build(g.edge_item, g.edge_user, g.edge_rating,
                   m * g.edge_pad_mask, g.num_links, g.num_users,
                   g.num_items, dtype=jnp.float32)
        for k, m in jtrainer.edge_masks.items()}
    ttrainer._operands = lambda variant: ttrainer.variants.dense_adj(
        variant, torch.float32)


def build_inductive_trainers(cfg_name, data_root, route="dense",
                             **overrides):
    """``(jax_trainer, torch_trainer)``: both packages' ``Trainer`` over
    what their ``build_dataset`` reads from the ml-100k fixture under
    ``data_root`` with ``configs/<cfg_name>`` (an inductive config at its
    published widths, read as ml-100k; batch 64 so the step removes its
    edges; dropout 0), on the same
    parameters (``random_params``), the port's on the CPU.  ``route`` is
    ``dense``, ``dense-f32`` or ``xla``."""
    overrides = {"DATASET.NAME": "ml-100k", "GCN.DROPOUT": 0.0,
                 "TRAIN.RATING_BATCH_SIZE": 64,
                 "KERNEL.BACKEND": route.split("-")[0], **overrides}
    path = os.path.join(ROOT, "configs", cfg_name)
    jcfg = set_keys(j_cfg_from_file(path), overrides)
    _, jit_, jmodel_cfg = jcommon.build_dataset(jcfg, data_root)
    settings = TrainSettings.from_cfg(jcfg)
    settings.hang_timeout_s = 0.0
    jtrainer = Trainer(jmodel_cfg, jit_, settings)
    jtrainer.params = random_params(jtrainer.params)
    jtrainer.opt_state = jtrainer.opt.init(jtrainer.params)

    tcfg = set_keys(cfg_from_file(path), overrides)
    _, tit, tmodel_cfg = tpredict.build_dataset(tcfg, data_root)
    ttrainer = TTrainer(tmodel_cfg, tit, TTrainSettings.from_cfg(tcfg),
                        device="cpu")
    ttrainer.model.load_state_dict(convert.params_from_flax(jtrainer.params))
    if route == "dense-f32":
        use_float32_adjacency(jtrainer, ttrainer)
    return jtrainer, ttrainer


def build_inductive_sampled_trainers(cfg_name, data_root, backend="xla",
                                     fanout=4, **overrides):
    """``(jax_trainer, torch_trainer)``: both packages' ``SampledTrainer``
    over the inductive split ``build_dataset`` reads from the fixture, with
    the same sampler seeds, caps and parameters, the port's on the CPU with
    the loop planner.  Call inside ``reference_on_cpu()``."""
    overrides = {"DATASET.NAME": "ml-100k", "GCN.DROPOUT": 0.0,
                 "TRAIN.RATING_BATCH_SIZE": 64, "TRAIN.RECON_BATCH_SIZE": 16,
                 **overrides}
    path = os.path.join(ROOT, "configs", cfg_name)
    jcfg = set_keys(j_cfg_from_file(path), overrides)
    tcfg = set_keys(cfg_from_file(path), overrides)
    _, jit_, jmodel_cfg = jcommon.build_dataset(jcfg, data_root)
    _, tit, tmodel_cfg = tpredict.build_dataset(tcfg, data_root)
    seed_planners(5)
    jtrainer = SampledTrainer(jmodel_cfg, jit_, TrainSettings.from_cfg(jcfg),
                              fanout=fanout, backend=backend)
    jtrainer.params = random_params(jtrainer.params)
    jtrainer.opt_state = jtrainer.opt.init(jtrainer.params)
    seed_planners(5)
    ttrainer = TSampledTrainer(tmodel_cfg, tit, TTrainSettings.from_cfg(tcfg),
                               fanout=fanout, backend=backend,
                               planner="loop", device="cpu")
    ttrainer.model.load_state_dict(convert.params_from_flax(jtrainer.params))
    seed_planners(7)
    return jtrainer, ttrainer


# ------------------------- the native host kernels -------------------------

# ``stargcn_tpu/native/build.py``'s flags.
JAX_NATIVE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
                    "-march=native"]


def build_jax_native(directory):
    """The JAX package's own extension, compiled from
    ``stargcn_tpu/native/graph_kernels.cpp`` with its build script's flags into
    ``directory`` and loaded from there (nothing is written into
    ``stargcn_tpu/``)."""
    import importlib.util
    import subprocess
    import sysconfig

    src = os.path.join(ROOT, "stargcn_tpu", "native", "graph_kernels.cpp")
    out = os.path.join(str(directory), "_graph_kernels"
                       + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run(["g++", *JAX_NATIVE_FLAGS,
                    f"-I{sysconfig.get_paths()['include']}",
                    f"-I{np.get_include()}", src, "-o", out],
                   check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("_graph_kernels", out)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
