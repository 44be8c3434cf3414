"""Shared set-up for the tests that hold the port's serving slice against
the JAX package: one small ML-10M-shaped configuration (10 rating levels,
2 blocks, ``leaky``, the ``bitdense`` backend, narrow widths), one synthetic
graph split the same way in both packages, a JAX ``Trainer`` and the
port's ``ServingState`` on the same parameters."""

import os

import jax.numpy as jnp
import numpy as np

from stargcn_tpu.data import DataIterator as JDataIterator
from stargcn_tpu.data import synthetic as jsyn
from stargcn_tpu.train import Trainer
from stargcn_tpu.train import build_model_config as j_build_model_config
from stargcn_tpu.train.loop import TrainSettings
from stargcn_tpu.utils import cfg_from_file as j_cfg_from_file
from stargcn_tpu_torch import convert
from stargcn_tpu_torch.data import DataIterator
from stargcn_tpu_torch.data import synthetic as tsyn
from stargcn_tpu_torch.models import build_model_config
from stargcn_tpu_torch.serve import ServingState
from stargcn_tpu_torch.utils import cfg_from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML10M_CFG = os.path.join(ROOT, "configs", "transductive_ml_10m.yml")
RATINGS_10 = tuple(np.arange(0.5, 5.01, 0.5))
GRAPH = dict(num_users=40, num_items=30, num_edges=420,
             rating_values=RATINGS_10, seed=3)


def small_ml10m_cfg(load, accum="sum"):
    """``transductive_ml_10m.yml`` on the synthetic graph at small width;
    ``load`` is either package's ``cfg_from_file``."""
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
