"""YAML config system with strict key/type-checked merging.

The port's copy of ``stargcn_tpu/utils/config.py``: an attribute-style
nested dict of defaults, overlaid by a YAML file with unknown-key and
type-mismatch errors.  The default tree is the JAX package's, key for
key, so the repository's ``configs/*.yml`` merge unchanged; keys the port
does not read yet (mesh, sampled-mode kernels) are kept so those files stay
valid.  ``save_cfg_dir`` writes the numbered ``cfg%d.yml`` snapshot of a
run.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import yaml


class EasyDict(OrderedDict):
    """Ordered dict with attribute access, recursively wrapping nested
    dicts."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if name.startswith("_OrderedDict") or name.startswith("__"):
            super().__setattr__(name, value)
        else:
            self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))


def _wrap(value):
    if isinstance(value, dict) and not isinstance(value, EasyDict):
        out = EasyDict()
        for k, v in value.items():
            out[k] = v
        return out
    return value


def default_cfg() -> EasyDict:
    """The full default configuration tree (same keys and values as
    ``stargcn_tpu.utils.config.default_cfg``)."""
    cfg = EasyDict()
    cfg.SEED = 123
    cfg.DATASET = EasyDict()
    cfg.DATASET.NAME = "ml-100k"
    cfg.DATASET.VALID_RATIO = 0.1
    cfg.DATASET.TEST_RATIO = 0.2
    cfg.DATASET.IS_INDUCTIVE = False
    cfg.DATASET.INDUCTIVE_KEY = "item"
    cfg.DATASET.INDUCTIVE_NODE_FRAC = 20
    cfg.DATASET.INDUCTIVE_EDGE_FRAC = 90

    cfg.MODEL = EasyDict()
    cfg.MODEL.USE_EMBED = True
    cfg.MODEL.USE_FEA_PROJ = False
    cfg.MODEL.RECON_FEA = False
    cfg.MODEL.REMOVE_RATING = True
    cfg.MODEL.USE_DAE = True
    cfg.MODEL.NBLOCKS = 2
    cfg.MODEL.USE_RECURRENT = False
    cfg.MODEL.RECON_LAMBDA = 0.1
    cfg.MODEL.ACTIVATION = "leaky"
    cfg.MODEL.SELF_NOISE_ONLY = True
    cfg.MODEL.COMPUTE_DTYPE = "float32"

    cfg.GRAPH_SAMPLER = EasyDict()
    cfg.GRAPH_SAMPLER.NUM_NEIGHBORS = -1

    cfg.FEA = EasyDict()
    cfg.FEA.MID_MAP = 16
    cfg.FEA.UNITS = 16

    cfg.EMBED = EasyDict()
    cfg.EMBED.UNITS = 64
    cfg.EMBED.MASK_PROP = 0.1
    cfg.EMBED.P_ZERO = 0.0

    cfg.GCN = EasyDict()
    cfg.GCN.TYPE = "gcn"
    cfg.GCN.DROPOUT = 0.7
    cfg.GCN.DROPOUT_PER_EDGE = False
    cfg.GCN.USE_RECURRENT = False
    cfg.GCN.AGG = EasyDict()
    cfg.GCN.AGG.NORM_SYMM = True
    cfg.GCN.AGG.UNITS = [500]
    cfg.GCN.AGG.ACCUM = "stack"
    cfg.GCN.AGG.ORDINAL_SHARING = False
    cfg.GCN.OUT = EasyDict()
    cfg.GCN.OUT.UNITS = [75]

    cfg.GEN_RATING = EasyDict()
    cfg.GEN_RATING.MID_MAP = 64

    cfg.TRAIN = EasyDict()
    cfg.TRAIN.RATING_BATCH_SIZE = 10000
    cfg.TRAIN.RECON_BATCH_SIZE = 1000000
    cfg.TRAIN.MAX_ITER = 1000000
    cfg.TRAIN.LOG_INTERVAL = 10
    cfg.TRAIN.VALID_INTERVAL = 10
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.LR = 1e-2
    cfg.TRAIN.WD = 0.0
    cfg.TRAIN.DECAY_PATIENCE = 100
    cfg.TRAIN.MIN_LR = 5e-4
    cfg.TRAIN.LR_DECAY_FACTOR = 0.5
    cfg.TRAIN.EARLY_STOPPING_PATIENCE = 150
    cfg.TRAIN.GRAD_CLIP = 10.0
    cfg.TRAIN.SCAN_STEPS = 1
    cfg.TRAIN.HANG_TIMEOUT_S = 900.0
    cfg.TRAIN.MAX_RESTARTS = 2
    cfg.TRAIN.MAX_NAN_RECOVERIES = 3
    cfg.TRAIN.DEVICE_SAMPLER = False

    cfg.KERNEL = EasyDict()
    cfg.KERNEL.BACKEND = "auto"  # auto | xla | dense | ell | bitdense | pallas
    cfg.KERNEL.ELL_K = 64
    cfg.KERNEL.ELL_CHUNK = 16384
    cfg.KERNEL.ELL_BF16 = False
    # bitdense pooling: auto | kernel | plain ('pallas' and 'xla', the JAX
    # package's names, read as 'kernel' and 'plain')
    cfg.KERNEL.BIT_IMPL = "auto"
    cfg.KERNEL.XLA_MSG_BUDGET_MB = 1500
    cfg.PARALLEL = EasyDict()
    cfg.PARALLEL.DATA_AXIS = 1
    cfg.PARALLEL.MODEL_AXIS = 1
    return cfg


def merge_cfg(src: dict, target: EasyDict, path="") -> None:
    """Recursively overlay ``src`` onto ``target`` with strict checks
    (unknown keys and type mismatches raise)."""
    for key, value in src.items():
        if key not in target:
            raise KeyError(f"unknown config key: {path}{key}")
        old = target[key]
        if isinstance(old, EasyDict):
            if not isinstance(value, dict):
                raise TypeError(
                    f"config key {path}{key} expects a mapping")
            merge_cfg(value, old, path=f"{path}{key}.")
            continue
        if old is not None and value is not None:
            ok = (isinstance(value, type(old))
                  or (isinstance(old, float) and isinstance(value, int))
                  or (isinstance(old, (list, tuple))
                      and isinstance(value, (list, tuple)))
                  or (isinstance(old, np.ndarray)))
            if not ok:
                raise TypeError(
                    f"type mismatch for {path}{key}: "
                    f"{type(old).__name__} vs {type(value).__name__}")
        target[key] = value


def cfg_from_file(filename: str, target: EasyDict | None = None) -> EasyDict:
    """Load YAML and overlay onto ``target`` (defaults if None)."""
    if target is None:
        target = default_cfg()
    with open(filename) as f:
        overlay = yaml.safe_load(f) or {}
    merge_cfg(overlay, target)
    return target


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def save_cfg_file(path: str, source: EasyDict) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(_plain(source), f, sort_keys=False)


def save_cfg_dir(dirname: str, source: EasyDict) -> int:
    """Save an auto-incrementing ``cfg%d.yml`` snapshot; returns the run
    id."""
    os.makedirs(dirname, exist_ok=True)
    run_id = 0
    while os.path.exists(os.path.join(dirname, f"cfg{run_id}.yml")):
        run_id += 1
    save_cfg_file(os.path.join(dirname, f"cfg{run_id}.yml"), source)
    return run_id


def load_latest_cfg(dirname: str,
                    target: EasyDict | None = None) -> EasyDict:
    """Load the highest-numbered ``cfg%d.yml`` snapshot from a save dir,
    merged into ``target`` when one is given (reference
    ``config.py:92-102``, whose ``re.group(1)`` for ``ret.group(1)`` fails
    once a second snapshot exists; this reads the match's group)."""
    import re

    latest, path = -1, None
    for fname in os.listdir(dirname):
        m = re.fullmatch(r"cfg(\d+)\.yml", fname)
        if m and int(m.group(1)) > latest:
            latest, path = int(m.group(1)), os.path.join(dirname, fname)
    if path is None:
        raise FileNotFoundError(f"no cfg%d.yml snapshot in {dirname!r}")
    return cfg_from_file(path, target)
