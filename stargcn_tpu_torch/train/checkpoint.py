"""Checkpointing: parameters + optimizer state + host metadata.

The port of ``stargcn_tpu/train/checkpoint.py`` with its signatures.  The
JAX package writes flax msgpack; the port writes ``torch.save`` of plain
CPU tensors (``ckpt_{tag}_{id}.pt``), replaced atomically, with the host
metadata (``{"lr": ...}``) beside it in ``<path>.meta.json``.
"""

from __future__ import annotations

import json
import os

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path, params, opt_state, extra=None):
    """Write ``params`` (a ``state_dict``) and ``opt_state`` (nested dicts
    of tensors and numbers) to ``path``; ``extra`` to its ``.meta.json``."""
    tmp = path + ".tmp"
    torch.save({"params": _to_cpu(params), "opt_state": _to_cpu(opt_state)},
               tmp)
    os.replace(tmp, path)
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    return path


def _like(template, value, where):
    """``value`` with the template's structure checked, tensors placed on
    the template's device."""
    if isinstance(template, dict):
        if not isinstance(value, dict) or sorted(value) != sorted(template):
            raise ValueError(f"checkpoint does not fit the model at {where}")
        return {k: _like(template[k], value[k], f"{where}/{k}")
                for k in template}
    if isinstance(template, torch.Tensor):
        if (not isinstance(value, torch.Tensor)
                or value.shape != template.shape):
            raise ValueError(f"checkpoint does not fit the model at {where}")
        return value.to(device=template.device, dtype=template.dtype)
    return value


def restore_checkpoint(path, params_template, opt_state_template):
    """``(params, opt_state, extra)`` read from ``path``, shaped and placed
    like the templates."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    params = _like(dict(params_template), dict(state["params"]), "params")
    opt_state = _like(opt_state_template, state["opt_state"], "opt_state")
    extra = {}
    meta = path + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            extra = json.load(f)
    return params, opt_state, extra
