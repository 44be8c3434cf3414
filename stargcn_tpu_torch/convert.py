"""Parameter and optimiser-state conversion between the JAX package's flax
tree and the port.

The flax tree of ``stargcn_tpu.models.stargcn.STARGCN`` (``Trainer.params``)
holds, per leaf path:

* ``embed_user/embedding``, ``embed_item/embedding`` — ``(N, E)``;
* ``enc_b{p}/l{i}/agg_{t}_{s}/{weight,bias}`` — ``(R, in, U)``, ``(R, U)``;
* ``enc_b{p}/l{i}/out_fc_{t}/{kernel,bias}``,
  ``rating_{user,item}_proj_b{p}/{kernel,bias}``,
  ``embed_map_b{p}_{key}_l{0,1}/{kernel,bias}`` — Dense ``(in, out)``,
  ``(out,)``.

The port's modules carry the same names, so a path maps to a
``state_dict`` key by joining with '.'; a flax ``embedding`` becomes
``nn.Embedding.weight`` and a flax ``kernel (in, out)`` becomes
``nn.Linear.weight (out, in)``.

The Adam moments of the JAX trainer's optax state (``ScaleByAdamState``:
``count``, ``mu``, ``nu``, the two trees shaped like the parameters) map
the same way onto the port's ``train.loop.ClipAdam`` state.  The caller
pulls the three out of the optax state and hands them over as numpy.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

_EMBEDDINGS = ("embed_user", "embed_item")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree (nested dicts of arrays) -> a ``state_dict``
    for ``stargcn_tpu_torch.models.STARGCN``."""
    out = OrderedDict()
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, np.float32)
        *mod, name = path
        if name == "embedding":
            name = "weight"
        elif name == "kernel":
            name, a = "weight", a.T
        out[".".join([*mod, name])] = torch.tensor(a)
    return out


def flax_from_params(state_dict) -> dict:
    """The inverse of :func:`params_from_flax`: a ``state_dict`` -> a
    nested dict of numpy arrays in the flax tree's layout."""
    tree: dict = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        a = t.detach().cpu().numpy()
        if name == "weight" and mod[-1] in _EMBEDDINGS:
            name = "embedding"
        elif name == "weight" and a.ndim == 2:
            name, a = "kernel", a.T
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree


def optimizer_state_from_optax(count, mu_tree, nu_tree) -> dict:
    """Adam's step count and moment trees (nested dicts of arrays in the
    flax layout) -> a ``ClipAdam.load_state_dict`` state."""
    return {"count": int(count), "mu": dict(params_from_flax(mu_tree)),
            "nu": dict(params_from_flax(nu_tree))}


def optimizer_state_to_optax(state):
    """The inverse of :func:`optimizer_state_from_optax`:
    ``(count, mu_tree, nu_tree)`` with numpy leaves in the flax layout."""
    return (int(state["count"]), flax_from_params(state["mu"]),
            flax_from_params(state["nu"]))
