"""Model inspection helpers.

The port of ``stargcn_tpu/utils/model_info.py`` (the reference's
``gluon_total_param_num`` / ``gluon_net_info`` and ``parse_ctx``).  The
per-parameter table names each parameter by its flax path
(``convert.flax_from_params``), in the flax tree's sorted order, so the
``net%d.txt`` that a port's ``fit`` writes equals the JAX package's for the
same parameters.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stargcn_tpu_torch.utils.device import resolve_device


def total_param_num(state_dict) -> int:
    """Total scalar parameter count of a ``state_dict``."""
    return int(sum(np.prod(tuple(t.shape)) for t in state_dict.values()))


def _flax_leaves(tree, prefix=()):
    """``(path, array)`` of a nested dict in sorted key order, as JAX
    flattens a dict pytree."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def model_info(state_dict, save_path: str | None = None) -> str:
    """Human-readable per-parameter shape table (reference
    ``gluon_net_info``), written to ``save_path`` when one is given."""
    from stargcn_tpu_torch.convert import flax_from_params

    lines = []
    for path, leaf in _flax_leaves(flax_from_params(state_dict)):
        lines.append(f"{'/'.join(path)}: shape={tuple(leaf.shape)} "
                     f"size={int(np.prod(leaf.shape))}")
    lines.append(f"Total #Params: {total_param_num(state_dict)}")
    text = "\n".join(lines)
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                    exist_ok=True)
        with open(save_path, "w") as f:
            f.write(text + "\n")
    return text


def parse_devices(spec: str):
    """``'cuda:0,cuda:1'`` / ``'cpu'`` / ``'all'`` -> a list of
    ``torch.device`` (reference ``parse_ctx``).  ``'all'`` (or empty) is
    every card, or the CPU where there is none; a CUDA device on a machine
    without a card raises."""
    spec = spec.strip()
    if spec in ("", "all"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return ([torch.device("cuda", i) for i in range(n)]
                or [torch.device("cpu")])
    out = []
    for part in spec.split(","):
        part = part.strip()
        if part.startswith("cpu"):
            out.append(torch.device("cpu"))
            continue
        digits = "".join(c for c in part if c.isdigit())
        out.append(resolve_device(torch.device("cuda",
                                               int(digits) if digits else 0)))
    return out
