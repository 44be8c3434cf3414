"""Activations and initialisers shared by the model layers.

The port of ``stargcn_tpu/models/common.py``: 'leaky' is LeakyReLU with
slope 0.1; kernels are Xavier with factor 'in' (``U(+-sqrt(3 / fan_in))``,
flax's ``variance_scaling(1.0, 'fan_in', 'uniform')``), embeddings
``U(-0.1, 0.1)``.  Initialisers and ``dropout`` draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def get_activation(act):
    """Map an activation name to a callable ('leaky' slope = 0.1)."""
    if act is None or act == "identity" or act == "None":
        return lambda x: x
    if callable(act):
        return act
    return {
        "leaky": lambda x: F.leaky_relu(x, negative_slope=0.1),
        "relu": F.relu,
        "elu": F.elu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softsign": F.softsign,
    }[act]


def xavier_in_(t: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """In-place ``U(-sqrt(3 / fan_in), +sqrt(3 / fan_in))``.  For a flax
    kernel of shape ``(..., in, out)`` the fan-in is ``in`` times the
    product of the leading dimensions."""
    lim = math.sqrt(3.0 / fan_in)
    with torch.no_grad():
        return t.uniform_(-lim, lim, generator=generator)


def dense(in_units: int, out_units: int, generator) -> torch.nn.Linear:
    """A ``Linear`` initialised like flax ``Dense(kernel_init=xavier_in)``:
    Xavier-in weight, zero bias."""
    lin = torch.nn.utils.skip_init(torch.nn.Linear, in_units, out_units)
    xavier_in_(lin.weight, in_units, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator=None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: the identity unless
    ``train`` and ``rate > 0``; else every element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The mask is drawn from
    ``generator``, which lies on x's device."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)
