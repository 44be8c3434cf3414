"""Activations and initialisers shared by the model layers.

The port of ``stargcn_tpu/models/common.py``: 'leaky' is LeakyReLU with
slope 0.1; kernels are Xavier with factor 'in' (``U(+-sqrt(3 / fan_in))``,
flax's ``variance_scaling(1.0, 'fan_in', 'uniform')``), embeddings
``U(-0.1, 0.1)``.  Initialisers and ``dropout`` draw from an explicit
``torch.Generator``.

Mixed precision (``MODEL.COMPUTE_DTYPE``): parameters stay float32, and a
``Dense`` with a ``compute_dtype`` casts its input, weight and bias to it on
every call, as flax's ``Dense(dtype=...)`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _leaky(x):
    """LeakyReLU with slope 0.1, written as flax's ``leaky_relu``
    (``where(x >= 0, x, 0.1 * x)``), so that its derivative at an exact 0
    is 1 as there (``F.leaky_relu``'s is 0.1).  Exact zeros are common in
    bf16 compute."""
    return torch.where(x >= 0, x, x * 0.1)


def get_activation(act):
    """Map an activation name to a callable ('leaky' slope = 0.1)."""
    if act is None or act == "identity" or act == "None":
        return lambda x: x
    if callable(act):
        return act
    return {
        "leaky": _leaky,
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


def compute_dtype(name: str):
    """The torch dtype of a ``MODEL.COMPUTE_DTYPE`` name, or ``None`` for
    float32 (every operand already is)."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown compute dtype: {name!r}")
    return None if dtype == torch.float32 else dtype


def linear(x, weight, bias, dtype=None):
    """``F.linear``; with ``dtype`` every operand is cast to it first and
    the output is in it, rounded where flax's ``Dense(dtype=...)`` rounds:
    the product, then the sum with the bias.  (One rounding of the fused
    sum would differ where a pre-activation lies near 0, the kink of
    ``leaky``.)"""
    if dtype is None:
        return F.linear(x, weight, bias)
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


class Dense(torch.nn.Linear):
    """A ``Linear`` that computes in ``compute_dtype`` (``None``: in its
    input's dtype, which must be float32)."""

    compute_dtype = None

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


def dense(in_units: int, out_units: int, generator, dtype=None) -> Dense:
    """A ``Dense`` initialised like flax ``Dense(kernel_init=xavier_in)``:
    Xavier-in weight, zero bias; it computes in ``dtype`` (``None``:
    float32)."""
    lin = torch.nn.utils.skip_init(Dense, in_units, out_units)
    lin.compute_dtype = dtype
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
