"""What decides ``correct``: the program's first training steps, recorded
as the window's own call runs them, held against the plain reference.

``StepRecorder`` wraps one trainer's per-step call for the first ``n``
steps of its first ``fit``: it keeps each step's batch (the pairs, the
noise arrays and the reconstruction masks the program's samplers drew),
the dropout masks the program drew (read around the model's dropout
calls), each step's loss, the first gradient as the optimiser got it
(Adam's first moment after one step is ``(1 - b1) g``) and the parameters
after the ``n``-th step.  These are the only places where the check
reaches into the program (``HOOKS``); where one is missing, or no longer
holds what it reads, ``raise_missing`` (after the call: the trainer
retries a step that raises) raises ``HookMissing`` by name rather than
let the check read nothing.

``compare`` turns both sides into the numbers that are compared, each
by the worst case:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over leaves, ``| |g_prog| - |g_ref| |`` over the larger of
  ``|g_ref|`` and the median leaf's ``|g_ref|``;
* ``median_grad_gap``: the median over leaves of that gap: a few leaves
  whose gradient cancels over millions of edges set the worst one, and
  this one reads the rest (the TF32 control moves it twentyfold, where
  the worst leaf's gap moves less than fourfold);
* ``change_gap``: the worst gap, as ``grad_gap``, of the parameters'
  change after ``n`` steps, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off alone).
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import torch

from port_bench.reference import train as RT

HERE = os.path.dirname(os.path.abspath(__file__))
# The modules whose ``dropout`` the model calls.
DROPOUT_SITES = ("stargcn_tpu_torch.models.layers",
                 "stargcn_tpu_torch.models.aggregators")
# Every place the recorder reads the program, for ``HookMissing``.
HOOKS = ("Trainer._step(ints, flts, noise, rmask) -> stats with 'loss'",
         "Trainer.opt.mu: Adam's first moment by parameter name",
         *(f"{m}.dropout(x, rate, train, generator)" for m in DROPOUT_SITES))


class HookMissing(RuntimeError):
    """A place where the check reads the program is gone or changed; the
    check cannot be made until the recorder reads the new one."""


class StepRecorder:
    """Records the first ``n`` steps of ``trainer`` (see the module
    docstring); ``close()`` undoes every wrapper."""

    def __init__(self, trainer, n=3):
        self.trainer, self.n = trainer, n
        self.steps, self.losses = [], []
        self.grad1 = self.params_n = self.missing = None
        self._masks = None
        if not callable(getattr(trainer, "_step", None)):
            raise HookMissing(HOOKS[0])
        self._sites = [importlib.import_module(m) for m in DROPOUT_SITES]
        for m, hook in zip(self._sites, HOOKS[2:]):
            if not callable(getattr(m, "dropout", None)):
                raise HookMissing(hook)
        self._orig_step = trainer._step
        trainer._step = self._step
        self._orig_dropout = [m.dropout for m in self._sites]
        for m in self._sites:
            m.dropout = self._dropout

    def _dropout(self, x, rate, train, generator=None):
        out = self._orig_dropout[0](x, rate, train, generator)
        if self._masks is not None and train and 0.0 < rate < 1.0:
            self._masks.append((out != 0).cpu())
        return out

    def _step(self, ints, flts, noise, rmask):
        if len(self.steps) >= self.n:
            return self._orig_step(ints, flts, noise, rmask)
        tr = self.trainer
        nu = tr.model_cfg.num_users
        n_valid = int(flts[1].sum())
        self._masks = []
        stats = self._orig_step(ints, flts, noise, rmask)
        self.steps.append({
            "pu": ints[0, :n_valid].cpu(), "pi": ints[1, :n_valid].cpu(),
            "noise_u": noise[:nu].cpu(), "noise_i": noise[nu:].cpu(),
            "recon_u": rmask[:nu].cpu(), "recon_i": rmask[nu:].cpu(),
            "masks": self._masks})
        self._masks = None
        self.losses.append(float(stats["loss"]))
        if len(self.steps) == 1:
            mu = getattr(getattr(tr, "opt", None), "mu", None)
            names = sorted(k for k, _ in tr.model.named_parameters())
            if not isinstance(mu, dict) or sorted(mu) != names:
                self.missing = HOOKS[1]
            else:
                self.grad1 = {k: float(torch.linalg.vector_norm(
                    (m / (1 - RT.B1)).double())) for k, m in mu.items()}
        if len(self.steps) == self.n:
            self.params_n = {k: p.detach().cpu().clone()
                             for k, p in tr.model.named_parameters()}
            self._restore_dropout()
        return stats

    def _restore_dropout(self):
        for m, f in zip(self._sites, self._orig_dropout):
            m.dropout = f

    def close(self):
        """Undo the wrappers and let go of the trainer."""
        self._restore_dropout()
        del self.trainer._step          # the class's method again
        self.trainer = self._orig_step = None

    def done(self) -> bool:
        return len(self.steps) == self.n

    def raise_missing(self):
        if self.missing is not None:
            raise HookMissing(self.missing)


def leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    """Each leaf's ``| |prog| - |ref| |`` over the larger of ``|ref|`` and
    the median leaf's ``|ref|``."""
    med = float(np.median([ref[k] for k in ref]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def still_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is under a thousandth of the
    median leaf's: they move by round-off alone."""
    med = float(np.median(list(ref["grad1"].values())))
    return sorted(k for k, v in ref["grad1"].items() if v < 1e-3 * med)


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers from both sides' ``losses``, ``grad1`` and
    ``delta``."""
    leaves = sorted(ref["grad1"])
    if sorted(prog["grad1"]) != leaves:
        raise ValueError("the program's parameters are not the model's")
    still = set(still_leaves(ref))
    moving = [k for k in leaves if k not in still]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], leaves)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": max(grad),
        "median_grad_gap": float(np.median(grad)),
        "change_gap": max(leaf_gaps(prog["delta"], {k: ref["delta"][k]
                                                    for k in moving},
                                    moving)),
    }


def worst_leaves(prog: dict, ref: dict, n=4) -> dict:
    """The ``n`` leaves with the largest gradient and change gaps, for the
    readings' notes."""
    out = {}
    for key in ("grad1", "delta"):
        med = float(np.median(list(ref[key].values())))
        gaps = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med,
                                                           1e-30)
                for k in ref[key]}
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def limits_for(config: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{config}.json")) as f:
        return json.load(f)["limits"]
