"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    The default is the card.  The CPU is used only when the caller names
    it; asking for CUDA on a machine without a card raises instead of
    quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def card_line(device="cuda"):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    ``None`` for a device that is not a card.  A failed ``nvidia-smi``
    raises: every number printed beside this line needs the power limit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
