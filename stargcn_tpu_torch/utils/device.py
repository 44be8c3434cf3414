"""Device selection for the port's entry points."""

from __future__ import annotations

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
