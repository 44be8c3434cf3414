"""Config tree and the device helper shared by the port's entry points."""

from stargcn_tpu_torch.utils.config import (
    EasyDict,
    cfg_from_file,
    default_cfg,
    merge_cfg,
)
from stargcn_tpu_torch.utils.device import resolve_device

__all__ = ["EasyDict", "cfg_from_file", "default_cfg", "merge_cfg",
           "resolve_device"]
