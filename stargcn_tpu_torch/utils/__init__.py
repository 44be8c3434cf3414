"""Config tree, logging and the device helper shared by the port's entry
points."""

from stargcn_tpu_torch.utils.config import (
    EasyDict,
    cfg_from_file,
    default_cfg,
    load_latest_cfg,
    merge_cfg,
    save_cfg_dir,
    save_cfg_file,
)
from stargcn_tpu_torch.utils.device import resolve_device
from stargcn_tpu_torch.utils.logging import MetricLogger, logging_config

__all__ = ["EasyDict", "cfg_from_file", "default_cfg", "merge_cfg",
           "load_latest_cfg", "save_cfg_dir", "save_cfg_file",
           "resolve_device",
           "MetricLogger", "logging_config"]
