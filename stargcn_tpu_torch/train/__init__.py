"""Training loop, losses, schedules, checkpointing."""

from stargcn_tpu_torch.models.stargcn import (
    build_model_config,
    resolve_backend,
)
from stargcn_tpu_torch.train.loop import Trainer, TrainSettings

__all__ = ["Trainer", "TrainSettings", "build_model_config",
           "resolve_backend"]
