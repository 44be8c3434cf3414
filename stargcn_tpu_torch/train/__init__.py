"""Training loop, losses, schedules, checkpointing."""

from stargcn_tpu_torch.models.stargcn import (
    build_model_config,
    resolve_backend,
    resolve_edge_chunk,
)
from stargcn_tpu_torch.train.loop import Trainer, TrainSettings
from stargcn_tpu_torch.train.sampled_loop import (
    SampledTrainer,
    resolve_sampled_backend,
)

__all__ = ["Trainer", "TrainSettings", "SampledTrainer",
           "build_model_config", "resolve_backend",
           "resolve_edge_chunk", "resolve_sampled_backend"]
