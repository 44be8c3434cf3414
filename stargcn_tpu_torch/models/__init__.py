"""STAR-GCN model modules (PyTorch)."""

from stargcn_tpu_torch.models.stargcn import (
    STARGCN,
    STARGCNConfig,
    build_model_config,
    resolve_backend,
    resolve_edge_chunk,
)

__all__ = ["STARGCN", "STARGCNConfig", "build_model_config",
           "resolve_backend", "resolve_edge_chunk"]
