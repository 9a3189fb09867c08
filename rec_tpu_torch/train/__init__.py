"""Checkpoint reading (port of the read side of rec_tpu/train)."""

from .checkpoint import (CheckpointManager, load_model_config,
                         reconcile_model_config)

__all__ = ["CheckpointManager", "load_model_config",
           "reconcile_model_config"]
