"""Training state, the lossless train step and checkpoints (port of
rec_tpu/train)."""

from .checkpoint import (CheckpointManager, load_model_config,
                         reconcile_model_config, save_model_config)
from .state import (Optimizer, OptState, TrainState, ema_update, init_state,
                    make_optimizer, staircase_schedule)

__all__ = ["CheckpointManager", "load_model_config",
           "reconcile_model_config", "save_model_config", "Optimizer",
           "OptState", "TrainState", "ema_update", "init_state",
           "make_optimizer", "staircase_schedule"]
