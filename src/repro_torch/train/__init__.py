"""Training substrate: optimizers, schedules, steps, checkpoints, loop."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    adafactor_init,
    adafactor_update,
)
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "warmup_cosine",
    "TrainStepConfig",
    "make_train_step",
    "CheckpointManager",
    "TrainLoop",
    "TrainLoopConfig",
]
