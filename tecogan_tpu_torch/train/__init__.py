"""FRVSR training: losses, the trainer, checkpoints and the loop."""

from tecogan_tpu_torch.train.losses import content_loss, pingpong_loss, warp_loss
from tecogan_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    lr_schedule,
    prepare_batch,
    resolve_remat,
)

__all__ = [
    "TrainState",
    "Trainer",
    "content_loss",
    "lr_schedule",
    "pingpong_loss",
    "prepare_batch",
    "resolve_remat",
    "warp_loss",
]
