"""FRVSR and TecoGAN training: losses, the trainer, checkpoints and the loop."""

from tecogan_tpu_torch.train.losses import (
    assemble_dst_inputs,
    content_loss,
    d_layer_losses,
    pingpong_loss,
    vgg_cosine_loss,
    warp_loss,
)
from tecogan_tpu_torch.train.trainer import (
    MaskedAdam,
    Trainer,
    TrainState,
    lr_schedule,
    prepare_batch,
    resolve_remat,
)

__all__ = [
    "MaskedAdam",
    "TrainState",
    "Trainer",
    "assemble_dst_inputs",
    "content_loss",
    "d_layer_losses",
    "lr_schedule",
    "pingpong_loss",
    "prepare_batch",
    "resolve_remat",
    "vgg_cosine_loss",
    "warp_loss",
]
