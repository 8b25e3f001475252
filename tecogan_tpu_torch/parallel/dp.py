"""Data-parallel training over a process group (counterpart of
``tecogan_tpu/parallel/dp.py``).

The JAX package jits the Trainer's step over a mesh: state replicated, the
batch sharded on its leading dimension, and GSPMD inserts the gradient
all-reduce, so one step equals a single-device step on the global batch.
Here one process runs per GPU (``torchrun``, or
:func:`~tecogan_tpu_torch.parallel.init_distributed`), each with the whole
state and ``batch_size / world_size`` rows of the global batch, and the
step's reductions over the batch are made global by hand:

- the gradients, after the joint backward of G and FNet and after the
  discriminator's backward: one ``all_reduce`` over a flat buffer per
  network, divided by the world size (the local losses are means over
  equal local batches). ``DistributedDataParallel`` is not used: the step
  is captured whole as one CUDA graph (``train/trainer.py:_Program``), and
  DDP's autograd hooks and bucket rebuilds do not belong inside a capture,
  while NCCL's ``all_reduce`` is captured as any kernel is;
- the discriminator's batch statistics: every ``SlimBatchNorm`` averages
  ``E[x]`` and ``E[x^2]`` over the group, gradient included
  (``models/layers.py``);
- the metrics, averaged over the group before the EMAs read them, so the
  adaptive gate's ``ema_tbalance`` and every reported metric are the same
  on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.layers import SlimBatchNorm
from tecogan_tpu_torch.models.vgg19 import VGG19Features
from tecogan_tpu_torch.train.trainer import Trainer, TrainState, state_tensors


class DataParallelTrainer(Trainer):
    """Trainer whose steps average over the default process group, one
    process per device; ``config.batch_size`` is the global batch, which
    the world size must divide. ``device``: this process's device."""

    def __init__(self, config: TecoConfig, device: Union[str, torch.device],
                 vgg: Optional[VGG19Features] = None, capture: Optional[bool] = None):
        if not dist.is_initialized():
            raise ValueError("DataParallelTrainer needs a process group; call "
                             "tecogan_tpu_torch.parallel.init_distributed first")
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        if config.batch_size % self.world_size:
            raise ValueError(f"the global batch size {config.batch_size} must be divisible "
                             f"by the world size {self.world_size}")
        self.local_batch_size = config.batch_size // self.world_size
        super().__init__(config, device, vgg=vgg, capture=capture)

    def state_from_modules(self, generator, fnet, discriminator=None) -> TrainState:
        state = super().state_from_modules(generator, fnet, discriminator)
        if state.discriminator is not None:
            for m in state.discriminator.modules():
                if isinstance(m, SlimBatchNorm):
                    m.sync = True
        return state

    def put_batch(self, batch):
        """This rank's rows ``[r B/W, (r+1) B/W)`` of a global (B, ...) batch."""
        if batch.shape[0] != self.config.batch_size:
            raise ValueError(f"a global batch has {self.config.batch_size} rows, not "
                             f"{batch.shape[0]}")
        per = self.local_batch_size
        piece = batch[self.rank * per:(self.rank + 1) * per]
        return np.ascontiguousarray(piece) if isinstance(piece, np.ndarray) else piece

    @torch.no_grad()
    def broadcast_state(self, state: TrainState) -> TrainState:
        """Every state tensor set to rank 0's (after a restore or a warm
        start, which every rank reads alike, this changes nothing)."""
        for t in state_tensors(state):
            dist.broadcast(t, src=0)
        return state

    def _mean(self, flat: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(flat)
        return flat.div_(self.world_size)

    def _reduce_grads(self, *modules: nn.Module) -> None:
        for module in modules:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            if not grads:
                continue
            flat = self._mean(torch.cat([g.reshape(-1) for g in grads]))
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view(g.shape))
                offset += g.numel()

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(metrics)
        flat = self._mean(torch.stack([metrics[k].float() for k in keys]))
        return dict(zip(keys, flat.unbind()))
