"""The FRVSR trainer (counterpart of ``tecogan_tpu/train/trainer.py`` in its
FRVSR mode; reference lib/Teco.py:77-517 with ``ratio <= 0``).

One step:

- device-side batch preparation: uint8 or float HR crops -> Gaussian-down-4
  LR inputs and [-1, 1] HR targets (:func:`prepare_batch`);
- FNet over every adjacent pair, the flow upsample (kernel K1, backward K2),
  the recurrent generator unroll (trunk: the chain kernel), optionally the
  ping-pong extension;
- content L2 + FNet warp L2 (+ ping-pong L1), one joint backward of
  ``gen_loss + warp_scaling * warp_loss``: G receives d(gen_loss), FNet
  d(warp_scaling * warp_loss + gen_loss), since the warp loss does not
  depend on G (reference Teco.py:437-447);
- two Adam optimizers (G, FNet) on the exponential-decay schedule: update
  ``s`` (0-based) uses ``lr_schedule(s)``, optax's order;
- EMA (0.99) telemetry of every loss scalar (reference Teco.py:415-435).

The parameters stay on the device in float32, and ``TrainState`` is updated
in place (the JAX package returns a new state; PyTorch's optimizers own
theirs). TecoGAN mode (discriminator, VGG, adaptive D gate) is ROADMAP
queue 1 item 8 and raises here; so does bfloat16 training, which needs
float32 master weights beside bfloat16 compute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.layers import glorot_init_
from tecogan_tpu_torch.ops.gauss import gauss_down_by4
from tecogan_tpu_torch.ops.image import deprocess, preprocess
from tecogan_tpu_torch.recurrent.step import (
    extend_pingpong,
    flows_for_sequence,
    unroll_generator,
)
from tecogan_tpu_torch.train import losses as L

_REMAT_BUDGET_BYTES = 4 << 30  # unrolled activations above which "auto" remats

Batch = Union[np.ndarray, torch.Tensor]


def resolve_remat(config: TecoConfig) -> bool:
    """True/False pass through; "auto" recomputes each frame in the backward
    only when the unrolled generator activations would pass ~4 GB (the JAX
    package's estimate, ``trainer.py:50-60``)."""
    if config.remat_generator != "auto":
        return bool(config.remat_generator)
    px = config.crop_size ** 2 * config.batch_size * config.unroll_frames
    layers = 2 * config.num_resblock + 2  # LR trunk activations
    upsample = 2 * (4 + 16)               # the 2x / 4x stages
    est = px * config.gen_channels * (layers + upsample) * 2
    return est > _REMAT_BUDGET_BYTES


def lr_schedule(config: TecoConfig) -> Callable[[int], float]:
    """``tf.train.exponential_decay`` (reference Teco.py:97-98), as
    ``optax.exponential_decay``: ``lr * rate ** (step / decay_step)``, the
    exponent floored when ``stair``."""
    def schedule(step: int) -> float:
        if config.decay_step <= 0:  # optax: a constant schedule
            return config.learning_rate
        p = step / config.decay_step
        if config.stair:
            p = math.floor(p)
        return config.learning_rate * config.decay_rate ** p
    return schedule


def prepare_batch(hr_seq: torch.Tensor, config: TecoConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side batch preparation (reference dataloader.py:306-332).

    Args:
      hr_seq: (B, T, tar, tar, 3) HR crops, uint8 or float in [0, 1], where
        tar = 4*crop + 2*gauss_border.

    Returns:
      r_inputs (B, T, crop, crop, 3) in [0, 1], the Gaussian down-4 of HR;
      r_targets (B, T, 4*crop, 4*crop, 3) in [-1, 1], the centre crop inside
      the Gaussian margin.
    """
    if hr_seq.dtype == torch.uint8:
        hr_seq = hr_seq.float() / 255.0
    b, t, tar, _, c = hr_seq.shape
    k = config.gauss_border
    hr_flat = hr_seq.reshape(b * t, tar, tar, c)
    lr = gauss_down_by4(hr_flat, config.gaussian_sigma)
    crop = lr.shape[1]
    targets = hr_flat[:, k:k + 4 * crop, k:k + 4 * crop, :]
    return (lr.reshape(b, t, crop, crop, c),
            preprocess(targets).reshape(b, t, 4 * crop, 4 * crop, c))


@dataclasses.dataclass
class TrainState:
    """Everything a resume needs; :meth:`Trainer.train_step` updates it in
    place."""

    step: int
    generator: Generator
    fnet: FNet
    gen_opt: torch.optim.Adam
    fnet_opt: torch.optim.Adam
    ema_losses: Dict[str, torch.Tensor]  # float32 scalars on the device


class Trainer:
    """FRVSR training on one device (``cuda`` or ``cpu``)."""

    def __init__(self, config: TecoConfig, device: Union[str, torch.device]):
        if config.gan or config.vgg_scaling > 0:
            raise NotImplementedError(
                "tecogan_tpu_torch trains FRVSR only (ratio <= 0 and "
                "vgg_scaling <= 0, e.g. --preset frvsr); TecoGAN training is "
                "ROADMAP queue 1 item 8")
        if config.compute_dtype != "float32":
            raise NotImplementedError(
                "tecogan_tpu_torch trains in float32 only; bfloat16 training "
                "needs float32 master weights, not ported yet")
        self.config = config
        self.device = torch.device(device)
        self.remat = resolve_remat(config)
        self.schedule = lr_schedule(config)

    # ------------------------------------------------------------ state
    def telemetry_keys(self):
        keys = ["l2_content_loss", "l2_warp_loss", "All_loss_Gen"]
        return keys + ["PingPang"] if self.config.pingpong else keys

    def state_from_modules(self, generator: Generator, fnet: FNet) -> TrainState:
        """A step-0 state around the given modules, moved to the device, with
        fresh optimizers and zero EMAs."""
        cfg = self.config
        memory_format = (torch.channels_last if self.device.type == "cuda"
                         else torch.preserve_format)
        generator = generator.to(self.device, torch.float32,
                                 memory_format=memory_format).train()
        fnet = fnet.to(self.device, torch.float32,
                       memory_format=memory_format).train()

        def adam(module):
            return torch.optim.Adam(module.parameters(), lr=self.schedule(0),
                                    betas=(cfg.beta1, 0.999), eps=cfg.adam_eps)

        return TrainState(
            step=0, generator=generator, fnet=fnet,
            gen_opt=adam(generator), fnet_opt=adam(fnet),
            ema_losses={k: torch.zeros((), device=self.device)
                        for k in self.telemetry_keys()})

    def init_state(self, seed: int) -> TrainState:
        """Fresh glorot-uniform weights (zero biases) drawn from ``seed``."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        generator = glorot_init_(Generator(cfg.num_resblock, cfg.gen_channels), gen)
        fnet = glorot_init_(FNet(cfg.fnet_channels, cfg.fnet_up_channels,
                                 cfg.flow_max_velocity), gen)
        return self.state_from_modules(generator, fnet)

    # ------------------------------------------------------------ steps
    def _inputs(self, hr_seq: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(hr_seq, np.ndarray):
            hr_seq = torch.from_numpy(np.ascontiguousarray(hr_seq))
        r_inputs, r_targets = prepare_batch(hr_seq.to(self.device), self.config)
        if self.config.pingpong:
            r_inputs, r_targets = extend_pingpong(r_inputs), extend_pingpong(r_targets)
        return r_inputs, r_targets

    def _forward_losses(self, state: TrainState, r_inputs, r_targets
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        flow_lr, flow_hr = flows_for_sequence(state.fnet, r_inputs)
        gen_outputs, _ = unroll_generator(
            state.generator, r_inputs, flow_hr,
            remat=self.remat and torch.is_grad_enabled(), with_warppre=False)
        b, t = gen_outputs.shape[:2]
        metrics = {
            "l2_content_loss": L.content_loss(gen_outputs.reshape(b * t, *gen_outputs.shape[2:]),
                                              r_targets.reshape(b * t, *r_targets.shape[2:])),
            "l2_warp_loss": L.warp_loss(r_inputs, flow_lr),
        }
        gen_loss = metrics["l2_content_loss"]
        if cfg.pingpong:
            pp = L.pingpong_loss(gen_outputs, cfg.rnn_n)
            if cfg.pp_scaling > 0:
                gen_loss = gen_loss + cfg.pp_scaling * pp
            metrics["PingPang"] = pp
        metrics["All_loss_Gen"] = gen_loss
        return gen_loss, metrics

    def train_step(self, state: TrainState, hr_seq: Batch
                   ) -> Tuple[TrainState, Dict[str, Union[torch.Tensor, float]]]:
        """One update of G and FNet from (B, T, tar, tar, 3) HR crops.
        Returns the (same, updated) state and the step's metrics as device
        scalars, plus the step's ``learning_rate``. The gradients stay in the
        parameters' ``.grad`` until the next step."""
        cfg = self.config
        r_inputs, r_targets = self._inputs(hr_seq)
        gen_loss, metrics = self._forward_losses(state, r_inputs, r_targets)
        # One joint backward, valid because the warp loss is G-free
        # (reference computes the two gradients separately, Teco.py:446-447).
        joint = gen_loss + cfg.warp_scaling * metrics["l2_warp_loss"]
        state.gen_opt.zero_grad(set_to_none=True)
        state.fnet_opt.zero_grad(set_to_none=True)
        joint.backward()
        lr = self.schedule(state.step)
        for opt in (state.gen_opt, state.fnet_opt):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        d = cfg.loss_ema_decay
        for k in state.ema_losses:
            state.ema_losses[k] = d * state.ema_losses[k] + (1 - d) * metrics[k]
        state.step += 1
        metrics["learning_rate"] = lr
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, hr_seq: Batch) -> Dict[str, torch.Tensor]:
        """Validation losses, no update (reference main.py:394-402)."""
        return self._forward_losses(state, *self._inputs(hr_seq))[1]

    @torch.no_grad()
    def generate(self, state: TrainState, hr_seq: Batch):
        """Forward-only sequences in [0, 1] for summaries (reference
        Teco.py:498-503): LR inputs, HR targets, generated frames and the
        warped previous outputs."""
        r_inputs, r_targets = self._inputs(hr_seq)
        _, flow_hr = flows_for_sequence(state.fnet, r_inputs)
        gen_outputs, warppre = unroll_generator(state.generator, r_inputs, flow_hr,
                                                remat=False)
        return r_inputs, deprocess(r_targets), deprocess(gen_outputs), deprocess(warppre)
