"""The FRVSR and TecoGAN trainer (counterpart of
``tecogan_tpu/train/trainer.py``; reference lib/Teco.py:77-517).

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
  ``s`` (0-based) uses ``lr_schedule(s)``, optax's order, computed in
  float32 on the device from the state's device step counter
  (:meth:`Trainer.lr_at`) into a tensor learning rate;
- EMA (0.99) telemetry of every loss scalar (reference Teco.py:415-435).

TecoGAN mode (``ratio > 0``) adds, as the JAX package does
(``trainer.py:238-447``):

- the VGG19 perceptual loss (``vgg_scaling > 0``, frozen weights passed to
  the constructor), the adversarial loss and the discriminator's feature
  losses, both faded in by ``dt_ratio``. The generator's side runs the
  discriminator twice (real, then fake: one batch would change the batch
  statistics) at its current parameters as constants: no gradient reaches
  them and no running statistic moves;
- the discriminator step on the same real and fake inputs, detached, with
  the same parameters; its running statistics update on real, then fake;
- the adaptive gate (reference Teco.py:455-496): the discriminator's Adam
  update is applied only while the loss EMA ``ema_tbalance`` read before
  this step is below ``d_balance``. It is applied branch-free on the device
  (:class:`MaskedAdam`), so a step never waits for the device; a closed
  gate leaves the parameters, both moments and Adam's count as they were.
  The running statistics update in both gate states.

The parameters stay on the device in float32, and ``TrainState`` is updated
in place (the JAX package returns a new state; PyTorch's optimizers own
theirs): every tensor the step reads or writes keeps its storage, the step
counts on the device too, and the host never waits on the device inside a
step.

``config.compute_dtype = "bfloat16"`` trains as the JAX package's models
with ``dtype=bfloat16, param_dtype=float32`` do: the parameters, Adam
moments, EMAs and the discriminator's running statistics stay float32,
and each trained model runs at its parameters cast to bfloat16 at use
(:func:`cast_at_use`), so the backward reaches the float32 leaves through
the casts and the Adams are unchanged. Float32 stays where the JAX package
keeps it: the discriminator's outputs before every log, the batch norm's
statistics and normalisation, the losses against float32 targets, the
ping-pong, VGG and layer reductions, and the warps' coordinates. The frozen
VGG19 is cast to bfloat16 once, here, where the JAX package casts its
weights at every call: the same values.

On the card, each step runs as a captured CUDA graph by default (the JAX
package's ``jax.jit(self._train_step_impl, donate_argnums=(0,))`` and
jitted eval step, ``tecogan_tpu/train/trainer.py:173-174``): one program
per (state, batch shape, batch dtype) and kind (train or eval), whose batch
goes up from pinned host buffers used in turn into a static device buffer;
the body returns the metrics stacked in one vector, cloned after each
replay. The Adams are then built ``capturable`` (state and step counts on
the device). The first call of a shape saves the state, lets the program
warm up and capture, restores the state and replays: each call is one
update. A state tensor that has moved (rebound, or restored by
``load_state_dict``) since the capture makes the program capture again
(``Trainer.recaptures``); nothing falls back to eager. On the CPU, and with
``capture=False``, the same body runs eagerly over the same buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.discriminator import Discriminator
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.layers import SlimBatchNorm, glorot_init_
from tecogan_tpu_torch.models.vgg19 import (
    DEFAULT_FEATURE_KEYS,
    VGG19Features,
    vgg19_normalized_features,
)
from tecogan_tpu_torch.ops.gauss import gauss_down_by4
from tecogan_tpu_torch.ops.image import deprocess, preprocess
from tecogan_tpu_torch.recurrent.step import (
    extend_pingpong,
    flows_for_sequence,
    unroll_generator,
    upscale_flow,
)
from tecogan_tpu_torch.train import losses as L
from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram, resolve_capture

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


def cast_at_use(module: nn.Module, dtype: torch.dtype, detach: bool = False) -> Callable:
    """``module`` as a function that computes in ``dtype`` from its float32
    parameters, as flax's ``Module(dtype=dtype, param_dtype=float32)``: each
    parameter is cast at use (``torch.func.functional_call``), so a
    gradient flows back through the cast into the float32 leaf. A batch
    norm's bias stays float32 (flax adds it in float32); the buffers are
    the module's own. ``detach``: the parameters taken as constants. With
    nothing to cast or detach, the module itself."""
    if dtype == torch.float32 and not detach:
        return module
    keep = {f"{name}.bias" for name, m in module.named_modules()
            if isinstance(m, SlimBatchNorm)}
    params = {}
    for name, p in module.named_parameters():
        p = p.detach() if detach else p
        params[name] = p if name in keep else p.to(dtype)
    return lambda *args, **kwargs: functional_call(module, params, args, kwargs)


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


class MaskedAdam:
    """``optax.adam`` (the JAX package's discriminator optimizer) whose
    update is applied only where a boolean device tensor says so: where it
    is false the parameters, both moments and the count keep their values
    (``tecogan_tpu/train/trainer.py:413-422``, ``_tree_where``). The choice
    is ``torch.where`` on the device, so the host never waits for it.

    The arithmetic is optax's: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 +
    b2 nu``, bias corrections from the incremented count, ``p += -lr *
    mu_hat / (sqrt(nu_hat) + eps)``, and the learning rate is the schedule
    at the count before the update (optax's ``scale_by_schedule``): a
    closed gate does not advance the schedule either."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[torch.Tensor], torch.Tensor],
                 b1: float, eps: float, b2: float = 0.999):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, apply: torch.Tensor) -> None:
        """One update from the parameters' ``.grad``, kept where ``apply``
        (a bool scalar on the parameters' device) is true."""
        lr = self.schedule(self.count)
        count = self.count + 1
        bc1 = 1 - torch.pow(self.b1, count.float())
        bc2 = 1 - torch.pow(self.b2, count.float())
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu_new = (1 - self.b1) * g + self.b1 * mu
            nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
            update = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            p.copy_(torch.where(apply, p + update * -lr, p))
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
        self.count.copy_(torch.where(apply, count, self.count))

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count.copy_(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


@dataclasses.dataclass
class TrainState:
    """Everything a resume needs; :meth:`Trainer.train_step` updates it in
    place. The discriminator's fields are None in FRVSR mode."""

    step: int
    generator: Generator
    fnet: FNet
    gen_opt: torch.optim.Adam
    fnet_opt: torch.optim.Adam
    ema_losses: Dict[str, torch.Tensor]  # float32 scalars on the device
    device_step: torch.Tensor  # int32 scalar on the device, equal to ``step``
    discriminator: Optional[Discriminator] = None
    d_opt: Optional[MaskedAdam] = None
    ema_tbalance: Optional[torch.Tensor] = None    # float32 scalar on the device
    counter_with_d: Optional[torch.Tensor] = None  # int32 scalars on the device
    counter_wo_d: Optional[torch.Tensor] = None


def _init_adam_state(opt: torch.optim.Adam) -> None:
    """Adam's state as its first ``step()`` would make it (zero moments,
    step count 0, on the device when capturable), so that a capture finds
    it: Adam creates it lazily."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state[p]:
                opt.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=p.device if group["capturable"] else "cpu"),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def named_state_tensors(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of ``state`` that a step writes, with a name: the
    models' parameters and buffers, the optimizers' states and learning
    rates, the EMAs, the gate's counters and the device step."""
    out = []
    for name, module in (("generator", state.generator), ("fnet", state.fnet),
                         ("discriminator", state.discriminator)):
        if module is not None:
            out += [(f"{name}.{k}", t) for k, t in (*module.named_parameters(),
                                                    *module.named_buffers())]
    for name, opt in (("gen_opt", state.gen_opt), ("fnet_opt", state.fnet_opt)):
        for group in opt.param_groups:
            out.append((f"{name}.lr", group["lr"]))
            out += [(f"{name}.{i}.{k}", t) for i, p in enumerate(group["params"])
                    for k, t in opt.state.get(p, {}).items()]
    out += [(f"ema_losses.{k}", v) for k, v in state.ema_losses.items()]
    out.append(("device_step", state.device_step))
    if state.d_opt is not None:
        out += [(f"d_opt.mu.{i}", t) for i, t in enumerate(state.d_opt.mu)]
        out += [(f"d_opt.nu.{i}", t) for i, t in enumerate(state.d_opt.nu)]
        out += [(k, getattr(state, k)) for k in ("ema_tbalance", "counter_with_d",
                                                 "counter_wo_d")]
        out.append(("d_opt.count", state.d_opt.count))
    return out


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The tensors of :func:`named_state_tensors`."""
    return [t for _, t in named_state_tensors(state)]


class _Program:
    """One kind of step ("train" or "eval") over one state at one batch shape
    and dtype: the static device batch, the host buffers its uploads go
    through, and the step's body over them, captured on the card or eager.

    The body holds the trainer through a weak proxy, so a dropped trainer
    frees its graphs at once."""

    def __init__(self, trainer: "Trainer", state: TrainState, kind: str,
                 shape: Tuple[int, ...], dtype: torch.dtype):
        device = trainer.device
        self.kind, self.state = kind, state
        self.hr = torch.zeros(shape, dtype=dtype, device=device)
        if device.type == "cuda":
            # Two pinned buffers used in turn: the host fills one while the
            # device may still be reading the other's last upload.
            self.staging = [torch.zeros(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
        else:
            self.staging = [self.hr]  # the host writes the batch itself
        self.done: List[Optional[torch.cuda.Event]] = [None] * len(self.staging)
        self.uploads = 0
        body = _train_body if kind == "train" else _eval_body
        self.body = functools.partial(body, weakref.proxy(trainer), state, self.hr)
        self.graph: Optional[CapturedProgram] = None
        self.addresses: Tuple[int, ...] = ()
        if kind == "train":
            _init_adam_state(state.gen_opt)
            _init_adam_state(state.fnet_opt)

    def upload(self, batch: Batch) -> None:
        """Put the (B, T, tar, tar, 3) batch into the static buffer."""
        if torch.is_tensor(batch) and batch.device.type != "cpu":
            self.hr.copy_(batch)
            return
        i = self.uploads % len(self.staging)
        if self.done[i] is not None:
            self.done[i].synchronize()  # the device has read its last upload
        host = self.staging[i]
        if isinstance(batch, np.ndarray):
            host.numpy()[...] = batch
        else:
            host.copy_(batch)
        if host is not self.hr:
            self.hr.copy_(host, non_blocking=True)
            self.done[i] = torch.cuda.Event()
            self.done[i].record()
        self.uploads += 1

    def _addresses(self, trainer: "Trainer") -> Tuple[int, ...]:
        vgg = [] if trainer.vgg is None else list(trainer.vgg.parameters())
        return tuple(t.data_ptr() for t in [*state_tensors(self.state), *vgg])

    def _capture(self, trainer: "Trainer") -> None:
        """Warm up and capture the body; a train step's warm-up is undone:
        the state is saved before it and restored after the capture."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None
            trainer.recaptures += 1
        t0 = time.perf_counter()
        live = state_tensors(self.state) if self.kind == "train" else []
        with torch.no_grad():
            saved = [t.clone() for t in live]
        shape = tuple(self.hr.shape)
        self.graph = CapturedProgram(self.body, (self.hr,),
                                     name=f"Trainer.{self.kind}_step {shape} {self.hr.dtype}")
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        self.addresses = self._addresses(trainer)
        trainer.capture_s += time.perf_counter() - t0

    def run(self, trainer: "Trainer", batch: Batch) -> torch.Tensor:
        """One step on ``batch``: its metrics as one vector of its own."""
        self.upload(batch)
        if not trainer.capture:
            return self.body()
        if self.graph is None or self._addresses(trainer) != self.addresses:
            self._capture(trainer)
        return self.graph().clone()


class Trainer:
    """FRVSR or TecoGAN training on one device (``cuda`` or ``cpu``).
    ``vgg``: VGG19 weights for the perceptual loss, required when
    ``config.vgg_scaling > 0`` (:func:`~tecogan_tpu_torch.models.vgg19.load_vgg19_npz`
    or ``random_vgg19``); the module is moved to the device in place, as
    ``nn.Module.to`` moves it. ``capture``: None (the default) runs each
    step as a captured CUDA graph on the card and eagerly on the CPU; False
    runs eagerly on the card too; True on the CPU raises.

    ``capture_s`` sums the seconds spent warming up and capturing, and
    ``recaptures`` counts the captures made again because a state tensor
    had moved."""

    def __init__(self, config: TecoConfig, device: Union[str, torch.device],
                 vgg: Optional[VGG19Features] = None, capture: Optional[bool] = None):
        if config.vgg_scaling > 0 and vgg is None:
            raise ValueError("vgg_scaling > 0 requires VGG19 weights "
                             "(see tecogan_tpu_torch.models.vgg19.load_vgg19_npz)")
        if config.gan and not config.dt_mergeDs and config.d_layerloss:
            # The reference's pure-Dt branch defines no layer features
            # (Teco.py:265-292), so the combination has no semantics.
            raise ValueError("dt_mergeDs=False (pure temporal Dt) requires "
                             "d_layerloss=False (reference Teco.py:265-292 defines "
                             "no layer features on this branch)")
        self.config = config
        self.dtype = config.torch_dtype
        self.device = torch.device(device)
        self.capture = resolve_capture(capture, self.device)
        self.remat = resolve_remat(config)
        self.schedule = lr_schedule(config)
        self.vgg = None
        if config.vgg_scaling > 0:
            self.vgg = vgg.to(self.device, self.dtype, memory_format=self._memory_format)
        self._programs: Dict[Tuple, _Program] = {}
        self.capture_s = 0.0
        self.recaptures = 0

    @property
    def _memory_format(self):
        return (torch.channels_last if self.device.type == "cuda"
                else torch.preserve_format)

    # ------------------------------------------------------------ state
    def telemetry_keys(self) -> List[str]:
        """The loss EMAs' keys (``tecogan_tpu/train/trainer.py:216-235``)."""
        cfg = self.config
        keys = ["l2_content_loss", "l2_warp_loss", "All_loss_Gen"]
        if self.vgg is not None:
            keys += [f"vgg_loss_{i + 2}" for i in range(len(DEFAULT_FEATURE_KEYS))]
            keys += ["vgg_all"]
        if cfg.pingpong:
            keys += ["PingPang"]
        if cfg.gan:
            keys += ["t_adversarial_loss", "t_discrim_loss", "t_discrim_real_output",
                     "t_discrim_fake_output", "Dst_ratio"]
            if cfg.d_layerloss:
                keys += [f"D_layer_{i}_loss" for i in range(4)] + ["D_layer_loss_sum"]
        return keys

    def d_input_channels(self) -> int:
        """27 for the merged Dst, 9 for the pure temporal Dt."""
        return 27 if self.config.dt_mergeDs else 9

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at an int32 count on the device:
        ``optax.exponential_decay`` in float32 (the JAX package's schedule,
        ``tecogan_tpu/train/trainer.py:62-69``)."""
        cfg = self.config
        lr = torch.full((), cfg.learning_rate, dtype=torch.float32, device=count.device)
        if cfg.decay_step > 0:
            p = count.float() / cfg.decay_step
            if cfg.stair:
                p = torch.floor(p)
            lr = torch.where(count <= 0, lr, cfg.learning_rate * torch.pow(cfg.decay_rate, p))
        return lr

    def d_lr_schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The discriminator's learning rate at its Adam count, on the
        device: :meth:`lr_at`, x0.3 for the pure Dt
        (``tecogan_tpu/train/trainer.py:165-171``; reference Teco.py:423-424)."""
        lr = self.lr_at(count)
        return lr if self.config.dt_mergeDs else lr * 0.3

    def dt_ratio_at(self, step: torch.Tensor) -> torch.Tensor:
        """The adversarial terms' fade-in at an int32 step on the device,
        ``min(dt_ratio_max, dt_ratio_0 + dt_ratio_add * step)`` in float32
        (``tecogan_tpu/train/trainer.py:315-316``)."""
        cfg = self.config
        return (cfg.dt_ratio_0 + cfg.dt_ratio_add * step.float()).clamp_max(cfg.dt_ratio_max)

    def state_from_modules(self, generator: Generator, fnet: FNet,
                           discriminator: Optional[Discriminator] = None) -> TrainState:
        """A step-0 state around the given modules, moved to the device, with
        fresh optimizers and zero EMAs. TecoGAN mode needs the
        discriminator."""
        cfg = self.config
        generator = generator.to(self.device, torch.float32,
                                 memory_format=self._memory_format).train()
        fnet = fnet.to(self.device, torch.float32, memory_format=self._memory_format).train()

        # The learning rate is a float32 device tensor that each step writes
        # from the device step. On the card the Adams are capturable (step
        # counts on the device), captured or not, so both run the same
        # arithmetic; on the CPU a tensor rate needs capturable and foreach
        # off.
        on_card = self.device.type == "cuda"

        def adam(module):
            lr = torch.full((), self.schedule(0), dtype=torch.float32, device=self.device)
            return torch.optim.Adam(module.parameters(), lr=lr, betas=(cfg.beta1, 0.999),
                                    eps=cfg.adam_eps, foreach=on_card, capturable=on_card)

        state = TrainState(
            step=0, generator=generator, fnet=fnet,
            gen_opt=adam(generator), fnet_opt=adam(fnet),
            ema_losses={k: torch.zeros((), device=self.device)
                        for k in self.telemetry_keys()},
            device_step=torch.zeros((), dtype=torch.int32, device=self.device))
        if cfg.gan:
            if discriminator is None:
                raise ValueError("TecoGAN training (ratio > 0) needs a discriminator")
            channels = discriminator.input_stage_conv.in_channels
            if channels != self.d_input_channels():
                raise ValueError(f"the discriminator takes {channels} channels; "
                                 f"dt_mergeDs={cfg.dt_mergeDs} feeds it "
                                 f"{self.d_input_channels()}")
            state.discriminator = discriminator.to(
                self.device, torch.float32, memory_format=self._memory_format).train()
            state.d_opt = MaskedAdam(state.discriminator.parameters(), self.d_lr_schedule,
                                     b1=cfg.beta1, eps=cfg.adam_eps)
            state.ema_tbalance = torch.zeros((), device=self.device)
            state.counter_with_d = torch.zeros((), dtype=torch.int32, device=self.device)
            state.counter_wo_d = torch.zeros((), dtype=torch.int32, device=self.device)
        return state

    def init_state(self, seed: int) -> TrainState:
        """Fresh glorot-uniform weights (zero biases) drawn from ``seed``:
        the generator's, FNet's and, in TecoGAN mode, the discriminator's."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        generator = glorot_init_(Generator(cfg.num_resblock, cfg.gen_channels), gen)
        fnet = glorot_init_(FNet(cfg.fnet_channels, cfg.fnet_up_channels,
                                 cfg.flow_max_velocity), gen)
        disc = glorot_init_(Discriminator(self.d_input_channels()), gen) if cfg.gan else None
        return self.state_from_modules(generator, fnet, disc)

    # ------------------------------------------------------------ steps
    def _prepare(self, hr_seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r_inputs, r_targets = prepare_batch(hr_seq, self.config)
        if self.config.pingpong:
            r_inputs, r_targets = extend_pingpong(r_inputs), extend_pingpong(r_targets)
        return r_inputs, r_targets

    def _program(self, kind: str, state: TrainState, batch: Batch) -> _Program:
        if isinstance(batch, np.ndarray):
            dtype = torch.from_numpy(np.zeros(0, batch.dtype)).dtype
        else:
            dtype = batch.dtype
        key = (kind, id(state), tuple(batch.shape), dtype)
        prog = self._programs.get(key)
        if prog is None:  # the program holds its state: the id stays its own
            prog = self._programs[key] = _Program(self, state, kind, key[2], dtype)
        return prog

    def metric_keys(self, kind: str = "train") -> List[str]:
        """The order of the step's metric vector: the telemetry keys, and
        ``t_balance`` after a TecoGAN train step."""
        keys = self.telemetry_keys()
        return keys + ["t_balance"] if kind == "train" and self.config.gan else keys

    def pool_bytes(self) -> int:
        """Device bytes held by the captured programs' memory pools."""
        return sum(p.graph.pool_bytes() for p in self._programs.values()
                   if p.graph is not None)

    def _frozen_d(self, disc: Discriminator, x: torch.Tensor):
        """The discriminator at its current parameters taken as constants
        (no gradient reaches them), statistics not updated; its output in
        float32 (``tecogan_tpu/train/trainer.py:310-313``: in bfloat16 the
        logs' eps underflows)."""
        d, layers = cast_at_use(disc, self.dtype, detach=True)(x)
        return d.float(), layers

    def _backward_flows(self, fnet: Callable, r_inputs: torch.Tensor) -> torch.Tensor:
        """Without ping-pong, the triplets' backward flows: FNet on the
        (next, middle) pairs, HR (reference Teco.py:190-203). Detached where
        they are used, so computed without a graph."""
        b, t, h, w, c = r_inputs.shape
        t_size = 3 * (t // 3)
        nxt, mid = r_inputs[:, 2:t_size:3], r_inputs[:, 1:t_size:3]
        n = nxt.shape[1]
        with torch.no_grad():
            flow = fnet(torch.cat([nxt, mid], dim=-1).reshape(b * n, h, w, 2 * c))
            return upscale_flow(flow, h, w).reshape(b, n, 4 * h, 4 * w, 2)

    def _forward_losses(self, state: TrainState, r_inputs, r_targets
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        """The generator's loss, the metrics and, in TecoGAN mode, the
        discriminator step's inputs and ``t_balance``
        (``tecogan_tpu/train/trainer.py:238-343``)."""
        cfg = self.config
        fnet = cast_at_use(state.fnet, self.dtype)
        flow_lr, flow_hr = flows_for_sequence(fnet, r_inputs)
        gen_outputs, _ = unroll_generator(
            cast_at_use(state.generator, self.dtype), r_inputs, flow_hr,
            remat=self.remat and torch.is_grad_enabled(), with_warppre=False)
        b, t = gen_outputs.shape[:2]
        s_gen = gen_outputs.reshape(b * t, *gen_outputs.shape[2:])
        s_tar = r_targets.reshape(b * t, *r_targets.shape[2:])
        metrics = {
            "l2_content_loss": L.content_loss(s_gen, s_tar),
            "l2_warp_loss": L.warp_loss(r_inputs, flow_lr),
        }
        gen_loss = metrics["l2_content_loss"]
        if self.vgg is not None:
            vgg_total, per_layer = L.vgg_cosine_loss(
                vgg19_normalized_features(self.vgg, s_gen),
                vgg19_normalized_features(self.vgg, s_tar))
            gen_loss = gen_loss + cfg.vgg_scaling * vgg_total
            for i, v in enumerate(per_layer):
                metrics[f"vgg_loss_{i + 2}"] = v
            metrics["vgg_all"] = vgg_total
        if cfg.pingpong:
            pp = L.pingpong_loss(gen_outputs, cfg.rnn_n)
            if cfg.pp_scaling > 0:
                gen_loss = gen_loss + cfg.pp_scaling * pp
            metrics["PingPang"] = pp
        aux: Dict = {}
        if cfg.gan:
            flow_back = None if cfg.pingpong else self._backward_flows(fnet, r_inputs)
            real, fake = L.assemble_dst_inputs(r_inputs, r_targets, gen_outputs, flow_hr,
                                               cfg, flow_back)
            d_real, real_layers = self._frozen_d(state.discriminator, real)
            d_fake, fake_layers = self._frozen_d(state.discriminator, fake)
            adv = (-torch.log(d_fake + cfg.eps)).mean()
            dt_ratio = self.dt_ratio_at(state.device_step)
            gen_loss = gen_loss + cfg.ratio * adv * dt_ratio
            metrics["t_adversarial_loss"] = adv
            metrics["Dst_ratio"] = dt_ratio
            metrics["t_discrim_real_output"] = d_real.mean()
            metrics["t_discrim_fake_output"] = d_fake.mean()
            if cfg.d_layerloss:
                layer_sum, raw = L.d_layer_losses(real_layers, fake_layers,
                                                  cfg.d_layer_norm, cfg.d_layer_fix_range)
                gen_loss = gen_loss + layer_sum * dt_ratio
                for i, v in enumerate(raw):
                    metrics[f"D_layer_{i}_loss"] = v
                metrics["D_layer_loss_sum"] = layer_sum
            # t_balance drives the adaptive gate (reference Teco.py:397-399).
            aux = dict(t_balance=torch.log(d_real + cfg.eps).mean() + adv,
                       real=real, fake=fake)
            metrics["t_discrim_loss"] = d_loss(d_real, d_fake, cfg.eps)
        metrics["All_loss_Gen"] = gen_loss
        return gen_loss, metrics, aux

    def _d_step(self, state: TrainState, real: torch.Tensor, fake: torch.Tensor) -> None:
        """The discriminator's loss on detached inputs, its gradient and its
        gated update; the running statistics update on real, then on fake,
        whatever the gate (``tecogan_tpu/train/trainer.py:345-367,407-435``)."""
        cfg = self.config
        train_d = state.ema_tbalance < cfg.d_balance  # the EMA before this step
        disc = cast_at_use(state.discriminator, self.dtype)
        d_real, _ = disc(real.detach(), update_stats=True)
        d_fake, _ = disc(fake.detach(), update_stats=True)
        state.d_opt.zero_grad()
        d_loss(d_real.float(), d_fake.float(), cfg.eps).backward()
        state.d_opt.step(train_d)
        state.counter_with_d += train_d.int()
        state.counter_wo_d += (~train_d).int()

    def train_step(self, state: TrainState, hr_seq: Batch
                   ) -> Tuple[TrainState, Dict[str, Union[torch.Tensor, float]]]:
        """One update of G and FNet (and, gated, of the discriminator) from
        (B, T, tar, tar, 3) HR crops. Returns the (same, updated) state and
        the step's metrics as device scalars (views of one vector of their
        own, so they keep this step's values after the next), plus the
        step's ``learning_rate`` (a host float) and, in TecoGAN mode,
        ``t_balance``. The gradients stay in the parameters' ``.grad`` until
        the next step."""
        lr = self.schedule(state.step)
        vec = self._program("train", state, hr_seq).run(self, hr_seq)
        state.step += 1
        metrics: Dict[str, Union[torch.Tensor, float]] = dict(
            zip(self.metric_keys("train"), vec.unbind()))
        metrics["learning_rate"] = lr
        return state, metrics

    def eval_step(self, state: TrainState, hr_seq: Batch) -> Dict[str, torch.Tensor]:
        """Validation losses, no update (reference main.py:394-402)."""
        vec = self._program("eval", state, hr_seq).run(self, hr_seq)
        return dict(zip(self.metric_keys("eval"), vec.unbind()))

    @torch.no_grad()
    def generate(self, state: TrainState, hr_seq: Batch):
        """Forward-only sequences in [0, 1] for summaries (reference
        Teco.py:498-503): LR inputs, HR targets, generated frames and the
        warped previous outputs, of the batch's own T frames: as the JAX
        package's ``_generate_impl``, no ping-pong extension. Eager on every
        device: nothing on the training loop's path calls it (ROADMAP queue 1
        item 10)."""
        if isinstance(hr_seq, np.ndarray):
            hr_seq = torch.from_numpy(np.ascontiguousarray(hr_seq))
        r_inputs, r_targets = prepare_batch(hr_seq.to(self.device), self.config)
        _, flow_hr = flows_for_sequence(cast_at_use(state.fnet, self.dtype), r_inputs)
        gen_outputs, warppre = unroll_generator(cast_at_use(state.generator, self.dtype),
                                                r_inputs, flow_hr, remat=False)
        return r_inputs, deprocess(r_targets), deprocess(gen_outputs), deprocess(warppre)


def _train_body(trainer: Trainer, state: TrainState, hr: torch.Tensor) -> torch.Tensor:
    """One training step on the static batch ``hr``, all on the device and
    in place: the joint backward, both Adams at the device step's learning
    rate, the gated discriminator step, the EMAs and the device step.
    Returns the metrics in :meth:`Trainer.metric_keys` order as one vector."""
    cfg = trainer.config
    gen_loss, metrics, aux = trainer._forward_losses(state, *trainer._prepare(hr))
    # One joint backward, valid because the warp loss is G-free
    # (reference computes the two gradients separately, Teco.py:446-447).
    joint = gen_loss + cfg.warp_scaling * metrics["l2_warp_loss"]
    state.gen_opt.zero_grad(set_to_none=True)
    state.fnet_opt.zero_grad(set_to_none=True)
    joint.backward()
    lr = trainer.lr_at(state.device_step)
    for opt in (state.gen_opt, state.fnet_opt):
        for group in opt.param_groups:
            group["lr"].copy_(lr)
        opt.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    if cfg.gan:
        trainer._d_step(state, aux["real"], aux["fake"])
        metrics["t_balance"] = aux["t_balance"].detach()
    d = cfg.loss_ema_decay
    with torch.no_grad():
        if cfg.gan:
            state.ema_tbalance.copy_(d * state.ema_tbalance + (1 - d) * metrics["t_balance"])
        for k, ema in state.ema_losses.items():
            ema.copy_(d * ema + (1 - d) * metrics[k])
        state.device_step += 1
    return torch.stack([metrics[k] for k in trainer.metric_keys("train")])


@torch.no_grad()
def _eval_body(trainer: Trainer, state: TrainState, hr: torch.Tensor) -> torch.Tensor:
    """The validation losses on the static batch ``hr``, as one vector."""
    metrics = trainer._forward_losses(state, *trainer._prepare(hr))[1]
    return torch.stack([metrics[k] for k in trainer.metric_keys("eval")])


def d_loss(d_real: torch.Tensor, d_fake: torch.Tensor, eps: float) -> torch.Tensor:
    """The discriminator's loss, ``mean(-(log(1 - D(fake)) + log(D(real))))``
    with ``eps`` inside each log (reference Teco.py:392-396)."""
    return (-(torch.log(1 - d_fake + eps) + torch.log(d_real + eps))).mean()
