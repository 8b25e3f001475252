"""The recurrent VSR step (counterpart of ``tecogan_tpu/recurrent/step.py``;
reference main.py:194-216):

  flow_lr = fnet(concat(prev_lr, cur_lr))           # LR-pixel flow
  flow_hr = upsample4_bilinear(4 * pad(flow_lr))    # HR flow (kernel K1)
  packed  = space_to_depth(warp(prev_hr, flow_hr), 4)
  hr      = deprocess(generator(concat(cur_lr, packed)))

``prev_hr`` is kept deprocessed in [0, 1] (reference main.py:206-207).

The training unroll (reference Teco.py:80-164) is :func:`flows_for_sequence`
(FNet over every adjacent pair at once) and :func:`unroll_generator` (the
recurrent generator, a Python loop over frames with optional per-frame
activation checkpointing), with :func:`extend_pingpong` for the 2N-1 frame
ping-pong sequence. Only the JAX package's packed warp + space-to-depth
unroll is ported; its folded-input and patchify modes are v5e tuning with
the same numbers.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tecogan_tpu_torch.kernels.upsample4 import upscale_bilinear4
from tecogan_tpu_torch.kernels.warp_pack import warp_pack
from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.ops.image import deprocess, preprocess
from tecogan_tpu_torch.ops.space_to_depth import depth_to_space
from tecogan_tpu_torch.ops.warp import warp_space_to_depth


class RecurrentState(NamedTuple):
    prev_lr: torch.Tensor  # (B, h, w, 3) in [0, 1]
    prev_hr: torch.Tensor  # (B, 4h, 4w, 3) in [0, 1]


def init_state(batch: int, h: int, w: int, dtype=torch.float32,
               device="cuda") -> RecurrentState:
    """Zero state (reference main.py:197-199)."""
    return RecurrentState(
        prev_lr=torch.zeros((batch, h, w, 3), dtype=dtype, device=device),
        prev_hr=torch.zeros((batch, 4 * h, 4 * w, 3), dtype=dtype, device=device),
    )


def upscale_flow(flow_lr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """LR flow -> HR flow: symmetric-pad to (h, w), scale by 4 and upsample
    4x with legacy-TF bilinear (reference main.py:212-213). The x4 is folded
    into the upsample kernel; it is exact in any float type."""
    return upscale_bilinear4(pad_flow_to(flow_lr, h, w).contiguous(), alpha=4.0)


def frame_step(generator: Generator, fnet: FNet, state: RecurrentState,
               lr_frame: torch.Tensor) -> Tuple[RecurrentState, torch.Tensor]:
    """Advance one frame; returns (new_state, hr_frame in [0, 1])."""
    _, h, w, _ = lr_frame.shape
    flow_lr = fnet(torch.cat([state.prev_lr, lr_frame], dim=-1))
    flow_hr = upscale_flow(flow_lr, h, w)
    return generator_step(generator, state, lr_frame, flow_hr)


def generator_step(generator: Generator, state: RecurrentState,
                   lr_frame: torch.Tensor, flow_hr: torch.Tensor
                   ) -> Tuple[RecurrentState, torch.Tensor]:
    """The recurrent half of a step, given the frame's HR flow: warp the
    previous output, pack it, run the generator. Where autograd records
    nothing (grad mode off, or no input needs a gradient) the warp, the pack
    and the concat are one pass (``kernels/warp_pack.py``)."""
    inputs = (lr_frame, state.prev_hr, flow_hr)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        x = torch.cat([lr_frame, warp_space_to_depth(state.prev_hr, flow_hr, 4)], dim=-1)
    else:
        x = warp_pack(*inputs)
    hr = deprocess(generator(x))
    return RecurrentState(prev_lr=lr_frame, prev_hr=hr), hr


def extend_pingpong(seq: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B, 2T-1, ...): the sequence, then reversed without
    its last frame (reference Teco.py:80-85)."""
    return torch.cat([seq, seq.flip(1)[:, 1:]], dim=1)


def flows_for_sequence(fnet: Callable[[torch.Tensor], torch.Tensor], r_inputs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNet over all B*(T-1) adjacent pairs of (B, T, h, w, 3) LR frames in
    one batch (reference Teco.py:102-115). ``fnet``: the module, or the
    trainer's cast of it (``train/trainer.py:cast_at_use``).

    Returns (B, T-1, h, w, 2) LR flows and (B, T-1, 4h, 4w, 2) HR flows.
    """
    b, t, h, w, c = r_inputs.shape
    pre = r_inputs[:, :-1].reshape(b * (t - 1), h, w, c)
    cur = r_inputs[:, 1:].reshape(b * (t - 1), h, w, c)
    flow_lr = fnet(torch.cat([pre, cur], dim=-1))
    flow_hr = upscale_flow(flow_lr, h, w)
    return (flow_lr.reshape(b, t - 1, h, w, 2),
            flow_hr.reshape(b, t - 1, 4 * h, 4 * w, 2))


def _generator_frame(generator: Callable, prev_out: torch.Tensor,
                     lr: torch.Tensor, flow: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unrolled frame: warp the previous output (in [-1, 1], deprocessed
    by the warp's affine), pack it and run the generator. Returns the new
    output and the packed warp."""
    packed = warp_space_to_depth(prev_out, flow, 4, scale=0.5, shift=0.5)
    return generator(torch.cat([lr.to(packed.dtype), packed], dim=-1), lr), packed


def unroll_generator(generator: Callable, r_inputs: torch.Tensor,
                     flow_hr: torch.Tensor, remat: bool = True,
                     with_warppre: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The recurrent generator over a sequence (reference Teco.py:125-164).

    Args:
      generator: the :class:`Generator`, or the trainer's cast of it
        (``train/trainer.py:cast_at_use``); a recompute calls the same
        object, so it reads the same cast parameters.
      r_inputs: (B, T, h, w, 3) LR frames in [0, 1].
      flow_hr: (B, T-1, 4h, 4w, 2) HR flows from :func:`flows_for_sequence`.
      remat: recompute each frame's warp and generator in the backward pass
        (``torch.utils.checkpoint``) instead of keeping its activations.
      with_warppre: also return the warped previous outputs (summaries
        only; the loss never reads them).

    Returns:
      (B, T, 4h, 4w, 3) outputs in [-1, 1], and the (B, T-1, 4h, 4w, 3)
      warped previous outputs in [-1, 1] or None.
    """
    b, t, h, w, _ = r_inputs.shape
    lr0 = r_inputs[:, 0]
    # Frame 0: zero recurrent features (reference Teco.py:127-133).
    zeros = torch.zeros((b, h, w, 48), dtype=r_inputs.dtype, device=r_inputs.device)
    outs: List[torch.Tensor] = [generator(torch.cat([lr0, zeros], dim=-1), lr0)]
    warppre: List[torch.Tensor] = []
    for i in range(1, t):
        args = (generator, outs[-1], r_inputs[:, i], flow_hr[:, i - 1])
        if remat:
            # The frame draws no random numbers: no RNG state to save, and
            # reading the CUDA generator's state is not allowed while a
            # training step is captured.
            out, packed = checkpoint(_generator_frame, *args, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            out, packed = _generator_frame(*args)
        outs.append(out)
        if with_warppre:
            warppre.append(preprocess(depth_to_space(packed, 4)))
    return (torch.stack(outs, dim=1),
            torch.stack(warppre, dim=1) if with_warppre else None)
