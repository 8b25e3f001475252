"""The recurrent VSR step (counterpart of ``tecogan_tpu/recurrent/step.py``;
reference main.py:194-216):

  flow_lr = fnet(concat(prev_lr, cur_lr))           # LR-pixel flow
  flow_hr = upsample4_bilinear(4 * pad(flow_lr))    # HR flow (kernel K1)
  packed  = space_to_depth(warp(prev_hr, flow_hr), 4)
  hr      = deprocess(generator(concat(cur_lr, packed)))

``prev_hr`` is kept deprocessed in [0, 1] (reference main.py:206-207).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tecogan_tpu_torch.kernels.upsample4 import upscale_bilinear4
from tecogan_tpu_torch.models.fnet import FNet, pad_flow_to
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.ops.image import deprocess
from tecogan_tpu_torch.ops.warp import warp_space_to_depth


class RecurrentState(NamedTuple):
    prev_lr: torch.Tensor  # (B, h, w, 3) in [0, 1]
    prev_hr: torch.Tensor  # (B, 4h, 4w, 3) in [0, 1]


def init_state(batch: int, h: int, w: int, dtype=torch.float32,
               device="cpu") -> RecurrentState:
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
    previous output, pack it, run the generator."""
    packed = warp_space_to_depth(state.prev_hr, flow_hr, 4)
    hr = deprocess(generator(torch.cat([lr_frame, packed], dim=-1)))
    return RecurrentState(prev_lr=lr_frame, prev_hr=hr), hr
