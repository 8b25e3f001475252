"""FRVSR losses (counterpart of ``tecogan_tpu/train/losses.py:24-58``;
reference lib/Teco.py:318-372). The L2 losses are ``mean(sum(sq, channel))``,
i.e. 3x the plain MSE, as in the reference; the ping-pong loss is a plain L1
mean. The TecoGAN losses (VGG, discriminator) are not ported yet.
"""

from __future__ import annotations

import torch

from tecogan_tpu_torch.ops.warp import dense_image_warp


def content_loss(gen_outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """L2 content loss: mean over pixels of the channel-summed square
    (reference Teco.py:318-325)."""
    return (gen_outputs - targets).square().sum(dim=-1).mean()


def warp_loss(r_inputs: torch.Tensor, flow_lr: torch.Tensor) -> torch.Tensor:
    """FNet's warp loss in the LR domain: frame t-1 warped by the predicted
    flow against frame t (reference Teco.py:120-122,328-335).

    Args:
      r_inputs: (B, T, h, w, 3) LR frames in [0, 1].
      flow_lr: (B, T-1, h, w, 2) LR flows.
    """
    b, t, h, w, c = r_inputs.shape
    pre = r_inputs[:, :-1].reshape(b * (t - 1), h, w, c)
    cur = r_inputs[:, 1:].reshape(b * (t - 1), h, w, c)
    warped = dense_image_warp(pre, flow_lr.reshape(b * (t - 1), h, w, 2))
    return (cur - warped).square().sum(dim=-1).mean()


def pingpong_loss(gen_outputs: torch.Tensor, rnn_n: int) -> torch.Tensor:
    """L1 between the forward half of the ping-pong unroll and its reversed
    backward half, reduced in float32 (reference Teco.py:362-372)."""
    first = gen_outputs[:, :rnn_n - 1].float()
    last_rev = gen_outputs[:, -(rnn_n - 1):].flip(1).float()
    return (first - last_rev).abs().mean()
