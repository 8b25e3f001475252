"""FNet, the optical-flow estimator (counterpart of
``tecogan_tpu/models/fnet.py``; reference lib/frvsr.py:4-41).

An encoder-decoder over ``concat(LR_{t-1}, LR_t)``: three down blocks
(conv3 + lrelu twice, 2x2 maxpool), three up blocks (conv3 + lrelu twice,
2x legacy-bilinear upsample), then conv3->32 + lrelu, conv3->2 and
``tanh * max_velocity``. The flow is in LR pixels, channel order (dy, dx),
on the //8-aligned grid; :func:`pad_flow_to` pads it back.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tecogan_tpu_torch.models.layers import conv2, lrelu, maxpool_2x2
from tecogan_tpu_torch.ops.resize import upscale_bilinear


class ConvPair(nn.Module):
    """conv3 + lrelu(0.2), twice."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv_1 = conv2(in_channels, channels)
        self.conv_2 = conv2(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.conv_2(lrelu(self.conv_1(x))))


class FNet(nn.Module):
    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 up_channels: Sequence[int] = (256, 128, 64),
                 max_velocity: float = 24.0, in_channels: int = 6):
        super().__init__()
        self.max_velocity = max_velocity
        self.encoders = nn.ModuleList()
        for ch in channels:
            self.encoders.append(ConvPair(in_channels, ch))
            in_channels = ch
        self.decoders = nn.ModuleList()
        for ch in up_channels:
            self.decoders.append(ConvPair(in_channels, ch))
            in_channels = ch
        self.output_conv1 = conv2(in_channels, 32)
        self.output_conv2 = conv2(32, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 6) -> (B, H//8*8, W//8*8, 2) flow in LR pixels."""
        net = x.to(self.output_conv2.weight.dtype).permute(0, 3, 1, 2)
        for block in self.encoders:
            net = maxpool_2x2(block(net))
        for block in self.decoders:
            up = upscale_bilinear(block(net).permute(0, 2, 3, 1), 2)
            net = up.permute(0, 3, 1, 2)
        net = self.output_conv2(lrelu(self.output_conv1(net)))
        return (torch.tanh(net) * self.max_velocity).permute(0, 2, 3, 1)


def pad_flow_to(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Symmetric-pad a (B, fh, fw, 2) flow at the bottom and right back to
    (h, w), as ``tf.pad(.., "SYMMETRIC")`` (reference main.py:188-190,212):
    the appended rows mirror the last ones, edge row included. ``F.pad``'s
    "reflect" would skip the edge, hence flip + cat."""
    fh, fw = flow.shape[1], flow.shape[2]
    if not (fh <= h <= 2 * fh and fw <= w <= 2 * fw):
        raise ValueError(f"cannot symmetric-pad ({fh}, {fw}) to ({h}, {w})")
    if h > fh:
        flow = torch.cat([flow, flow[:, 2 * fh - h:].flip(1)], dim=1)
    if w > fw:
        flow = torch.cat([flow, flow[:, :, 2 * fw - w:].flip(2)], dim=2)
    return flow
