"""The spatio-temporal discriminator Dst (counterpart of
``tecogan_tpu/models/discriminator.py:27-57``; reference lib/Teco.py:30-74).

- input stage: conv3 -> 64 + lrelu(0.2), no batch norm;
- blocks ``disblock_{1,3,5,7}`` (64, 64, 128, 256 channels): a 4x4 stride-2
  conv without bias, :class:`SlimBatchNorm` and lrelu(0.2); each block's
  activation is returned in ``layers`` for the feature-matching losses
  (reference Teco.py:280-313);
- head: a channel-wise dense layer (a 1x1 conv with bias) and a sigmoid.

The input has 27 channels for the merged Dst (the triplet, its warped
version and the upsampled LR triplet; reference Teco.py:233-247) or 9 for
the pure temporal Dt. Tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from tecogan_tpu_torch.models.layers import SlimBatchNorm, StridedConv4, conv2, lrelu

#: (reference scope index, output channels) of the four blocks; the odd
#: numbering is the reference's (disblock_1/3/5/7).
BLOCKS = ((1, 64), (3, 64), (5, 128), (7, 256))


class DisBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv = StridedConv4(in_channels, channels)
        self.bn = SlimBatchNorm(channels)


class Discriminator(nn.Module):
    def __init__(self, in_channels: int = 27):
        super().__init__()
        self.input_stage_conv = conv2(in_channels, 64)
        self.blocks = nn.ModuleList()
        in_channels = 64
        for _, ch in BLOCKS:
            self.blocks.append(DisBlock(in_channels, ch))
            in_channels = ch
        self.dense = nn.Conv2d(in_channels, 1, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, H, W, C) -> (B, H/16, W/16, 1) in (0, 1) (sizes rounded up at
        each block) and the four block activations, NHWC. ``update_stats``
        folds this batch's statistics into every block's running ones."""
        net = x.to(self.dense.weight.dtype).permute(0, 3, 1, 2)
        net = lrelu(self.input_stage_conv(net))
        layers = []
        for block in self.blocks:
            net = lrelu(block.bn(block.conv(net), update_stats))
            layers.append(net.permute(0, 2, 3, 1))
        return torch.sigmoid(self.dense(net)).permute(0, 2, 3, 1), layers
