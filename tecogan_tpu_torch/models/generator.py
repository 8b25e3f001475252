"""The recurrent 4x super-resolution generator (counterpart of
``tecogan_tpu/models/generator.py:Generator``; reference lib/frvsr.py:44-88).

- input: LR frame (3 ch) + space-to-depth(warped previous HR, 4) (48 ch);
- conv3 -> 64 + ReLU;
- ``num_resblock`` residual blocks, run by the chain kernel
  (``kernels/resblocks.py``);
- two stride-2 transposed convs -> 64 + ReLU (4x), each with its bias,
  ReLU and crop in one pass where autograd records nothing
  (``Conv2Tran.forward_relu``), conv3 -> 3;
- plus the Catmull-Rom 4x upsample of the LR frame (``kernels/upsample4.py``);
- output mapped to [-1, 1].

The JAX package's folded-input, patchify, column-fold and fused-trunk
variants are TPU tuning and have no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tecogan_tpu_torch.kernels.resblocks import resblock_chain
from tecogan_tpu_torch.kernels.upsample4 import bicubic_four
from tecogan_tpu_torch.models.layers import Conv2Tran, conv2
from tecogan_tpu_torch.ops.image import preprocess


class ResBlock(nn.Module):
    """conv3-ReLU-conv3 + skip. Its convs are parameters only: the chain
    kernel computes the block."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_1 = conv2(channels, channels)
        self.conv_2 = conv2(channels, channels)


class Generator(nn.Module):
    def __init__(self, num_resblock: int = 16, channels: int = 64,
                 out_channels: int = 3):
        super().__init__()
        self.out_channels = out_channels
        self.input_stage_conv = conv2(17 * out_channels, channels)  # 3 + 48
        self.resblocks = nn.ModuleList(
            ResBlock(channels) for _ in range(num_resblock))
        self.conv_tran1 = Conv2Tran(channels, channels)
        self.conv_tran2 = Conv2Tran(channels, channels)
        self.output_stage_conv = conv2(channels, out_channels)

    def trunk_weights(self) -> Tuple[torch.Tensor, ...]:
        """The residual blocks' (w1, b1, w2, b2) in the chain kernel's
        layout: (N, 3, 3, C, C) HWIO kernels and (N, C) biases."""
        def kernels(convs):
            return torch.stack([c.weight for c in convs]).permute(
                0, 3, 4, 2, 1).contiguous()

        def biases(convs):
            return torch.stack([c.bias for c in convs])

        first = [b.conv_1 for b in self.resblocks]
        second = [b.conv_2 for b in self.resblocks]
        return kernels(first), biases(first), kernels(second), biases(second)

    def forward(self, x: torch.Tensor, lr: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """(B, H, W, 51) in [0, 1] -> (B, 4H, 4W, 3) in [-1, 1].

        ``lr``, if given, is x's first 3 channels as a tensor of its own,
        and the bicubic skip reads it. The training unroll passes the LR
        frame so: a slice of x would need a gradient through the warped
        channels, and the skip would run its backward only to throw it away.
        """
        # Cast at entry so the bicubic skip runs in the compute dtype too.
        dtype = self.input_stage_conv.weight.dtype
        x = x.to(dtype)
        lr = (x[..., :self.out_channels] if lr is None else lr.to(dtype)).contiguous()
        net = F.relu(self.input_stage_conv(x.permute(0, 3, 1, 2)))
        if len(self.resblocks):
            net = resblock_chain(net.permute(0, 2, 3, 1).contiguous(),
                                 *self.trunk_weights()).permute(0, 3, 1, 2)
        net = self.conv_tran1.forward_relu(net)
        net = self.conv_tran2.forward_relu(net)
        net = self.output_stage_conv(net).permute(0, 2, 3, 1)
        return preprocess(net + bicubic_four(lr))
