"""Layer building blocks with reference-parity semantics (counterpart of
``tecogan_tpu/models/layers.py``; reference lib/ops.py:35-93).

Modules are NCHW, as PyTorch's convolutions are; the models feed them
channels-last views of NHWC tensors, so no layout copy is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2(in_channels: int, out_channels: int) -> nn.Conv2d:
    """3x3 stride-1 SAME conv with bias (reference lib/ops.py:47-56)."""
    return nn.Conv2d(in_channels, out_channels, 3, padding=1)


class Conv2Tran(nn.ConvTranspose2d):
    """3x3 stride-2 SAME transposed conv, ``tf.nn.conv2d_transpose``
    semantics (reference lib/ops.py:35-44): output = 2 x input.

    A padding-0 transposed conv yields 2H+1 rows; TF's SAME result is its
    first 2H rows and columns. (``padding=1, output_padding=1`` shifts the
    taps by one pixel instead.)
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[..., :-1, :-1]


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """LeakyReLU (reference lib/ops.py:84-85)."""
    return F.leaky_relu(x, alpha)


def maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, flooring odd sizes like TF's VALID
    (reference lib/ops.py:92-93)."""
    return F.max_pool2d(x, 2)


@torch.no_grad()
def glorot_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform kernels and zero biases for every conv in ``module``,
    the reference's slim initialisers, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            receptive = m.weight[0, 0].numel()
            fan_sum = (m.weight.shape[0] + m.weight.shape[1]) * receptive
            limit = math.sqrt(6.0 / fan_sum)
            m.weight.uniform_(-limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module
