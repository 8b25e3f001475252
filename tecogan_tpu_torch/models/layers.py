"""Layer building blocks with reference-parity semantics (counterpart of
``tecogan_tpu/models/layers.py``; reference lib/ops.py:35-93).

Modules are NCHW, as PyTorch's convolutions are; the models feed them
channels-last views of NHWC tensors, so no layout copy is made.
"""

from __future__ import annotations

import functools
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


class StridedConv4(nn.Conv2d):
    """4x4 stride-2 conv without bias, TF SAME padding (the discriminator's
    blocks, reference Teco.py:54-67 via lib/ops.py:47-56).

    SAME pads ``(k - s) = 2`` rows for an even size, one before and one
    after: ``padding=1``. An odd size gets three, the extra one at the
    bottom (right), which no symmetric ``padding`` gives, so it is padded
    explicitly. The pure temporal discriminator reaches odd sizes (a 24 px
    box: 12, 6, 3)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % 2 == 0 and w % 2 == 0:
            return F.conv2d(x, self.weight, None, 2, 1)
        return super().forward(F.pad(x, (1, 1 + w % 2, 1, 1 + h % 2)))


class SlimBatchNorm(nn.Module):
    """``slim.batch_norm`` as the discriminator uses it (counterpart of
    ``tecogan_tpu/models/layers.py:190-208``; reference lib/ops.py:88-90):
    always the batch's statistics (the reference builds the discriminator
    with ``is_training=True``, Teco.py:38), eps 1e-3, a bias, no scale.

    The statistics are flax's: the variance is ``E[x^2] - E[x]^2`` clipped
    at 0 (biased), in float32 whatever x's dtype (``BatchNorm``'s
    ``force_float32_reductions``). As flax's, a bfloat16 x is normalised
    and its float32 bias added in float32, and only the result is rounded
    to x's dtype: in bfloat16, ``E[x^2] - E[x]^2`` would cancel to noise.
    The running statistics are a record only
    (nothing reads them here) and update with decay 0.9 from that biased
    variance, and only when ``update_stats`` is passed: the trainer updates
    them in its discriminator step and not in the forwards that feed the
    generator's losses. ``nn.BatchNorm2d`` differs in all three: its
    momentum is the complement (0.1), it folds in the unbiased variance,
    and train mode always updates."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        """(B, C, H, W) -> (B, C, H, W) in x's dtype."""
        dtype, x = x.dtype, x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        if update_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        scale = torch.rsqrt(var + self.eps)
        out = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return out.to(dtype)


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``."""
    return float(torch.tensor(value, dtype=dtype))


def lrelu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """LeakyReLU (reference lib/ops.py:84-85). The slope is rounded to x's
    dtype first, as the JAX package's ``alpha * x`` rounds a Python scalar:
    in bfloat16 it is 0.2001953125."""
    return F.leaky_relu(x, _in_dtype(alpha, x.dtype))


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
