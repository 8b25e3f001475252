"""Gaussian blur + 4x downsampling, HR -> LR (counterpart of
``tecogan_tpu/ops/gauss.py``; reference ``tf_data_gaussDownby4``,
lib/ops.py:347-367): a fixed (1 + 2*int(3*sigma))-tap Gaussian applied per
channel as a stride-4 VALID convolution, computed as two separable
depthwise passes (H, then W) with the 2D normalisation split between them,
as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_taps(sigma: float) -> np.ndarray:
    """The 1D taps, each pass's share of the 2D normalisation (scipy's
    gaussian window, reference lib/ops.py:339-345)."""
    size = 1 + 2 * int(sigma * 3.0)
    n = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g1 = np.exp(-0.5 * (n / sigma) ** 2)
    taps = g1 / np.sqrt(np.outer(g1, g1).sum())
    taps.flags.writeable = False
    return taps


def gaussian_kernel_2d(size: int, sigma: float) -> np.ndarray:
    """The normalised (size, size) Gaussian kernel, float64 (scipy's
    gaussian window; reference lib/ops.py:339-345)."""
    n = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g1 = np.exp(-0.5 * (n / sigma) ** 2)
    g2 = np.outer(g1, g1)
    return g2 / g2.sum()


@functools.lru_cache(maxsize=None)
def _device_taps(sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The taps on ``device``, uploaded once: a captured training step
    cannot copy from pageable host memory."""
    return torch.tensor(_gaussian_taps(sigma), dtype=dtype, device=device)


def gauss_down_by4(hr: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-blur + stride-4 VALID downsample of (B, H, W, C): the output
    is ``(H - k + 4) // 4`` by ``(W - k + 4) // 4``, k the tap count, so an
    HR crop of ``4*crop + 2*int(3*sigma)`` gives an LR frame of ``crop``
    (reference dataloader.py:279-280)."""
    taps = _device_taps(sigma, hr.dtype, hr.device)
    k, c = taps.numel(), hr.shape[-1]
    net = hr.permute(0, 3, 1, 2)
    net = F.conv2d(net, taps.view(1, 1, k, 1).expand(c, 1, k, 1),
                   stride=(4, 1), groups=c)
    net = F.conv2d(net, taps.view(1, 1, 1, k).expand(c, 1, 1, k),
                   stride=(1, 4), groups=c)
    return net.permute(0, 2, 3, 1)
