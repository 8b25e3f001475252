"""OpenCV's Gaussian blur of float images in torch (counterpart of the
``cv2.GaussianBlur`` calls in ``tecogan_tpu/data/inference.py:111-115``
and, through OpenCV's Farneback pyramid, ``tecogan_tpu/eval/suite.py``).

Not the training blur: ``ops/gauss.py:gauss_down_by4`` is TF's VALID
stride-4 conv and gives a smaller, shifted frame.

- :func:`gaussian_kernel` is ``cv2.getGaussianKernel(ksize, sigma,
  CV_32F)``: the fixed binomial taps for an odd size <= 7 when sigma <= 0,
  else a sampled Gaussian normalised in float64 (the centre tap counted
  once, the others twice, as OpenCV sums them), rounded to float32.
- :func:`sep_filter_reflect101` runs a symmetric 1-D kernel over the last
  two axes, rows first, with ``BORDER_REFLECT_101`` (``F.pad``'s
  ``reflect``). Each tap is a separate multiply and add in the input's
  dtype, so the CPU and a GPU give the same result. OpenCV's vectorised
  filter may fuse them (FMA): the two differ by float32 ulps (6.1e-5 at
  most on a 0-255 scale with sigma 1.5, measured against OpenCV 5.0).
- :func:`gaussian_blur_reflect101` is ``cv2.GaussianBlur(x, (0, 0),
  sigma)`` on a float image: ``ksize = round(sigma * 4 * 2 + 1) | 1``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` for an odd ``ksize``
    (and ``ksize`` <= 7 when sigma <= 0), as a float32 vector."""
    if sigma <= 0:
        if ksize not in _SMALL_GAUSSIAN:
            raise ValueError(f"sigma={sigma} needs ksize in {sorted(_SMALL_GAUSSIAN)}")
        return np.float32(_SMALL_GAUSSIAN[ksize])
    if ksize % 2 != 1:
        raise ValueError(f"ksize={ksize}: an odd size is needed")
    x = np.arange(1 - ksize, 0, 2, dtype=np.float64)  # twice the offsets left of centre
    side = np.exp(x * x * (-0.125 / (sigma * sigma)))
    taps = np.concatenate([side, [1.0], side[::-1]]) * (1.0 / (side.sum() * 2 + 1.0))
    return taps.astype(np.float32)


def sep_filter_reflect101(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Filter (..., H, W) with ``kernel`` along W, then along H."""
    r = len(kernel) // 2
    if r == 0:
        return x * float(kernel[0])
    lead = x.shape[:-2]
    x = x.reshape(-1, 1, *x.shape[-2:])
    for dim, pad in ((3, (r, r, 0, 0)), (2, (0, 0, r, r))):
        xp = F.pad(x, pad, mode="reflect")
        n = x.shape[dim]
        acc = xp.narrow(dim, 0, n) * float(kernel[0])
        for i in range(1, len(kernel)):
            acc = acc + xp.narrow(dim, i, n) * float(kernel[i])
        x = acc
    return x.reshape(*lead, *x.shape[-2:])


def gaussian_blur_reflect101(x: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigmaX=sigma)`` on float (..., H, W, C)
    images (NHWC, as the frames are held); returns the input's dtype."""
    kernel = gaussian_kernel(int(round(sigma * 4 * 2 + 1)) | 1, sigma)
    out = sep_filter_reflect101(x.movedim(-1, -3), kernel)
    return out.movedim(-3, -1)
