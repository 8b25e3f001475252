"""Image-quality metrics of the evaluation suite (counterpart of
``tecogan_tpu/eval/quality.py``; reference metrics.py:37-92). Host work in
numpy and scipy, as in the JAX package.

PSNR and SSIM are computed on the Y channel of a BT.601 YCbCr transform of
uint8-rounded images, after the ``crop_8x8`` centre crop to multiples of 32
with a margin of at least 16 px. SSIM is ``skimage``'s default path (7x7
uniform window, sample covariance, K1 = 0.01, K2 = 0.03, border crop of
(win - 1) // 2), called with ``data_range = Y_pred.max() - Y_pred.min()``
as the reference does (metrics.py:75).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import uniform_filter

from tecogan_tpu_torch.ops.image import YCBCR_BT601 as _T
from tecogan_tpu_torch.ops.image import YCBCR_BT601_OFFSET as _O


def rgb2ycbcr(img: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """(H, W, 3) RGB -> YCbCr (reference metrics.py:37-56)."""
    offset = _O / 255.0 if max_val == 1 else _O
    return img @ _T.T + offset


def to_uint8(x: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """Scale to [0, 255], round, clip; stays float (reference metrics.py:58-62)."""
    x = x.astype("float32")
    x = (x - vmin) / (vmax - vmin) * 255.0
    return np.clip(np.round(x), 0, 255)


def _y_channel(img: np.ndarray) -> np.ndarray:
    return rgb2ycbcr(to_uint8(img, 0, 255), 255)[:, :, 0]


def psnr(img_true: np.ndarray, img_pred: np.ndarray) -> float:
    """Y-channel PSNR (reference metrics.py:64-70); identical images give
    +inf."""
    diff = _y_channel(img_true) - _y_channel(img_pred)
    rmse = np.sqrt(np.mean(diff**2))
    if rmse == 0.0:
        return float("inf")
    return float(20 * np.log10(255.0 / rmse))


def ssim_y(y_true: np.ndarray, y_pred: np.ndarray, data_range: float,
           win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """skimage-default SSIM on 2-D float images (uniform 7x7 window)."""
    x = y_true.astype(np.float64)
    y = y_pred.astype(np.float64)
    np_pts = win_size**2
    cov_norm = np_pts / (np_pts - 1)  # sample covariance (skimage default)

    def f(a):
        return uniform_filter(a, size=win_size)

    ux, uy = f(x), f(y)
    uxx, uyy, uxy = f(x * x), f(y * y), f(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim(img_true: np.ndarray, img_pred: np.ndarray) -> float:
    """Y-channel SSIM with the reference's data_range (metrics.py:72-75)."""
    y_true = _y_channel(img_true)
    y_pred = _y_channel(img_pred)
    return ssim_y(y_true, y_pred, data_range=float(y_pred.max() - y_pred.min()))


def crop_8x8(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Centre-crop H and W to multiples of 32 keeping a margin of at least
    16 px (reference metrics.py:77-92; the name is the reference's)."""
    ori_h, ori_w = img.shape[0], img.shape[1]
    h = (ori_h // 32) * 32
    w = (ori_w // 32) * 32
    while h > ori_h - 16:
        h -= 32
    while w > ori_w - 16:
        w -= 32
    y = (ori_h - h) // 2
    x = (ori_w - w) // 2
    return img[y : y + h, x : x + w], y, x
