"""Value-range transforms, BT.601 colour, PSNR and host image reading
(counterpart of ``tecogan_tpu/ops/image.py``; reference lib/ops.py:13-22,
259-269, dataloader.py:21-38, metrics.py:28-56)."""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch

# The BT.601 full -> studio swing RGB -> YCbCr transform of the eval
# protocol (reference metrics.py:39-44): matrix rows Y, Cb, Cr, and the
# offsets; ``eval/quality.py`` reads the same table.
YCBCR_BT601 = np.array([
    [0.256788235294118, 0.504129411764706, 0.097905882352941],
    [-0.148223529411765, -0.290992156862745, 0.439215686274510],
    [0.439215686274510, -0.367788235294118, -0.071427450980392],
])
YCBCR_BT601_OFFSET = np.array([16.0, 128.0, 128.0])
_Y_ROW = YCBCR_BT601[0]


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return image * 2 - 1


def deprocess(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (image + 1) / 2


def list_png_in_dir(dirpath: str, prefix_skip: str = "IB") -> List[str]:
    """The ``.png`` files of ``dirpath`` not starting with ``prefix_skip``,
    sorted by name and then (stably) by the number their digits spell;
    ``"\\x00"`` skips nothing (inference), ``"IB"`` the bicubic baselines
    (evaluation)."""
    files = sorted(f for f in os.listdir(dirpath)
                   if f.endswith(".png") and not f.startswith(prefix_skip))
    files.sort(key=lambda f: int("".join(filter(str.isdigit, f)) or -1))
    return [os.path.join(dirpath, f) for f in files]


def rgb_to_ycbcr_bt601(img):
    """(..., 3) RGB in 0-255 -> (..., 3) YCbCr (reference metrics.py:37-56):
    numpy in float64, a tensor in its own dtype."""
    if isinstance(img, torch.Tensor):
        t = torch.as_tensor(YCBCR_BT601.T, dtype=img.dtype, device=img.device)
        return img @ t + torch.as_tensor(YCBCR_BT601_OFFSET, dtype=img.dtype, device=img.device)
    return img @ YCBCR_BT601.T + YCBCR_BT601_OFFSET


def rgb_to_y_bt601(img):
    """The BT.601 luma of (..., 3) RGB in 0-255 (reference metrics.py:37-56):
    numpy in float64, a tensor in its own dtype."""
    if isinstance(img, torch.Tensor):
        return img @ torch.as_tensor(_Y_ROW, dtype=img.dtype, device=img.device) + 16.0
    return img @ _Y_ROW + 16.0


def load_img(path: str) -> np.ndarray:
    """A PNG as float32 (H, W, 3) RGB in [0, 1] (reference
    dataloader.py:31-38), decoded by the port's own codec as
    ``cv2.imread(path, 3)`` reads an 8-bit one: gray replicated, alpha
    dropped (``data/inference.py:read_rgb``)."""
    from tecogan_tpu_torch.data.inference import read_rgb

    return read_rgb(path).astype(np.float32) / 255.0


def compute_psnr(ref: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR of two [0, 1] images in float32, a 0-d tensor; identical images
    give inf (reference lib/ops.py:259-269)."""
    sqr = (target.float() - ref.float()).square().mean()
    return torch.where(sqr > 0, -10.0 * torch.log(sqr) / math.log(10.0),
                       torch.full_like(sqr, math.inf))
