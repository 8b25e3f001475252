"""Value-range transforms and the PNG listing (counterpart of
``tecogan_tpu/ops/image.py``; reference lib/ops.py:13-22,
dataloader.py:21-28, metrics.py:28-35)."""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

# The Y row of the BT.601 RGB -> YCbCr transform (reference metrics.py:42-44).
_Y_ROW = np.array([0.256788235294118, 0.504129411764706, 0.097905882352941])


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


def rgb_to_y_bt601(img):
    """The BT.601 luma of (..., 3) RGB in 0-255 (reference metrics.py:37-56):
    numpy in float64, a tensor in its own dtype."""
    if isinstance(img, torch.Tensor):
        return img @ torch.as_tensor(_Y_ROW, dtype=img.dtype, device=img.device) + 16.0
    return img @ _Y_ROW + 16.0
