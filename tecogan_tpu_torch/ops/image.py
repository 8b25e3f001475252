"""Value-range transforms (counterpart of ``tecogan_tpu/ops/image.py``;
reference lib/ops.py:13-22)."""

from __future__ import annotations

import torch


def preprocess(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return image * 2 - 1


def deprocess(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (image + 1) / 2
