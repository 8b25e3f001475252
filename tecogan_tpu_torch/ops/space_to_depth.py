"""Space-to-depth / depth-to-space in ``tf.space_to_depth`` channel order
(counterpart of ``tecogan_tpu/ops/space_to_depth.py``).

Packed channel ``(r * block + s) * C + c`` holds pixel ``(block*i + r,
block*j + s)``, channel ``c`` (reference main.py:201, Teco.py:145-148).
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"({h}, {w}) is not divisible by block {block}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, c = x.shape
    if c % (block * block):
        raise ValueError(f"{c} channels do not divide into block {block}")
    co = c // (block * block)
    x = x.reshape(b, h, w, block, block, co)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * block, w * block, co)
