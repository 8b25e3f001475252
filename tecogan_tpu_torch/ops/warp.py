"""Dense backward image warping by a flow field (counterpart of
``tecogan_tpu/ops/warp.py``; replaces ``tf.contrib.image.dense_image_warp``,
reference main.py:215).

    output[b, y, x, c] = bilinear_sample(image[b], y - flow[b, y, x, 0],
                                                   x - flow[b, y, x, 1], c)

Per axis the floor coordinate is clamped into [0, size-2] before the
fraction is taken, and the fraction is clamped into [0, 1]: queries outside
the frame read the border (TF's ``_interpolate_bilinear``). This is a plain
gather of the four corners with the JAX package's own lerp, so the two
agree to rounding. The JAX blocking, per-image map and chunking thresholds
are v5e gather tuning and are not carried over.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tecogan_tpu_torch.ops.space_to_depth import space_to_depth


def _corner_coords(
    h: int, w: int, flow: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped top-left corner indices and fractions for a (B, H, W, 2)
    flow. Coordinates are float32 even for a bfloat16 image: in bfloat16
    the pixel grid is exact only up to 256. Only the fractions take
    ``dtype``."""
    flow = flow.to(torch.promote_types(flow.dtype, torch.float32))
    grid_y = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    grid_x = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    qy = grid_y - flow[..., 0]
    qx = grid_x - flow[..., 1]
    fy = torch.floor(qy).clamp_(0.0, h - 2)
    fx = torch.floor(qx).clamp_(0.0, w - 2)
    ay = (qy - fy).clamp_(0.0, 1.0)[..., None].to(dtype)
    ax = (qx - fx).clamp_(0.0, 1.0)[..., None].to(dtype)
    return fy.long(), fx.long(), ay, ax


def dense_image_warp(
    image: torch.Tensor,
    flow: torch.Tensor,
    scale: float = 1.0,
    shift: float = 0.0,
) -> torch.Tensor:
    """Backward-warp ``image`` (B, H, W, C) by ``flow`` (B, H, W, 2), (dy, dx)
    order; returns ``scale * warped + shift`` in the image's dtype."""
    b, h, w, c = image.shape
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(image.shape)}")
    iy, ix, ay, ax = _corner_coords(h, w, flow, image.dtype)
    flat = image.reshape(b * h * w, c)
    frame = torch.arange(b, device=image.device).view(b, 1, 1) * (h * w)
    base = (frame + iy * w + ix).reshape(-1)
    tl = flat.index_select(0, base).view(b, h, w, c)
    tr = flat.index_select(0, base + 1).view(b, h, w, c)
    bl = flat.index_select(0, base + w).view(b, h, w, c)
    br = flat.index_select(0, base + w + 1).view(b, h, w, c)
    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    out = top + (bot - top) * ay
    if scale != 1.0 or shift != 0.0:
        out = out * scale + shift
    return out


def warp_space_to_depth(
    image: torch.Tensor,
    flow: torch.Tensor,
    block: int = 4,
    scale: float = 1.0,
    shift: float = 0.0,
) -> torch.Tensor:
    """``space_to_depth(scale * dense_image_warp(image, flow) + shift)``:
    (B, H, W, C) -> (B, H/block, W/block, block*block*C)."""
    return space_to_depth(dense_image_warp(image, flow, scale, shift), block)
