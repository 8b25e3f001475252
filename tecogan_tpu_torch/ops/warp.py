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
are v5e gather tuning and are not carried over. :func:`dense_image_warp_box`
warps a window of the grid (the discriminator's crop box).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tecogan_tpu_torch.ops.space_to_depth import space_to_depth


def _corner_coords(
    h: int, w: int, flow: torch.Tensor, dtype: torch.dtype,
    origin: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped top-left corner indices and fractions in an (h, w) frame for
    a (B, bh, bw, 2) flow on the window at ``origin``. Coordinates are
    float32 even for a bfloat16 image: in bfloat16 the pixel grid is exact
    only up to 256. Only the fractions take ``dtype``."""
    flow = flow.to(torch.promote_types(flow.dtype, torch.float32))
    bh, bw = flow.shape[1], flow.shape[2]
    y0, x0 = origin
    grid_y = torch.arange(y0, y0 + bh, dtype=flow.dtype, device=flow.device)[None, :, None]
    grid_x = torch.arange(x0, x0 + bw, dtype=flow.dtype, device=flow.device)[None, None, :]
    qy = grid_y - flow[..., 0]
    qx = grid_x - flow[..., 1]
    fy = torch.floor(qy).clamp_(0.0, h - 2)
    fx = torch.floor(qx).clamp_(0.0, w - 2)
    ay = (qy - fy).clamp_(0.0, 1.0)[..., None].to(dtype)
    ax = (qx - fx).clamp_(0.0, 1.0)[..., None].to(dtype)
    return fy.long(), fx.long(), ay, ax


def dense_image_warp_box(
    image: torch.Tensor,
    flow: torch.Tensor,
    origin: Tuple[int, int],
) -> torch.Tensor:
    """Warp only a window of the grid, gathering from the whole source
    frame (counterpart of ``tecogan_tpu/ops/warp.py:590``):
    ``dense_image_warp(image, flow_full)[:, y0:y0+bh, x0:x0+bw]`` where
    ``flow`` is that window of ``flow_full``, with the same coordinates,
    clamps and lerp; the gather and its backward touch only the window.

    Args:
      image: (B, H, W, C) full source frames.
      flow: (B, bh, bw, 2) flow on the window, (dy, dx) order.
      origin: (y0, x0) of the window on the full grid.

    Returns:
      (B, bh, bw, C) warped window in the image's dtype.
    """
    b, h, w, c = image.shape
    bh, bw = flow.shape[1], flow.shape[2]
    y0, x0 = origin
    if flow.shape[0] != b or flow.shape[3] != 2 or not (
            0 <= y0 <= h - bh and 0 <= x0 <= w - bw):
        raise ValueError(f"flow {tuple(flow.shape)} at {origin} is not a window of "
                         f"image {tuple(image.shape)}")
    iy, ix, ay, ax = _corner_coords(h, w, flow, image.dtype, origin)
    flat = image.reshape(b * h * w, c)
    frame = torch.arange(b, device=image.device).view(b, 1, 1) * (h * w)
    base = (frame + iy * w + ix).reshape(-1)
    tl = flat.index_select(0, base).view(b, bh, bw, c)
    tr = flat.index_select(0, base + 1).view(b, bh, bw, c)
    bl = flat.index_select(0, base + w).view(b, bh, bw, c)
    br = flat.index_select(0, base + w + 1).view(b, bh, bw, c)
    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    return top + (bot - top) * ay


def dense_image_warp(
    image: torch.Tensor,
    flow: torch.Tensor,
    scale: float = 1.0,
    shift: float = 0.0,
) -> torch.Tensor:
    """Backward-warp ``image`` (B, H, W, C) by ``flow`` (B, H, W, 2), (dy, dx)
    order; returns ``scale * warped + shift`` in the image's dtype."""
    if flow.shape != (*image.shape[:3], 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(image.shape)}")
    out = dense_image_warp_box(image, flow, (0, 0))
    if scale != 1.0 or shift != 0.0:
        out = out * scale + shift
    return out


# The JAX package's direct 4-gather oracle (``tecogan_tpu/ops/warp.py:671``)
# is what the port's warp is: the same corners, clamps and lerp.
dense_image_warp_reference = dense_image_warp


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
