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

:func:`warp_space_to_depth_halo` is the fused warp + space-to-depth of an
H-sharded frame (``parallel/spatial.py``): each shard receives one band of
``int(max_displacement) + 1`` rows from each neighbour and gathers locally,
with its corners clamped on the global grid, so its output is bit-equal to
the unsharded warp's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

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
    return _gather_lerp(image, *_corner_coords(h, w, flow, image.dtype, origin))


def _gather_lerp(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                 ay: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """Bilinear blend of the four corners at ``(iy, ix)`` .. ``(iy + 1,
    ix + 1)`` of (B, H, W, C) ``image`` with fractions ``ay``, ``ax``."""
    b, h, w, c = image.shape
    bh, bw = iy.shape[1], iy.shape[2]
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


#: The flow bound of the streaming path: FNet's tanh-bounded 24 LR pixels,
#: 96 HR pixels (reference frvsr.py:39-40).
DEFAULT_MAX_DISPLACEMENT = 96.0


def warp_space_to_depth_halo_shards(
    images: Sequence[torch.Tensor],
    flows: Sequence[torch.Tensor],
    block: int = 4,
    scale: float = 1.0,
    shift: float = 0.0,
    max_displacement: float = DEFAULT_MAX_DISPLACEMENT,
) -> List[torch.Tensor]:
    """:func:`warp_space_to_depth` of an H-sharded frame, shard by shard:
    ``images[i]`` (B, h_i, W, C) and ``flows[i]`` (B, h_i, W, 2) are rows
    ``[r_i, r_i + h_i)`` of the frame, on shard i's device, in order.

    Each shard is extended by ``halo = int(max_displacement) + 1`` rows of
    each neighbour (copied to its device); at the frame's top and bottom
    there is nothing to receive. Corners are clamped on the global grid to
    ``[0, H-2]`` before they are made local, which is TF's edge clamp
    (reference dense_image_warp, Teco.py:119-122), so the output is
    bit-equal to the unsharded warp's wherever ``|flow| <= max_displacement``
    (a larger flow reads the nearest row of the band instead). Every shard
    must be taller than the halo and a multiple of ``block`` rows.

    Returns:
      per shard (B, h_i/block, W/block, block*block*C), on its device.
    """
    halo = int(max_displacement) + 1
    heights = [x.shape[1] for x in images]
    h, n = sum(heights), len(images)
    for hs in heights:
        if hs <= halo:
            raise ValueError(
                f"shard height {hs} must exceed halo {halo}; use fewer shards "
                f"(<= {h // (halo + 1)}) for {h}-row frames")
        if hs % block:
            raise ValueError(f"shard height {hs} is not a multiple of {block}")
    outs, r0 = [], 0
    for i, (image, flow) in enumerate(zip(images, flows)):
        parts = [image]
        e0 = r0  # the frame row of the extended shard's first row
        if i > 0:
            parts.insert(0, images[i - 1][:, -halo:].to(image.device))
            e0 -= halo
        if i < n - 1:
            parts.append(images[i + 1][:, :halo].to(image.device))
        ext = torch.cat(parts, dim=1) if len(parts) > 1 else image
        w = image.shape[2]
        iy, ix, ay, ax = _corner_coords(h, w, flow, image.dtype, (r0, 0))
        iy = (iy - e0).clamp_(0, ext.shape[1] - 2)
        out = _gather_lerp(ext, iy, ix, ay, ax)
        if scale != 1.0 or shift != 0.0:
            out = out * scale + shift
        outs.append(space_to_depth(out, block))
        r0 += image.shape[1]
    return outs


def warp_space_to_depth_halo(
    image: Union[torch.Tensor, Sequence[torch.Tensor]],
    flow: Union[torch.Tensor, Sequence[torch.Tensor]],
    mesh,
    axis: str,
    block: int = 4,
    scale: float = 1.0,
    shift: float = 0.0,
    max_displacement: float = DEFAULT_MAX_DISPLACEMENT,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """H-sharded fused warp + space-to-depth with a halo exchange
    (counterpart of ``tecogan_tpu/ops/warp.py:323``).

    ``image`` (B, H, W, C) and ``flow`` (B, H, W, 2) are split into equal
    row shards over the devices of ``mesh``'s ``axis``; H must divide into
    that many multiples of ``block`` and a shard must be taller than the
    halo, as in the JAX package. The shards run
    :func:`warp_space_to_depth_halo_shards` and the result, (B, H/block,
    W/block, block*block*C), is gathered on ``image``'s device. Lists of
    shards are taken as they are and given back as a list. The JAX
    version's row and column blocking is v5e gather tuning and is not
    ported.
    """
    if not torch.is_tensor(image):
        return warp_space_to_depth_halo_shards(image, flow, block, scale, shift,
                                               max_displacement)
    devices = mesh.axis_devices(axis)
    n, h = len(devices), image.shape[1]
    if h % (n * block) != 0:
        raise ValueError(f"H={h} must divide into {n} shards of {block}-multiples")
    hs = h // n
    outs = warp_space_to_depth_halo_shards(
        [image[:, i * hs:(i + 1) * hs].to(d) for i, d in enumerate(devices)],
        [flow[:, i * hs:(i + 1) * hs].to(d) for i, d in enumerate(devices)],
        block, scale, shift, max_displacement)
    return torch.cat([o.to(image.device) for o in outs], dim=1)
