"""Plain tensor ops of the port, NHWC like the JAX package's."""

from tecogan_tpu_torch.ops.blur import gaussian_blur_reflect101
from tecogan_tpu_torch.ops.gauss import gauss_down_by4
from tecogan_tpu_torch.ops.image import deprocess, list_png_in_dir, preprocess
from tecogan_tpu_torch.ops.resize import bicubic_four, resize_area, upscale_bilinear
from tecogan_tpu_torch.ops.space_to_depth import depth_to_space, space_to_depth
from tecogan_tpu_torch.ops.warp import (
    dense_image_warp,
    dense_image_warp_box,
    warp_space_to_depth,
)

__all__ = [
    "bicubic_four",
    "dense_image_warp",
    "dense_image_warp_box",
    "depth_to_space",
    "deprocess",
    "gauss_down_by4",
    "gaussian_blur_reflect101",
    "list_png_in_dir",
    "preprocess",
    "resize_area",
    "space_to_depth",
    "upscale_bilinear",
    "warp_space_to_depth",
]
