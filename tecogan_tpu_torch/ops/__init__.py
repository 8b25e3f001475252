"""Plain tensor ops of the port, NHWC like the JAX package's."""

from tecogan_tpu_torch.ops.blur import gaussian_blur_reflect101
from tecogan_tpu_torch.ops.gauss import gauss_down_by4, gaussian_kernel_2d
from tecogan_tpu_torch.ops.image import deprocess, list_png_in_dir, preprocess, rgb_to_y_bt601
from tecogan_tpu_torch.ops.resize import (
    bicubic_four,
    resize_area,
    upscale_bilinear,
    upscale_four,
)
from tecogan_tpu_torch.ops.space_to_depth import depth_to_space, space_to_depth
from tecogan_tpu_torch.ops.warp import (
    dense_image_warp,
    dense_image_warp_box,
    dense_image_warp_reference,
    warp_space_to_depth,
)

# The JAX package's names (``tecogan_tpu/ops/__init__.py``);
# gaussian_blur_reflect101, list_png_in_dir and resize_area are the port's
# own.
__all__ = [
    "upscale_bilinear",
    "upscale_four",
    "bicubic_four",
    "space_to_depth",
    "depth_to_space",
    "gaussian_kernel_2d",
    "gauss_down_by4",
    "dense_image_warp",
    "dense_image_warp_box",
    "dense_image_warp_reference",
    "warp_space_to_depth",
    "preprocess",
    "deprocess",
    "rgb_to_y_bt601",
]
