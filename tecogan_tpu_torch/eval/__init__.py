"""The metrics suite of the port (counterpart of ``tecogan_tpu/eval``):
PSNR / SSIM / LPIPS / tOF / tLP100 with the reference's protocol
(reference metrics.py), a torch LPIPS and OpenCV's Farneback flow in torch.
Imports no JAX, no OpenCV and no pandas."""

from tecogan_tpu_torch.eval.farneback import farneback_flow, rgb_to_gray
from tecogan_tpu_torch.eval.lpips import (
    LPIPS,
    alexnet_features,
    default_lpips,
    lpips_distance,
    random_alexnet_params,
)
from tecogan_tpu_torch.eval.quality import crop_8x8, psnr, rgb2ycbcr, ssim, ssim_y, to_uint8
from tecogan_tpu_torch.eval.suite import evaluate_folders, write_csv
from tecogan_tpu_torch.utils.logging import Tee

# The JAX package's names (``tecogan_tpu/eval/__init__.py``); farneback_flow,
# rgb_to_gray, random_alexnet_params and write_csv are the port's own.
__all__ = [
    "LPIPS", "alexnet_features", "lpips_distance",
    "crop_8x8", "psnr", "rgb2ycbcr", "ssim", "ssim_y", "to_uint8",
    "Tee", "default_lpips", "evaluate_folders",
]
