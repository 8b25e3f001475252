"""The metrics suite of the port (counterpart of ``tecogan_tpu/eval``):
PSNR / SSIM / LPIPS / tOF / tLP100 with the reference's protocol
(reference metrics.py), a torch LPIPS and OpenCV's Farneback flow in torch.
Imports no JAX, no OpenCV and no pandas."""

from tecogan_tpu_torch.eval.farneback import farneback_flow, rgb_to_gray
from tecogan_tpu_torch.eval.lpips import LPIPS, default_lpips, random_alexnet_params
from tecogan_tpu_torch.eval.quality import crop_8x8, psnr, rgb2ycbcr, ssim, ssim_y, to_uint8
from tecogan_tpu_torch.eval.suite import evaluate_folders, write_csv

__all__ = [
    "LPIPS", "default_lpips", "random_alexnet_params",
    "farneback_flow", "rgb_to_gray",
    "crop_8x8", "psnr", "rgb2ycbcr", "ssim", "ssim_y", "to_uint8",
    "evaluate_folders", "write_csv",
]
