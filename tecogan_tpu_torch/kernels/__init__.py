"""Hand-written CUDA kernels of the port (``csrc/``) and their wrappers.

Each wrapper runs its plain PyTorch version for a CPU tensor, launches its
kernel for a CUDA tensor (or raises), and counts its launches in an
integer attribute ``launches`` (through ``ops.count``, which also feeds the
:class:`LaunchRecord` of a CUDA graph's capture on the current stream,
whatever the thread: the graph adds those launches on every replay, so the
counters count the kernels that ran, captured or not). ``upsample4`` and
``resblock_chain`` are
differentiable (``torch.autograd.Function``s) on both devices. Importing
this package registers the launches as operators,
``torch.ops.tecogan_torch.{upsample4,upsample4_bwd,resblock_chain,nv12_rgb,
bias_relu_crop,warp_pack}`` (``ops.py``), which an exported program calls.
``nv12_to_rgb`` converts the frames that the card's NVDEC decodes
(``data/video_nvdec.py``); ``bias_relu_crop`` is the generator's transposed
convs' bias, ReLU and crop in one pass (``models/layers.py:Conv2Tran.
forward_relu``); ``warp_pack`` is the recurrent step's warp, space-to-depth
and input concat in one pass (``recurrent/step.py:generator_step``). None of
them replaces a TPU kernel.
"""

from tecogan_tpu_torch.kernels.epilogue import bias_relu_crop, bias_relu_crop_plain
from tecogan_tpu_torch.kernels.nv12 import nv12_to_rgb, nv12_to_rgb_plain, yuv_coefficients
from tecogan_tpu_torch.kernels.ops import LaunchRecord
from tecogan_tpu_torch.kernels.resblocks import (
    resblock_chain,
    resblock_chain_plain,
)
from tecogan_tpu_torch.kernels.upsample4 import (
    bicubic_four,
    upsample4,
    upsample4_bwd,
    upsample4_bwd_plain,
    upsample4_plain,
    upscale_bilinear4,
)
from tecogan_tpu_torch.kernels.warp_pack import warp_pack, warp_pack_plain

__all__ = [
    "LaunchRecord",
    "bias_relu_crop",
    "bias_relu_crop_plain",
    "bicubic_four",
    "nv12_to_rgb",
    "nv12_to_rgb_plain",
    "resblock_chain",
    "resblock_chain_plain",
    "upsample4",
    "upsample4_bwd",
    "upsample4_bwd_plain",
    "upsample4_plain",
    "upscale_bilinear4",
    "warp_pack",
    "warp_pack_plain",
    "yuv_coefficients",
]
