"""The recurrent step's input in one pass (``csrc/warp_pack.cu``): the
backward warp of the previous HR frame, its 4x space-to-depth and the
concat with the LR frame, and its plain PyTorch version.

Replaces no TPU kernel (XLA fuses the JAX package's gather, lerp, pack and
concat). The plain route (``ops/warp.py:warp_space_to_depth`` and
``torch.cat``) runs some 36 ATen ops over the HR grid; the kernel reads the
flow, the corners it needs and the LR frame and writes the generator's
(B, H/4, W/4, 51) input once, at the plain route's rounding points: on the
card its output is bit-equal to the plain route's.

:func:`warp_pack` is a registered operator,
``torch.ops.tecogan_torch.warp_pack`` (``kernels/ops.py``): on a CPU tensor
it runs :func:`warp_pack_plain`, on a CUDA tensor it launches the kernel and
counts the launch in ``warp_pack.launches``. It has no gradient;
``recurrent/step.py:generator_step`` calls it only where autograd records
nothing.
"""

from __future__ import annotations

import torch

from tecogan_tpu_torch.kernels import _build, ops
from tecogan_tpu_torch.ops.warp import warp_space_to_depth

_ENTRY = {torch.float32: "tt_warp_pack_f32", torch.bfloat16: "tt_warp_pack_bf16"}
_BLOCK = 4  # the space-to-depth block
_INT32_MAX = 2 ** 31 - 1


def warp_pack_plain(lr: torch.Tensor, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_pack`."""
    return torch.cat([lr.to(image.dtype), warp_space_to_depth(image, flow, _BLOCK)], dim=-1)


def _check(lr: torch.Tensor, image: torch.Tensor, flow: torch.Tensor) -> None:
    """Raise on what the kernel does not take, on either device."""
    if image.dim() != 4 or image.shape[3] != 3:
        raise ValueError(f"warp_pack takes a (B, H, W, 3) image, not {tuple(image.shape)}")
    b, h, w, _ = image.shape
    if h % _BLOCK or w % _BLOCK or h < _BLOCK or w < _BLOCK:
        raise ValueError(f"image {tuple(image.shape)}: H and W must be positive multiples "
                         f"of {_BLOCK}")
    if tuple(flow.shape) != (b, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image {tuple(image.shape)}")
    if tuple(lr.shape) != (b, h // _BLOCK, w // _BLOCK, 3):
        raise ValueError(f"lr {tuple(lr.shape)} is not image {tuple(image.shape)} / {_BLOCK}")
    if image.dtype not in _ENTRY or lr.dtype != image.dtype or flow.dtype != image.dtype:
        raise TypeError(f"warp_pack takes float32 or bfloat16 lr, image and flow of one dtype, "
                        f"not {lr.dtype}, {image.dtype} and {flow.dtype}")
    if not lr.device == image.device == flow.device:
        raise ValueError(f"lr, image and flow are on {lr.device}, {image.device} and "
                         f"{flow.device}")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp_pack runs on cpu or cuda, not {image.device}")
    if not (lr.is_contiguous() and image.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp_pack needs contiguous lr, image and flow")
    # The kernel reads the image in 4-byte words (bfloat16 pairs) or values,
    # and a pixel's (dy, dx) as one 4- or 8-byte load.
    for name, t, align in (("image", image, 4), ("flow", flow, 2 * flow.element_size())):
        if t.data_ptr() % align:
            raise ValueError(f"warp_pack needs the {name} aligned to {align} bytes")
    if image.numel() > _INT32_MAX:
        raise ValueError(f"image {tuple(image.shape)} has more than 2^31 - 1 values: the "
                         f"kernel indexes in 32 bits")


def _shape(image: torch.Tensor):
    b, h, w, c = image.shape
    return b, h // _BLOCK, w // _BLOCK, (_BLOCK * _BLOCK + 1) * c


def _body(lr: torch.Tensor, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones: the body
    of ``tecogan_torch::warp_pack``."""
    _check(lr, image, flow)
    if image.device.type == "cpu":
        return warp_pack_plain(lr, image, flow)
    if image.device.index != torch.cuda.current_device():
        raise ValueError(f"{image.device} is not the current CUDA device")
    out = torch.empty(_shape(image), dtype=image.dtype, device=image.device)
    b, h, w, _ = image.shape
    err = getattr(_build.library(), _ENTRY[image.dtype])(
        lr.data_ptr(), image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "warp_pack")
    ops.count(warp_pack)
    return out


def _fake(lr, image, flow):
    return image.new_empty(_shape(image))


ops.register("warp_pack(Tensor lr, Tensor image, Tensor flow) -> Tensor", _body, _fake)


def warp_pack(lr: torch.Tensor, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``cat([lr, warp_space_to_depth(image, flow, 4)], -1)``: (B, H/4, W/4,
    3), (B, H, W, 3) and (B, H, W, 2) -> (B, H/4, W/4, 51), in one pass on
    the card. float32 or bfloat16, one dtype, one device, contiguous. No
    gradient."""
    return torch.ops.tecogan_torch.warp_pack(lr, image, flow)


warp_pack.launches = 0  # kernel launches (CUDA tensors only)
