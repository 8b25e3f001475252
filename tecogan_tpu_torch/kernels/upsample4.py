"""K1: the fixed-stencil 4x upsample (bilinear / Catmull-Rom), NHWC.

Replaces ``tecogan_tpu/kernels/upsample4.py::_matmul_kernel`` (launched by
``_plane_call``), which runs ``out = Sh @ x @ Sw`` per channel plane on the
TPU's matrix unit. On the card the op is bound by memory (the output is 16x
the input and there are a few FMAs per byte), so the CUDA kernel
(``csrc/upsample4.cu``) applies the 4-phase stencil directly, one thread per
output element with coalesced stores; see its header.

On the streaming path it runs twice per chunk and frame: the bilinear form
upsamples the LR flow (with ``alpha=4`` folding the flow's x4 scale), the
bicubic form is the generator's residual skip.

:func:`upsample4` takes its plain version (``ops/resize.py``) for a tensor on
the CPU, and launches the kernel for a CUDA tensor or raises.
"""

from __future__ import annotations

import torch

from tecogan_tpu_torch.kernels import _build
from tecogan_tpu_torch.ops import resize

_FILTERS = {"bilinear": 0, "bicubic": 1}
_ENTRY = {torch.float32: "tt_upsample4_f32", torch.bfloat16: "tt_upsample4_bf16"}


def upsample4_plain(x: torch.Tensor, filter_: str = "bilinear",
                    alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: 4x upsample of ``alpha * x`` (B, H, W, C)."""
    if alpha != 1.0:
        x = x * alpha
    if filter_ == "bilinear":
        return resize.upscale_bilinear(x, 4)
    return resize.bicubic_four(x)


def upsample4(x: torch.Tensor, filter_: str = "bilinear",
              alpha: float = 1.0) -> torch.Tensor:
    """4x upsample of ``alpha * x``: (B, H, W, C) -> (B, 4H, 4W, C), float32
    or bfloat16; ``filter_`` is "bilinear" or "bicubic"."""
    if filter_ not in _FILTERS:
        raise ValueError(f"filter_={filter_!r}; expected one of {tuple(_FILTERS)}")
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return upsample4_plain(x, filter_, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"upsample4 runs on cpu or cuda, not {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"upsample4 takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upsample4 needs a contiguous NHWC tensor")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{x.device} is not the current CUDA device")
    if 16 * x.numel() >= 2**31:
        raise ValueError(f"{tuple(x.shape)} is too large for upsample4's "
                         "32-bit indexing; split the batch")
    b, h, w, c = x.shape
    out = torch.empty((b, 4 * h, 4 * w, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), out.data_ptr(), b, h, w, c, _FILTERS[filter_], alpha,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample4")
    upsample4.launches += 1
    return out


upsample4.launches = 0  # kernel launches (CUDA tensors only)


def upscale_bilinear4(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """4x legacy-TF bilinear upsample of ``alpha * x`` (the flow upsample)."""
    return upsample4(x, "bilinear", alpha)


def bicubic_four(x: torch.Tensor) -> torch.Tensor:
    """4x Catmull-Rom upsample (the generator's residual skip)."""
    return upsample4(x, "bicubic")
