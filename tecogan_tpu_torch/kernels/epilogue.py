"""The transposed convs' epilogue: bias, ReLU and TF's SAME crop in one pass
(``csrc/bias_relu_crop.cu``), and its plain PyTorch version.

Replaces no TPU kernel (XLA fuses the bias and ReLU into the JAX package's
transposed conv). ``models/layers.py:Conv2Tran`` runs a padding-0 transposed
conv, whose output has one row and one column more than SAME keeps; with
the bias in the conv, ATen adds it in a pass of its own and ``F.relu``
reads the cropped view in another. Given the conv's output computed with
no bias, the kernel reads it once and writes ``relu(y[..., :-1, :-1] +
b)`` once, densely in ``channels_last``, at ATen's rounding points: on the
card its output is bit-equal to the two passes'.

:func:`bias_relu_crop` is a registered operator,
``torch.ops.tecogan_torch.bias_relu_crop`` (``kernels/ops.py``): on a CPU
tensor it runs :func:`bias_relu_crop_plain`, on a CUDA tensor it launches
the kernel and counts the launch in ``bias_relu_crop.launches``. It has no
gradient; ``Conv2Tran.forward_relu`` calls it only where autograd records
nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tecogan_tpu_torch.kernels import _build, ops

_ENTRY = {torch.float32: "tt_bias_relu_crop_f32", torch.bfloat16: "tt_bias_relu_crop_bf16"}
#: The kernel moves 16-byte vectors of channels.
_VECTOR_BYTES = 16
#: A block holds at most 256 vectors of one pixel.
_MAX_VECTORS = 256


def bias_relu_crop_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``relu(y[..., :-1, :-1] + bias)`` of a
    (B, C, H + 1, W + 1) conv output and a (C,) bias."""
    return F.relu(y[..., :-1, :-1] + bias.view(1, -1, 1, 1))


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"bias_relu_crop takes y (B, C, H + 1, W + 1) and bias (C,), not "
                         f"{tuple(y.shape)} and {tuple(bias.shape)}")
    if min(y.shape[2:]) < 1:
        raise ValueError(f"y {tuple(y.shape)} has no row or column to crop")
    if y.device != bias.device:
        raise ValueError(f"y is on {y.device} and bias on {bias.device}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bias_relu_crop runs on cpu or cuda, not {y.device}")


def _check_cuda(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dtype not in _ENTRY or bias.dtype != y.dtype:
        raise TypeError(f"bias_relu_crop takes float32 or bfloat16 y and bias of one dtype, "
                        f"not {y.dtype} and {bias.dtype}")
    vector = _VECTOR_BYTES // y.element_size()
    c = y.shape[1]
    if c % vector or c // vector > _MAX_VECTORS:
        raise ValueError(f"bias_relu_crop on the card takes a multiple of {vector} {y.dtype} "
                         f"channels, at most {vector * _MAX_VECTORS}, not {c}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bias_relu_crop needs y dense in channels_last (NHWC memory)")
    if not bias.is_contiguous():
        raise ValueError("bias_relu_crop needs a contiguous bias")
    if y.data_ptr() % _VECTOR_BYTES or bias.data_ptr() % _VECTOR_BYTES:
        raise ValueError(f"bias_relu_crop needs y and bias aligned to {_VECTOR_BYTES} bytes")
    if y.device.index != torch.cuda.current_device():
        raise ValueError(f"{y.device} is not the current CUDA device")


def _body(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones: the body
    of ``tecogan_torch::bias_relu_crop``."""
    _check(y, bias)
    if y.device.type == "cpu":
        return bias_relu_crop_plain(y, bias)
    _check_cuda(y, bias)
    b, c, h1, w1 = y.shape
    out = torch.empty((b, c, h1 - 1, w1 - 1), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    err = getattr(_build.library(), _ENTRY[y.dtype])(
        y.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h1 - 1, w1 - 1, c,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bias_relu_crop")
    ops.count(bias_relu_crop)
    return out


def _fake(y, bias):
    b, c, h1, w1 = y.shape
    return torch.empty((b, c, h1 - 1, w1 - 1), dtype=y.dtype, device=y.device,
                       memory_format=torch.channels_last)


ops.register("bias_relu_crop(Tensor y, Tensor bias) -> Tensor", _body, _fake)


def bias_relu_crop(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(y[..., :-1, :-1] + bias)``: (B, C, H + 1, W + 1) -> (B, C, H,
    W), float32 or bfloat16, ``y`` a padding-0 transposed conv's output
    computed with no bias. On the card ``y`` is dense in ``channels_last``,
    C a multiple of 8 (bfloat16) or 4 (float32), and the output is dense in
    ``channels_last``. No gradient."""
    return torch.ops.tecogan_torch.bias_relu_crop(y, bias)


bias_relu_crop.launches = 0  # kernel launches (CUDA tensors only)
