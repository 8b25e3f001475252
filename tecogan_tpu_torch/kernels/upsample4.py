"""K1, the fixed-stencil 4x upsample (bilinear / Catmull-Rom), NHWC, and K2,
its adjoint.

K1 replaces ``tecogan_tpu/kernels/upsample4.py::_matmul_kernel`` (launched
by ``_plane_call``), which runs ``out = Sh @ x @ Sw`` per channel plane on
the TPU's matrix unit. On the card the op is bound by memory (the output is
16x the input and there are a few FMAs per byte), so the CUDA kernel
(``csrc/upsample4.cu``) applies the 4-phase stencil directly on tiles: a
block stages an input tile with its clamped halo in shared memory, runs the
H pass once per output row and input column, the W pass into the tile's
output rows, and writes them with 16-byte stores; see its header. It takes
at most :data:`MAX_CHANNELS` channels.

K2 replaces ``_down_kernel`` (launched by ``_plane_call_down`` from the
custom VJP ``_upsample4_bwd``): ``dx = Sh^T @ g @ Sw^T``, the 4x downsample
by the transposed stencil. Its CUDA kernel works on ``dx`` tiles too: a
block reads the ``g`` rows that feed its tile once, coalesced, keeps the
H-adjoint in shared memory and then applies the W-adjoint; no atomics. It
takes at most :data:`MAX_CHANNELS` channels as well.

On the streaming path K1 runs twice per chunk and frame: the bilinear form
upsamples the LR flow (with ``alpha=4`` folding the flow's x4 scale), the
bicubic form is the generator's residual skip. In training K2 is the
backward of the flow upsample, on FNet's gradient path (reference
Teco.py:113,446-447).

:func:`upsample4` is differentiable on both devices through one
``torch.autograd.Function``: forward K1 (plain version on the CPU),
backward ``alpha * K2(g)`` (:func:`upsample4_bwd_plain` on the CPU), and
only when the input needs a gradient. Each wrapper takes its plain version
for a tensor on the CPU, and launches its kernel for a CUDA tensor or
raises.

Each launch is a registered operator, ``torch.ops.tecogan_torch.upsample4``
and ``.upsample4_bwd`` (``kernels/ops.py``), with a fake kernel that gives
its output's shape, so ``torch.export`` traces through it and an exported
program replays it. The ``launches`` counters are kept in the operators'
bodies (``ops.count``), so an exported program's replays count too, and a
captured CUDA graph adds its launches on every replay.
"""

from __future__ import annotations

import torch

from tecogan_tpu_torch.kernels import _build, ops
from tecogan_tpu_torch.ops import resize

_FILTERS = {"bilinear": 0, "bicubic": 1}
#: K1 and K2 keep a tile's C channels in shared memory (the flow has 2, the
#: skip 3).
MAX_CHANNELS = 32
_ENTRY = {torch.float32: "tt_upsample4_f32", torch.bfloat16: "tt_upsample4_bf16"}
_ENTRY_BWD = {torch.float32: "tt_upsample4_bwd_f32",
              torch.bfloat16: "tt_upsample4_bwd_bf16"}


def upsample4_plain(x: torch.Tensor, filter_: str = "bilinear",
                    alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: 4x upsample of ``alpha * x`` (B, H, W, C)."""
    if alpha != 1.0:
        x = x * alpha
    if filter_ == "bilinear":
        return resize.upscale_bilinear(x, 4)
    return resize.bicubic_four(x)


def upsample4_bwd_plain(g: torch.Tensor, filter_: str = "bilinear",
                        alpha: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K2: ``alpha * Sh^T g Sw^T`` per plane,
    (B, 4H, 4W, C) -> (B, H, W, C). The H-adjoint sum is taken in float32
    and rounded to g's dtype, then the W-adjoint sum, times alpha, rounded
    again: the rounding point of ``_down_kernel`` and of the CUDA kernel."""
    b, h4, w4, c = g.shape
    sh = resize.stencil_matrix(h4 // 4, filter_, g.device)
    sw = resize.stencil_matrix(w4 // 4, filter_, g.device)
    hi = torch.einsum("byxc,yh->bhxc", g.float(), sh).to(g.dtype)
    dx = torch.einsum("bhxc,xw->bhwc", hi.float(), sw)
    if alpha != 1.0:
        dx = dx * alpha
    return dx.to(g.dtype)


def _check_cuda(t: torch.Tensor, what: str, index_span: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    if t.dtype not in _ENTRY:
        raise TypeError(f"{what} takes float32 or bfloat16, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} needs a contiguous NHWC tensor")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{t.device} is not the current CUDA device")
    if index_span >= 2**31:
        raise ValueError(f"{tuple(t.shape)} is too large for {what}'s "
                         "32-bit indexing; split the batch")


def _check_args(t: torch.Tensor, filter_: str) -> None:
    if filter_ not in _FILTERS:
        raise ValueError(f"filter_={filter_!r}; expected one of {tuple(_FILTERS)}")
    if t.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upsample4 runs on cpu or cuda, not {t.device}")


def _forward(x: torch.Tensor, filter_: str, alpha: float) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU one: the body of
    ``tecogan_torch::upsample4``."""
    if x.device.type == "cpu":
        return upsample4_plain(x, filter_, alpha)
    _check_cuda(x, "upsample4", 16 * x.numel())
    b, h, w, c = x.shape
    if c > MAX_CHANNELS or b > 65535:
        raise ValueError(f"upsample4 on the card takes at most {MAX_CHANNELS} channels "
                         f"and 65535 images, not {tuple(x.shape)}")
    out = torch.empty((b, 4 * h, 4 * w, c), dtype=x.dtype, device=x.device)
    err = getattr(_build.library(), _ENTRY[x.dtype])(
        x.data_ptr(), out.data_ptr(), b, h, w, c, _FILTERS[filter_], alpha,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample4")
    ops.count(upsample4)
    return out


def upsample4_bwd(g: torch.Tensor, filter_: str = "bilinear",
                  alpha: float = 1.0) -> torch.Tensor:
    """K2: the adjoint of :func:`upsample4`, ``alpha * Sh^T g Sw^T``:
    (B, 4H, 4W, C) -> (B, H, W, C), float32 or bfloat16."""
    _check_args(g, filter_)
    if g.shape[1] % 4 or g.shape[2] % 4:
        raise ValueError(f"g {tuple(g.shape)}: H and W must be multiples of 4")
    return torch.ops.tecogan_torch.upsample4_bwd(g, filter_, float(alpha))


def _backward(g: torch.Tensor, filter_: str, alpha: float) -> torch.Tensor:
    """K2 on a CUDA tensor, the plain version on a CPU one: the body of
    ``tecogan_torch::upsample4_bwd``."""
    if g.device.type == "cpu":
        return upsample4_bwd_plain(g, filter_, alpha)
    _check_cuda(g, "upsample4_bwd", g.numel())
    b, h4, w4, c = g.shape
    if c > MAX_CHANNELS or b > 65535:
        raise ValueError(f"upsample4_bwd on the card takes at most {MAX_CHANNELS} "
                         f"channels and 65535 images, not {tuple(g.shape)}")
    dx = torch.empty((b, h4 // 4, w4 // 4, c), dtype=g.dtype, device=g.device)
    err = getattr(_build.library(), _ENTRY_BWD[g.dtype])(
        g.data_ptr(), dx.data_ptr(), b, h4 // 4, w4 // 4, c, _FILTERS[filter_],
        alpha, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample4_bwd")
    ops.count(upsample4_bwd)
    return dx


upsample4_bwd.launches = 0  # kernel launches (CUDA tensors only)


class _Upsample4(torch.autograd.Function):
    """K1 forward, K2 backward (the op is linear, so no tensor is saved)."""

    @staticmethod
    def forward(ctx, x, filter_, alpha):
        ctx.filter_, ctx.alpha = filter_, alpha
        return torch.ops.tecogan_torch.upsample4(x, filter_, alpha)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return upsample4_bwd(g.contiguous(), ctx.filter_, ctx.alpha), None, None


def upsample4(x: torch.Tensor, filter_: str = "bilinear",
              alpha: float = 1.0) -> torch.Tensor:
    """4x upsample of ``alpha * x``: (B, H, W, C) -> (B, 4H, 4W, C), float32
    or bfloat16; ``filter_`` is "bilinear" or "bicubic". Differentiable;
    with no gradient to take, the operator is called without the autograd
    Function (``torch.export`` then sees the operator itself)."""
    _check_args(x, filter_)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample4.apply(x, filter_, float(alpha))
    return torch.ops.tecogan_torch.upsample4(x, filter_, float(alpha))


upsample4.launches = 0  # kernel launches (CUDA tensors only)


def upscale_bilinear4(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """4x legacy-TF bilinear upsample of ``alpha * x`` (the flow upsample)."""
    return upsample4(x, "bilinear", alpha)


def bicubic_four(x: torch.Tensor) -> torch.Tensor:
    """4x Catmull-Rom upsample (the generator's residual skip)."""
    return upsample4(x, "bicubic")


def _fake_upsample4(x, filter_, alpha):
    b, h, w, c = x.shape
    return x.new_empty((b, 4 * h, 4 * w, c))


def _fake_upsample4_bwd(g, filter_, alpha):
    b, h4, w4, c = g.shape
    return g.new_empty((b, h4 // 4, w4 // 4, c))


ops.register("upsample4(Tensor x, str filter_, float alpha) -> Tensor",
             _forward, _fake_upsample4)
ops.register("upsample4_bwd(Tensor g, str filter_, float alpha) -> Tensor",
             _backward, _fake_upsample4_bwd)
