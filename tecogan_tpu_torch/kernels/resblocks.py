"""The generator's residual-block chain (K3, K4 and K5 of the JAX package).

Replaces ``tecogan_tpu/kernels/resblocks.py``: ``_chain_kernel`` (K3, via
``_fused_chain_single``), ``_paired_kernel`` (K4) and ``_paired_kernel_v2``
(K5). The three compute one function, N blocks of
``x += conv3(relu(conv3(x, w1) + b1), w2) + b2`` with SAME padding; K4/K5
only repack it for the TPU's 128-lane matrix unit. Both CUDA kernels run
one launch per block, keep the conv1 output on chip, masked to zero
outside the image, and compute each conv as an implicit GEMM on the
tensor cores with float32 accumulation; see their headers.

In bfloat16 (``csrc/resblock_chain_mma.cu``, at the JAX kernel's rounding
points) both convs run as ``wgmma.m64n64k16`` with A and B in shared
memory: 32 FLOP per byte of shared memory, the SM's ratio of tensor-core
rate to shared-memory bandwidth (4,096 FLOP to 128 B a cycle), where the
earlier ``mma.sync`` + ``ldmatrix`` design brought 16-20 and stalled near
23% of the 989 TFLOP/s bound. An image row of 64 pixels of 128 B (one
flat row, the 128-byte swizzle's row) is one m64 tile, and tap (dy, dx) is
ring row dy with its start moved dx pixels: no copy per tap. TMA brings the
x rows (its zero fill is SAME padding) and both convs' weights, which stay
in shared memory; one persistent CTA per SM walks units of 60-column
strips over segments of rows (:func:`chain_plan`), a producer warp keeping
a 6-row x ring loaded while one warpgroup runs conv1 into a 4-row y ring
and another conv2 one row behind it. The bound is the tensor cores':
2·2·9·64·64 FLOP a pixel at 989 TFLOP/s. In float32
(``csrc/resblock_chain.cu``) each product is split into three TF32
products (``mma.sync``), which keeps float32 accuracy, on 8x16-pixel tiles
with a cluster of 4 CTAs per tile, each computing a quarter of the
channels.

Layout as in the JAX package: x (B, H, W, C), w1/w2 (N, 3, 3, C, C) HWIO,
b1/b2 (N, C). The kernels are specialised to C = 64, the TecoGAN width.

The launch is a registered operator, ``torch.ops.tecogan_torch.
resblock_chain`` (``kernels/ops.py``), with a fake kernel that gives its
output's shape, so ``torch.export`` traces through it; its ``launches``
counter is kept in the operator's body (``ops.count``), so an exported
program's replays count too, and a captured CUDA graph adds its launches on
every replay.

:func:`resblock_chain` is differentiable on both devices through one
``torch.autograd.Function``. Its forward takes the plain version
(:func:`resblock_chain_plain`, the counterpart of ``resblock_chain_xla``) for
a tensor on the CPU, and launches the kernel for a CUDA tensor or raises.
Its backward replays the plain chain on the saved inputs and differentiates
that, as the JAX package's ``_resblock_chain_bwd`` replays
``resblock_chain_xla``: the JAX package has no Pallas backward for the
chain, so on the card the backward is cuDNN's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tecogan_tpu_torch.kernels import _build, ops

KERNEL_CHANNELS = 64
_ENTRY = {torch.float32: "tt_resblock_chain_f32",
          torch.bfloat16: "tt_resblock_chain_bf16"}
# The bfloat16 kernel's strips: a flat row of 64 pixels (one wgmma M) gives
# 60 output columns; equal to ``TW`` in csrc/resblock_chain_mma.cu.
STRIP_COLS = 64 - 4


class ChainPlan(NamedTuple):
    """The bfloat16 kernel's tile walk: ``units`` strips-by-segments of
    ``seg_rows`` output rows (the last segment of a column may be shorter)
    over ``grid`` persistent CTAs."""
    strips: int
    seg_rows: int
    segs: int
    units: int
    grid: int


@functools.lru_cache(maxsize=None)
def chain_plan(b: int, h: int, w: int, sms: int) -> ChainPlan:
    """The tile walk for x (b, h, w, 64) on ``sms`` SMs, one CTA each.

    A unit of s output rows costs conv1 s + 2 rows and conv2 s, so a CTA's
    time grows as (units it walks) x (s + 1): the segment height is the one
    that makes ceil(units / sms) x (s + 1) least, the fewest units among
    equals. Whole columns when b x strips fill the card; at (1, 540, 960)
    on 132 SMs, 16 strips x 8 segments of 68 rows."""
    strips = -(-w // STRIP_COLS)
    best = None
    for segs in range(1, h + 1):
        rows = -(-h // segs)
        segs = -(-h // rows)
        units = b * strips * segs
        key = (-(-units // sms) * (rows + 1), units)
        if best is None or key < best[0]:
            best = (key, ChainPlan(strips, rows, segs, units, min(units, sms)))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resblock_chain_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: one ``F.conv2d`` pair per block, in x's dtype."""
    net = x.permute(0, 3, 1, 2)
    for i in range(w1.shape[0]):
        y = F.relu(F.conv2d(net, w1[i].permute(3, 2, 0, 1), b1[i], padding=1))
        net = net + F.conv2d(y, w2[i].permute(3, 2, 0, 1), b2[i], padding=1)
    return net.permute(0, 2, 3, 1)


def _check_cuda_args(x, w1, b1, w2, b2) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"resblock_chain takes float32 or bfloat16, not {x.dtype}")
    b, h, w, c = x.shape
    n = w1.shape[0]
    if c != KERNEL_CHANNELS:
        raise ValueError(f"the CUDA chain kernel is built for "
                         f"{KERNEL_CHANNELS} channels, got {c}")
    want = {"w1": (n, 3, 3, c, c), "w2": (n, 3, 3, c, c), "b1": (n, c), "b2": (n, c)}
    for name, t in zip(("w1", "b1", "w2", "b2"), (w1, b1, w2, b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("resblock_chain needs a contiguous NHWC tensor")
    if any(t.data_ptr() % 16 for t in (x, w1, b1, w2, b2)):
        raise ValueError("resblock_chain needs 16-byte aligned tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{x.device} is not the current CUDA device")


def _forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain chain on a CPU one: the body
    of ``tecogan_torch::resblock_chain`` (a new tensor, never a view of x)."""
    if x.device.type == "cpu":
        if w1.shape[0] == 0:
            return x.clone()
        return resblock_chain_plain(x, w1, b1, w2, b2)
    _check_cuda_args(x, w1, b1, w2, b2)
    n = w1.shape[0]
    if n == 0:
        return x.clone()
    b, h, w, _ = x.shape
    buf_a, buf_b = torch.empty_like(x), torch.empty_like(x)
    args = [x.data_ptr(), buf_a.data_ptr(), buf_b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), b, h, w, n]
    if x.dtype == torch.bfloat16:
        plan = chain_plan(b, h, w, _sm_count(x.device.index))
        args += [plan.seg_rows, plan.grid]
    err = getattr(_build.library(), _ENTRY[x.dtype])(
        *args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "resblock_chain")
    # One kernel launch per residual block.
    ops.count(resblock_chain, n)
    return buf_a if n % 2 else buf_b


class _ResblockChain(torch.autograd.Function):
    """Kernel forward; backward by replaying the plain chain (cuDNN on the
    card) under autograd, as ``_resblock_chain_bwd`` replays the XLA chain."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return torch.ops.tecogan_torch.resblock_chain(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = resblock_chain_plain(*inputs)
        # materialize_grads: with N = 0 the weights are unused; zeros then.
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], g, materialize_grads=True))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def resblock_chain(x, w1, b1, w2, b2) -> torch.Tensor:
    """N residual blocks over x (B, H, W, C); returns a new tensor.
    Differentiable in every argument; with no gradient to take, the
    operator is called without the autograd Function."""
    if x.dim() != 4 or w1.dim() != 5:
        raise ValueError(f"expected x (B, H, W, C) and w (N, 3, 3, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resblock_chain runs on cpu or cuda, not {x.device}")
    args = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ResblockChain.apply(*args)
    return torch.ops.tecogan_torch.resblock_chain(*args)


resblock_chain.launches = 0  # kernel launches (CUDA tensors only)


ops.register("resblock_chain(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
             "-> Tensor", _forward, lambda x, w1, b1, w2, b2: torch.empty_like(x))
