"""The generator's residual-block chain (K3, K4 and K5 of the JAX package).

Replaces ``tecogan_tpu/kernels/resblocks.py``: ``_chain_kernel`` (K3, via
``_fused_chain_single``), ``_paired_kernel`` (K4) and ``_paired_kernel_v2``
(K5). The three compute one function, N blocks of
``x += conv3(relu(conv3(x, w1) + b1), w2) + b2`` with SAME padding; K4/K5
only repack it for the TPU's 128-lane matrix unit. Both CUDA kernels run
one launch per block on 8x16-pixel tiles in shared memory, with the conv1
output kept on chip and masked to zero outside the image, as implicit
GEMMs on the tensor cores (``mma.sync``, float32 accumulation): in
bfloat16 (``csrc/resblock_chain_mma.cu``) at the JAX kernel's rounding
points; in float32 (``csrc/resblock_chain.cu``) with each product split
into three TF32 products, which keeps float32 accuracy, and a cluster of 4
CTAs per tile, each computing a quarter of the channels; see their headers.

Layout as in the JAX package: x (B, H, W, C), w1/w2 (N, 3, 3, C, C) HWIO,
b1/b2 (N, C). The kernel is specialised to C = 64, the TecoGAN width.

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

import torch
import torch.nn.functional as F

from tecogan_tpu_torch.kernels import _build, ops

KERNEL_CHANNELS = 64
_ENTRY = {torch.float32: "tt_resblock_chain_f32",
          torch.bfloat16: "tt_resblock_chain_bf16"}


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
    lib = _build.library()
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), buf_a.data_ptr(), buf_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), b, h, w, n,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "resblock_chain")
    ops.count(resblock_chain, n)  # one kernel launch per residual block
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
