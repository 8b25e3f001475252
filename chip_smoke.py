#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero):

1. versions, the card's name and power limit; no CUDA -> exit non-zero;
2. build the CUDA kernels from ``tecogan_tpu_torch/csrc`` with nvcc
   (``-Xptxas -v``), with the bfloat16 chain kernel's resident blocks per
   SM and the float32 chain kernel's cluster size and resident clusters;
3. each kernel against its plain PyTorch version on the card (K1, K2 the
   upsample's adjoint, the chain), at the streaming and training paths'
   shapes and a ragged one, float32 (TF32 off) and bfloat16, with the
   error beside its tolerance and CUDA-event times of the device's work
   (median and range of 5 alternating windows, each queued behind a
   device-side spin so the host's dispatch is not timed) of the kernel,
   its plain version and, where one PyTorch call computes the same
   function (``torch.einsum`` for K1 and K2; none for the chain), that
   call, with the bound (bytes over HBM's rate or operations over the
   units' peak, its arithmetic printed) and the kernel's share of it; K1
   also at the training path's shapes, (36,32,32,2) bilinear and
   (4,32,32,3) bicubic, and at TecoGAN training's, the flow
   (72,32,32,2) and the discriminator's bilinear LR triplets
   (24,32,32,9), alpha 1; K2 at (36,128,128,2) and (72,128,128,2); the
   chain also at the training shapes, (4,32,32,64) with N=10 (FRVSR) and
   N=16 (TecoGAN), the float32 one bound by its 3xTF32 tensor-core
   products; all of these in both dtypes (float32 and bfloat16
   training); untimed at two edge shapes; the bfloat16
   chain also, one block at three shapes, against its own rounding points
   in float32 (8e-3);
3b. the native data-loader core: the machine's toolchain (``<png.h>``,
   ``<zlib.h>``, ``ldconfig -p``'s libpng and libz) and the build of
   ``tecogan_tpu_torch/csrc/tecodata.cpp`` (its own PNG codec on zlib)
   with g++ into ``tecogan_tpu_torch/_build/``;
4. autograd: the upsample (both filters) and the chain on the card against
   the same functions on the CPU, gradients of every input, float32; K1
   and K2 also in bfloat16 at bfloat16 training's shapes (the backward is
   K2's bfloat16 entry);
5. the whole streaming path at full width (16 resblocks, 64 channels) on
   the GPU against the same seeded weights on the CPU (plain versions),
   float32, 6 frames of 64x96;
6. the streaming path at size: 46 uint8 frames of 144x180 -> 41 of
   576x720, bfloat16, chunks of 23, captured as one CUDA graph per chunk
   (the default on the card) and with ``capture=False`` in the same call:
   the two outputs bit-equal under cuDNN's deterministic algorithms; each
   mode's frames/s (runs in turns), launch counts (exactly 736 chain and 48
   K1 a run, the captured ones added per replay), peak memory and graph
   pool; then a ``torch.profiler`` split of one run of each (chain / K1 /
   cuDNN / glue, device idle share), whose chain (the tensor-core kernel)
   and K1 launches must equal the counters';
7. one FRVSR training step at full width (10 resblocks, real FNet),
   batch 2, 4 frames, crop 32, float32, GPU (the captured step, the
   default on the card) against CPU: losses and the gradient of every
   parameter;
7b. the same step in bfloat16 (float32 master weights), card against CPU,
   each held against the CPU's own bfloat16 error (its float32 step of
   phase 7): losses within max(1e-3 of scale, twice the CPU's gap), per
   parameter the gradient's relative error within twice the CPU's own
   plus 0.02 (median 0.08); only the kernels' bfloat16 entries ran, twice
   a step's launches (the capture's warm-up and one replay);
8. the training path at size through ``train.loop.train``: FRVSR_PRESET
   (batch 4, crop 32, 10 frames, 10 resblocks) on synthetic PNG scenes,
   captured (the default): 40 steps, then a resume to 45; then 15 steps
   with ``capture=False``; each mode's ms/step, frames/s, peak memory,
   graph pool and capture seconds, and exactly 100 chain, 11 K1 and 1 K2
   launches a step (twice that at a program's first step: its eager
   warm-up and one replay); the same state stepped 3 times captured and 3
   times eagerly, bit-equal in every state tensor under
   ``torch.use_deterministic_algorithms``; then both modes on one batch
   timed in turns (captured, eager, eager, captured) and one step of each
   under ``torch.profiler`` (device time, idle share, split; the profile's
   chain, which must be the float32 cluster kernel, K1 and K2 launches
   equal to the counters'). This phase runs with PyTorch's default
   precision flags (cuDNN in TF32), as the training CLI does; the
   comparisons before it with TF32 off;
8c. FRVSR_PRESET in bfloat16 through ``train()`` on phase 8's scenes,
   captured, 25 steps paced by the device (the gap between steps'
   starts, no synchronisation), exactly 100 chain, 11 K1 and 1 K2
   launches a step (twice at the first), only the bfloat16 library
   entries, the state float32; 3 captured against 3 eager steps
   bit-equal; the profile (the chain as ``resblock_kernel_mma``), and
   the paced ms/step, idle share, replay device time and split, the
   eager chain backward, peak and graph pool beside phase 8's and 8b's
   float32 numbers;
8b. where FRVSR_PRESET's ``train()`` loses time against its one-batch
   step: ``train()`` with the native executor (asserted to run), the
   python executor and a loader whose batches were all decoded before the
   first step, captured, each timed with a synchronisation around every
   step and paced by the device, with the uploads' and the loader waits'
   host time; one batch with no loader synchronised step by step and
   queued; the upload alone (``_Program.upload``); ms/step, frames/s and
   idle share against a replay's profiled device time;
9. the inference CLI and the metrics suite at the main path's width: 41
   synthetic 576x720 HR PNGs -> ``cli.main --mode inference
   --input_dir_HR`` (blur and 4x subsample on the card, 5 warm-up frames
   prepended, bfloat16, 16 resblocks, chunks of 23) -> 41 HR PNGs, with
   the kernels' launch counts (the run's and its capture's warm-up chunk:
   the CLI reaches the captured path), byte-equal to ``StreamingSR.run`` on
   the same LR frames (both under cuDNN's deterministic algorithms; a second,
   timed CLI run keeps the default flags); the blur on the card against the CPU; a ``--checkpoint``
   run on phase 8's checkpoint (10 blocks: the depth NOTE); ``cli.metrics``
   on the 41 outputs against their HR frames (tOF by the torch Farneback
   on the card); and ``evaluate_folders`` with a seeded random LPIPS on the
   card against the CPU on 8 frames. Prints the split of the CLI's wall
   time (decode + blur, stream, encode, flush) and the suite's seconds per
   frame; the CLI runs again with the native and the python PNG codec in
   turns, the native library's decode and encode counters asserted (41
   and 41 frames, or 0 and 0);
9b. the native PNG codec against ``data/png.py`` on the 41 576x720 PNGs
   (filter 0) and 8 Paeth-filtered ones: decode bit-equal, encode then
   ``read_png`` gives the input back, both codecs timed;
10. one TecoGAN step at full width (TECOGAN_PRESET's widths: 16 blocks,
   the real FNet, the merged Dst, VGG19 with seeded random weights), batch
   1, crop 32, 3 frames with ping-pong (5), float32 with TF32 off, GPU
   (captured) against CPU, with the discriminator's gate forced open and closed:
   every loss, every generator, FNet and discriminator gradient, the
   discriminator's running statistics after the step, and its parameters
   (moved when open, bit-unchanged when closed);
10b. the same step in bfloat16, gate open, card against CPU, as phase 7b
   (phase 10's CPU step the float32 yardstick);
11. TecoGAN training at size through ``train.loop.train``: TECOGAN_PRESET
   (batch 4, crop 32, 10 frames with ping-pong, 16 blocks) with random
   VGG19 weights on phase 8's scenes, warm-started from phase 8's
   10-block FRVSR checkpoint (reference case 3), captured: 20 steps and a
   resume to 25, then 10 steps with ``capture=False``, as phase 8 (exactly
   304 chain, 21 K1 and 1 K2 launches a step; the gate's counters; 3
   steps captured against 3 eager, bit-equal, D's statistics, Adam state
   and gate included); then the in-turn timing and the profiles (the
   eager step's split by module: VGG19's and the discriminator's kernels,
   attributed through their forwards and backwards; other cuDNN; K1 + K2;
   glue; Adam; the device idle share of each mode).
   Phase 10 switches TF32 off for its comparison; phase 11 runs with the
   default flags, as training does;
11b. TECOGAN_PRESET in bfloat16 through ``train()``, warm-started from
   phase 8's float32 FRVSR checkpoint, captured, 10 steps paced, exactly
   304 chain, 21 K1 and 1 K2 launches a step, the gate's counters, a
   replay's profile (``resblock_kernel_mma``), ms/step, device time,
   peak and pool beside phase 11's float32 numbers.

12. serving (``tecogan_tpu_torch.serve``): (a) a 3-slot ``VSRServer`` at
   full width, float32 with TF32 off, GPU against CPU with staggered
   attaches and an idle slot (outputs within PATH_TOL, the idle slot's
   state bit-unchanged on the card); (b) ``MultiGeometryServer`` in
   bfloat16, a 4-slot bucket at 144x180 and a bucket of two 120x180
   streams, each tick captured by the prewarm, 46 ticks with the kernels'
   launch counts (exactly 16 chain and 2 K1 per bucket tick), each
   bucket's graph pool, and an eviction whose bucket's pool leaves no
   device segment behind; then ``VSRServer`` pools of 1, 4 and 8 slots,
   captured and with ``capture=False``, timed in turns (ms/tick, host ms
   inside ``step()``, aggregate frames/s, peak memory, graph pool) and each
   profiled (device idle share; the chain, as ``resblock_kernel_mma``, and
   K1 launched as often as the counters say); (c) a 4-slot server's
   captured ticks bit-equal to ``capture=False`` ones at 144x180 under
   cuDNN's deterministic algorithms, and the frame step exported
   at (4,144,180) bfloat16, loaded in a fresh process that imports only
   torch and ``tecogan_tpu_torch.kernels``, bit-equal to a ``VSRServer``
   captured tick under
   cuDNN's deterministic algorithms, its launches counted; (d) ``cli.serve``
   on three LR PNG dirs (two geometries, one with Paeth rows): float32
   within 1 u8 level of ``cli.main --mode inference`` per dir (the random
   generator's recurrence damped, see ``run_serve_cli``), then timed
   bfloat16 runs with the native and the python PNG codec in turns, each
   with its wall split and the native library's counters asserted; and
   the PNG decode of a Paeth frame at 144x180 and 576x720; (e) the state
   budget counting a captured bucket's graph pool: under a budget below a
   4-slot 144x180 pool a 120x180 geometry is refused while that bucket is
   busy, and evicts it once idle. Phase 3 also times the chain N=16 at
   (4,144,180,64) and K1 at (4,144,180,2/3) in bfloat16, a serving tick's
   shapes.

Then one ``[yardstick]`` line per timed case of phase 3 with its wrapper's
launches on the streaming, FRVSR and TecoGAN training paths (float32 and
bfloat16) and per serving bucket tick. The
second-to-last line of stdout is a JSON object with one entry per kernel
(K1, K2 and the bfloat16 chain with a ``bf16_training`` entry);
the last is ``{"ok": true, "device": {...}}``. Imports no JAX.

``python3 chip_smoke.py --kernels-only`` stops after phase 3 and prints no
result line (for comparing two trees' kernels in one call).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# cuBLAS's deterministic workspace, for the phases that compare under
# torch.use_deterministic_algorithms; read when cuBLAS starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

REPO = Path(__file__).resolve().parent
LR_H, LR_W = 144, 180          # Vid4 calendar geometry (-> 576x720)
FRAMES, WARMUP, CHUNK = 46, 5, 23
NUM_RESBLOCK, CHANNELS = 16, 64

# Tolerances on max|kernel - plain| / max(1, max|plain|).
#   float32: same math; FMA contraction and summation order differ.
#   bfloat16: the kernels round once per pass/conv, the plain versions after
#   every op, so they may land 1-2 bfloat16 ulps (2^-8 relative) apart per
#   rounding, compounded over 16 blocks in the chain.
#   The bfloat16 chain against its own rounding points (chain_oracle_bf16),
#   one block: float32 sums in another order, which may flip a rounding of
#   y or of the output: ~2 bfloat16 ulps of the output's scale.
#   K1 in bfloat16 rounds where its plain version does, and every product
#   of a bfloat16 value and a dyadic tap weight is exact in float32, so
#   the two sum the same terms in the same order: bit-equal.
#   K2 sums up to 64 (bilinear) or 256 (bicubic) products per element where
#   the plain version runs two float32 matmuls: a few float32 ulps of O(10)
#   values; in bfloat16 both round after the H pass and at the end.
TOL = {("upsample4", torch.float32): 1e-6, ("upsample4", torch.bfloat16): 0.0,
       ("upsample4_bwd", torch.float32): 1e-5,
       ("upsample4_bwd", torch.bfloat16): 1e-2,
       ("resblock_chain", torch.float32): 1e-4,
       ("resblock_chain", torch.bfloat16): 5e-2,
       ("resblock_chain_oracle", torch.bfloat16): 8e-3}
# Autograd, CUDA vs CPU, max|diff| / max|CPU grad| per input: the
# upsample's gradient is K2 vs its plain version; the chain's is cuDNN vs
# the CPU's convolutions in another summation order, through 3 blocks. In
# bfloat16 (K1 and K2 at bfloat16 training's shapes) K2 and its plain
# version round after the H pass and at the end, float32 sums in another
# order between: K2's phase-3 tolerance.
GRAD_TOL = {("upsample4", torch.float32): 1e-5, ("upsample4", torch.bfloat16): 1e-2,
            ("resblock_chain", torch.float32): 1e-4}
# One FRVSR step, GPU vs CPU, float32: loss scalars relative; each
# parameter's gradient as max|diff| / max|CPU grad|.
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3
# The training path: FRVSR_PRESET, synthetic "natural" scenes; captured
# (the default), then a shorter eager run.
TRAIN_STEPS, RESUME_STEPS, SAVE_FREQ, EAGER_STEPS = 40, 45, 20, 15
# TecoGAN training (phase 11): TECOGAN_PRESET on the same scenes.
GAN_STEPS, GAN_RESUME_STEPS, GAN_EAGER_STEPS = 20, 25, 10
# Steps a window of the in-turn timing on one batch (profile_step).
PROFILE_STEPS = 5
# Profiles of one step taken to see every launch the counters count.
PROFILE_ATTEMPTS = 3
# Phase 10's parameters after one Adam step, GPU vs CPU, where the
# gradient stands clear of zero (above STEP_PARAM_MASK of its parameter's
# largest entry and 1e3 x Adam's eps): both moves are lr * sign(g) up to
# float32 rounding of the parameter.
STEP_PARAM_ATOL, STEP_PARAM_MASK = 1e-6, 1e-3
SCENE_FRAMES, SCENE_H, SCENE_W = 14, 240, 320
# Whole path, GPU kernels vs CPU plain versions, float32: the same tolerance
# as the chain (it dominates), relative to the output's scale.
PATH_TOL = 1e-3
# Serving (phase 12): slots of the calendar bucket, the second bucket's
# geometry (Vid4's foliage and walk) and the pool sizes timed; ticks per
# run, as phase 6's frames.
SERVE_SLOTS, SERVE_GEO2, SERVE_POOLS = 4, (120, 180), (1, 4, 8)
# Phase 12 (d)'s weights: the stem's weights on the warped previous output
# scaled by this (see run_serve_cli).
DAMP_WARPED = 0.1
# The CLI phase: 41 HR frames (46 with the 5 warm-up frames the CLI
# prepends: phase 6's 46 frames, 2 chunks); the suite card vs CPU on the
# first 8 frames (4 scored after CUTFR).
CLI_FRAMES, CLI_EVAL_FRAMES = FRAMES - WARMUP, 8
# The HR -> LR blur, card vs CPU, after / 255: the same taps in the same
# order, so float32 rounding at most.
BLUR_TOL = 1e-6
# LPIPS, tLP100 and tOF, card vs CPU, relative: float32 convolutions (cuDNN,
# TF32 off) in another summation order; the Farneback flows in the same
# elementwise order on both.
EVAL_TOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_fns(fns, windows: int = 5, reps: int = 20, warm: int = 10):
    """CUDA-event ms per call of each function, as (median, min, max) over
    `windows` windows of `reps` calls, after `warm` calls of each; the
    windows alternate the order (last to first, then first to last, ...),
    as plain, kernel, kernel, plain does for two.

    Each window starts behind a spin on the device (``torch.cuda._sleep``)
    1.5x as long as the host takes to queue the window's calls, so the
    events time the device running the calls back to back, not the host
    dispatching them (a small kernel takes less time on the card than its
    wrapper on the host)."""
    for f in reversed(fns):
        for _ in range(warm):
            f()
    torch.cuda.synchronize()
    spin = []
    for f in fns:
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        spin.append(int(1.5 * (time.perf_counter() - t0) * SPIN_CYCLES_PER_S))
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in range(windows):
        for k in (order[::-1] if i % 2 == 0 else order):
            torch.cuda._sleep(spin[k])
            start.record()
            for _ in range(reps):
                fns[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return [(float(np.median(t)), min(t), max(t)) for t in times]


# Clock cycles a second of the spin in time_fns: the H100 SXM's top SM
# clock, 1.98 GHz, so that a spin lasts at least as long as asked.
SPIN_CYCLES_PER_S = 1.98e9


# The bound of a timed case: the least time an H100 SXM could take for the
# same work, the larger of its bytes (each input read once, each output
# written once) over the HBM rate and its operations over the peak rate of
# the units that do them (NVIDIA's H100 SXM data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16 tensor cores": 989e12, "float32 CUDA cores": 67e12,
              "TF32 tensor cores": 495e12}


def bound(launches: int, bytes_: float, flops: float, unit: str):
    """(bound ms, "bytes" or "operations", its arithmetic) of `launches`
    launches that each move `bytes_` and do `flops` on `unit`; each launch
    is bound by the larger of its two times."""
    mem_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[unit] * 1e3
    by = "bytes" if mem_ms >= op_ms else "operations"
    per = f"{launches} launches x " if launches > 1 else ""
    text = (f"{per}max({bytes_ / 1e6:.2f} MB / 3.35 TB/s = {mem_ms:.5f} ms, "
            f"{flops / 1e9:.4f} GFLOP / {PEAK_FLOPS[unit] / 1e12:.0f} TFLOP/s "
            f"{unit} = {op_ms:.5f} ms)")
    return launches * max(mem_ms, op_ms), by, text


def upsample_bound(lr_elems: int, itemsize: int, nt: int):
    """K1 on x (B, H, W, C) of `lr_elems` elements, or K2 onto dx of that
    size, NT taps a pass: x and the 16x larger output (or g) once each; NT
    multiply-adds for each element of the H pass (4H x W) and of the W
    pass (4H x 4W): 40 NT flops per x element, in float32 on the CUDA
    cores."""
    return bound(1, 17 * lr_elems * itemsize, 40 * nt * lr_elems, "float32 CUDA cores")


def chain_bound(x: torch.Tensor, n: int):
    """n resblock launches on x (B, H, W, 64): each reads x, its 2 convs'
    weights and biases and writes its output; 2 x 9 x 64 x 64 multiply-adds
    per pixel and conv, on the tensor cores: once in bfloat16, three times
    in TF32 for float32 (the float32 kernel takes each product as three
    TF32 products to keep float32 accuracy)."""
    c, size = x.shape[-1], x.element_size()
    px = x.numel() // c
    bf16 = x.dtype == torch.bfloat16
    return bound(n, (2 * x.numel() + 2 * 9 * c * c + 2 * c) * size,
                 (1 if bf16 else 3) * 2 * 2 * 9 * c * c * px,
                 "bf16 tensor cores" if bf16 else "TF32 tensor cores")


def einsum_upsample(x: torch.Tensor, filter_: str, alpha: float):
    """The one PyTorch call that computes K1 (the yardstick; the port never
    calls it): out = Sh x Sw per plane, alpha folded into Sh (x4 is exact)."""
    from tecogan_tpu_torch.ops.resize import stencil_matrix

    _, h, w, _ = x.shape
    sh = (stencil_matrix(h, filter_, x.device) * alpha).to(x.dtype)
    sw = stencil_matrix(w, filter_, x.device).to(x.dtype)
    return lambda: torch.einsum("Hh,bhwc,Ww->bHWc", sh, x, sw)


def einsum_upsample_bwd(g: torch.Tensor, filter_: str, alpha: float):
    """The one PyTorch call that computes K2: dx = alpha Sh^T g Sw^T."""
    from tecogan_tpu_torch.ops.resize import stencil_matrix

    _, h4, w4, _ = g.shape
    sh = (stencil_matrix(h4 // 4, filter_, g.device) * alpha).to(g.dtype)
    sw = stencil_matrix(w4 // 4, filter_, g.device).to(g.dtype)
    return lambda: torch.einsum("Hh,bHWc,Ww->bhwc", sh, g, sw)


CHAIN_NO_LIBRARY = "no single call computes a residual block"
# A library call computes the kernel's function, in another rounding order:
# it must land within this share of the output's scale of the plain version.
LIBRARY_TOL = 5e-2


def chain_oracle_bf16(x, w1, b1, w2, b2) -> torch.Tensor:
    """The bfloat16 chain kernel's rounding points, repeated in float32 with
    TF32 off: per block, y = bf16(relu(conv1(x) + b1)) (zero padding, so y
    is zero outside the image), then x = bf16(x + conv2(y) + b2)."""
    def conv(t, w, b):
        return F.conv2d(t, w.float().permute(3, 2, 0, 1), b.float(), padding=1)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = x.float().permute(0, 3, 1, 2)
        for i in range(w1.shape[0]):
            y = F.relu(conv(net, w1[i], b1[i])).bfloat16().float()
            net = (net + conv(y, w2[i], b2[i])).bfloat16().float()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return net.permute(0, 2, 3, 1).bfloat16()


def rel_err(got: torch.Tensor, want: torch.Tensor):
    if not torch.isfinite(got).all():
        raise RuntimeError("kernel output has non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def seeded(shape, scale, gen, device, dtype):
    return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)


def check_kernels(dev):
    """Phase 3. Returns one record per timed case (the paths' shapes): its
    kernel, dtype, label, paths (of "streaming", "training" (FRVSR),
    "tecogan" and "serving"; none where no path runs that kernel at that
    shape or dtype), max abs error, the
    kernel's, the plain version's and the library call's ms (None with its
    reason where no one call computes the function) and the bound."""
    from tecogan_tpu_torch.kernels import (
        resblock_chain, resblock_chain_plain, upsample4, upsample4_bwd,
        upsample4_bwd_plain, upsample4_plain)

    gen = torch.Generator().manual_seed(3)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        bf16 = dtype == torch.bfloat16
        flow = seeded((CHUNK, LR_H, LR_W, 2), 8.0, gen, dev, dtype)
        lr = torch.rand((1, LR_H, LR_W, 3), generator=gen).to(dev, dtype)
        ragged = torch.rand((2, 37, 53, 3), generator=gen).to(dev, dtype)
        # (kernel, label, kernel fn, plain fn, timing) where timing is None
        # (untimed) or (path, library fn or its absence's reason, bound).
        cases = [
            ("upsample4", "bilinear flow x4 (23,144,180,2)",
             lambda: upsample4(flow, "bilinear", 4.0),
             lambda: upsample4_plain(flow, "bilinear", 4.0),
             ("streaming" if bf16 else None, einsum_upsample(flow, "bilinear", 4.0),
              upsample_bound(flow.numel(), flow.element_size(), 2))),
            ("upsample4", "bicubic skip (1,144,180,3)",
             lambda: upsample4(lr, "bicubic"),
             lambda: upsample4_plain(lr, "bicubic"),
             ("streaming" if bf16 else None, einsum_upsample(lr, "bicubic", 1.0),
              upsample_bound(lr.numel(), lr.element_size(), 4))),
        ]
        # K1 on the training path, in both dtypes (float32 and bfloat16
        # training): the flow upsample of flows_for_sequence
        # (B*(T-1) = 36 LR flows of a 32x32 crop, x4) and the generator's
        # skip at FRVSR_PRESET (batch 4). The bfloat16 ones draw from a
        # generator of their own, so the later cases keep their inputs.
        tgen = torch.Generator().manual_seed(12) if bf16 else gen
        flow_t = seeded((36, 32, 32, 2), 2.0, tgen, dev, dtype)
        lr_t = torch.rand((4, 32, 32, 3), generator=tgen).to(dev, dtype)
        # TecoGAN training (TECOGAN_PRESET, ping-pong: 19 frames): 72 LR
        # flows x4, and the Dst's 24 bilinear LR triplets (9 channels,
        # K1's generic-channel path), alpha 1.
        flow_g = seeded((72, 32, 32, 2), 2.0, tgen, dev, dtype)
        lr9 = torch.rand((24, 32, 32, 9), generator=tgen).to(dev, dtype)
        cases += [
            ("upsample4", "bilinear flow x4 TecoGAN (72,32,32,2)",
             lambda: upsample4(flow_g, "bilinear", 4.0),
             lambda: upsample4_plain(flow_g, "bilinear", 4.0),
             ("tecogan", einsum_upsample(flow_g, "bilinear", 4.0),
              upsample_bound(flow_g.numel(), flow_g.element_size(), 2))),
            ("upsample4", "bilinear LR triplets TecoGAN (24,32,32,9)",
             lambda: upsample4(lr9, "bilinear"),
             lambda: upsample4_plain(lr9, "bilinear"),
             ("tecogan", einsum_upsample(lr9, "bilinear", 1.0),
              upsample_bound(lr9.numel(), lr9.element_size(), 2))),
        ]
        cases += [
            ("upsample4", "bilinear flow x4 training (36,32,32,2)",
             lambda: upsample4(flow_t, "bilinear", 4.0),
             lambda: upsample4_plain(flow_t, "bilinear", 4.0),
             ("training", einsum_upsample(flow_t, "bilinear", 4.0),
              upsample_bound(flow_t.numel(), flow_t.element_size(), 2))),
            ("upsample4", "bicubic skip training (4,32,32,3)",
             lambda: upsample4(lr_t, "bicubic"),
             lambda: upsample4_plain(lr_t, "bicubic"),
             (("training", "tecogan"), einsum_upsample(lr_t, "bicubic", 1.0),
              upsample_bound(lr_t.numel(), lr_t.element_size(), 4))),
        ]
        if bf16:
            # Serving (phase 12): one tick of a 4-slot pool at the calendar
            # geometry runs K1 on the batch's flow and skip.
            flow_s = seeded((SERVE_SLOTS, LR_H, LR_W, 2), 8.0, gen, dev, dtype)
            lr_s = torch.rand((SERVE_SLOTS, LR_H, LR_W, 3), generator=gen).to(dev, dtype)
            cases += [
                ("upsample4", f"bilinear flow x4 serving ({SERVE_SLOTS},144,180,2)",
                 lambda: upsample4(flow_s, "bilinear", 4.0),
                 lambda: upsample4_plain(flow_s, "bilinear", 4.0),
                 ("serving", einsum_upsample(flow_s, "bilinear", 4.0),
                  upsample_bound(flow_s.numel(), flow_s.element_size(), 2))),
                ("upsample4", f"bicubic skip serving ({SERVE_SLOTS},144,180,3)",
                 lambda: upsample4(lr_s, "bicubic"),
                 lambda: upsample4_plain(lr_s, "bicubic"),
                 ("serving", einsum_upsample(lr_s, "bicubic", 1.0),
                  upsample_bound(lr_s.numel(), lr_s.element_size(), 4))),
            ]
        cases += [
            ("upsample4", "bilinear ragged (2,37,53,3)",
             lambda: upsample4(ragged, "bilinear"),
             lambda: upsample4_plain(ragged, "bilinear"), None),
            ("upsample4", "bicubic ragged (2,37,53,3)",
             lambda: upsample4(ragged, "bicubic"),
             lambda: upsample4_plain(ragged, "bicubic"), None),
        ]
        # K2 at the training paths' flow gradient (B*(T-1) = 36 pairs at
        # HR 128x128; TecoGAN's 72), in both dtypes, the streaming geometry
        # (no path) and a ragged shape.
        g_train = seeded((36, 128, 128, 2), 1.0, gen, dev, dtype)
        g_gan = seeded((72, 128, 128, 2), 1.0, gen, dev, dtype)
        g_stream = seeded((CHUNK, 4 * LR_H, 4 * LR_W, 2), 1.0, gen, dev, dtype)
        g_ragged = seeded((2, 148, 212, 3), 1.0, gen, dev, dtype)
        cases += [
            ("upsample4_bwd", "bilinear x4 training (36,128,128,2)",
             lambda: upsample4_bwd(g_train, "bilinear", 4.0),
             lambda: upsample4_bwd_plain(g_train, "bilinear", 4.0),
             ("training", einsum_upsample_bwd(g_train, "bilinear", 4.0),
              upsample_bound(g_train.numel() // 16, g_train.element_size(), 2))),
            ("upsample4_bwd", "bilinear x4 TecoGAN (72,128,128,2)",
             lambda: upsample4_bwd(g_gan, "bilinear", 4.0),
             lambda: upsample4_bwd_plain(g_gan, "bilinear", 4.0),
             ("tecogan", einsum_upsample_bwd(g_gan, "bilinear", 4.0),
              upsample_bound(g_gan.numel() // 16, g_gan.element_size(), 2))),
            ("upsample4_bwd", "bilinear x4 streaming (23,576,720,2)",
             lambda: upsample4_bwd(g_stream, "bilinear", 4.0),
             lambda: upsample4_bwd_plain(g_stream, "bilinear", 4.0),
             (None, einsum_upsample_bwd(g_stream, "bilinear", 4.0),
              upsample_bound(g_stream.numel() // 16, g_stream.element_size(), 2))),
            ("upsample4_bwd", "bilinear ragged (2,148,212,3)",
             lambda: upsample4_bwd(g_ragged, "bilinear"),
             lambda: upsample4_bwd_plain(g_ragged, "bilinear"), None),
            ("upsample4_bwd", "bicubic ragged (2,148,212,3)",
             lambda: upsample4_bwd(g_ragged, "bicubic"),
             lambda: upsample4_bwd_plain(g_ragged, "bicubic"), None),
        ]
        # Half the glorot-uniform scale: activations stay O(1) over 16
        # random blocks instead of growing ~1.5x per block. Streaming runs
        # the bfloat16 chain at N=16 on (1,144,180); training the chain of
        # its dtype on (4,32,32) (batch 4, LR crop 32) at N=10 (FRVSR_PRESET)
        # and N=16 (TECOGAN_PRESET).
        lim = 0.5 * (6.0 / (2 * 9 * CHANNELS)) ** 0.5
        chains = [(1, LR_H, LR_W, NUM_RESBLOCK, True, "streaming" if bf16 else None),
                  (2, 37, 53, 3, False, None), (1, 5, 7, 1, False, None)]
        if bf16:  # a serving tick of the 4-slot pool (phase 12)
            chains.append((SERVE_SLOTS, LR_H, LR_W, NUM_RESBLOCK, True, "serving"))
        chains += [(4, 32, 32, 10, True, "training"), (4, 32, 32, 16, True, "tecogan")]
        for b, h, w, n, timed, path in chains:
            x = torch.relu(seeded((b, h, w, CHANNELS), 1.0, gen, dev, dtype))
            args = (x, seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype),
                    seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype))
            cases.append(("resblock_chain", f"chain N={n} ({b},{h},{w},64)",
                          lambda a=args: resblock_chain(*a),
                          lambda a=args: resblock_chain_plain(*a),
                          (path, CHAIN_NO_LIBRARY, chain_bound(x, n)) if timed else None))
        if bf16:
            # One block against its rounding points (chain_oracle_bf16):
            # a dropped tap or a misplaced fragment row shows here.
            for b, h, w in ((1, LR_H, LR_W), (2, 37, 53), (1, 5, 7)):
                x = torch.relu(seeded((b, h, w, CHANNELS), 1.0, gen, dev, dtype))
                args = (x, *(seeded(s, k, gen, dev, dtype) for s, k in (
                    ((1, 3, 3, CHANNELS, CHANNELS), lim), ((1, CHANNELS), 0.1),
                    ((1, 3, 3, CHANNELS, CHANNELS), lim), ((1, CHANNELS), 0.1))))
                cases.append(("resblock_chain_oracle", f"chain N=1 ({b},{h},{w},64) "
                              "vs its rounding points", lambda a=args: resblock_chain(*a),
                              lambda a=args: chain_oracle_bf16(*a), None))
        for kernel, label, fn, plain_fn, timing in cases:
            got = fn()
            torch.cuda.synchronize()
            want = plain_fn()
            err, rel = rel_err(got, want)
            tol = TOL[(kernel, dtype)]
            line = f"[kernel] {kernel} {name} {label}: max_abs_err={err:.3e} " \
                   f"rel={rel:.3e} tol={tol:.0e}"
            if not rel <= tol:
                log(line)
                raise RuntimeError(f"{kernel} {name} {label}: rel error {rel:.3e} > {tol}")
            if timing is not None:
                path, lib, (bound_ms, bound_by, arithmetic) = timing
                fns = [fn, plain_fn] + ([lib] if callable(lib) else [])
                times = time_fns(fns)
                (ms, lo, hi), (plain_ms, plo, phi) = times[:2]
                line += (f" kernel_ms={ms:.4f} [{lo:.4f}-{hi:.4f}] plain_ms="
                         f"{plain_ms:.4f} [{plo:.4f}-{phi:.4f}]")
                if callable(lib):
                    lib_ms, llo, lhi = times[2]
                    _, lib_rel = rel_err(lib(), want)
                    line += (f" library_ms={lib_ms:.4f} [{llo:.4f}-{lhi:.4f}] (torch.einsum, "
                             f"rel {lib_rel:.1e} from plain)")
                    if not lib_rel <= LIBRARY_TOL:
                        log(line)
                        raise RuntimeError(f"{kernel} {name} {label}: the library call is "
                                           f"{lib_rel:.3e} from plain")
                else:
                    lib_ms = None
                    line += f" library_ms=None ({lib})"
                line += (f" (median [min-max]) bound_ms={bound_ms:.5f} by {bound_by}: "
                         f"{arithmetic}; share of bound {bound_ms / ms:.1%}")
                paths = [path] if isinstance(path, str) else list(path or ())
                line += f"; paths {', '.join(paths) or 'none at this shape and dtype'}"
                records.append(dict(kernel=kernel, dtype=name, label=label, paths=paths,
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by))
            log(line)
    return records


def check_autograd(dev) -> None:
    """Phase 4: each autograd Function on the card against the CPU; K1 and
    K2 also in bfloat16 at bfloat16 training's shapes (the flow, the skip,
    the Dst's LR triplets), where the backward is K2's bfloat16 entry."""
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4

    rng = np.random.RandomState(8)

    def arr(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    c, n = CHANNELS, 3
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("upsample4", f32, "bilinear alpha=4 (2,37,53,2)",
         lambda x: upsample4(x, "bilinear", 4.0), [arr((2, 37, 53, 2), 2.0)]),
        ("upsample4", f32, "bicubic (2,37,53,3)",
         lambda x: upsample4(x, "bicubic"), [arr((2, 37, 53, 3), 1.0)]),
        ("resblock_chain", f32, f"chain N={n} (2,37,53,{c})", resblock_chain,
         [arr((2, 37, 53, c), 0.5), arr((n, 3, 3, c, c), 0.04), arr((n, c), 0.1),
          arr((n, 3, 3, c, c), 0.04), arr((n, c), 0.1)]),
        ("upsample4", bf16, "bilinear alpha=4 training (36,32,32,2)",
         lambda x: upsample4(x, "bilinear", 4.0), [arr((36, 32, 32, 2), 0.5)]),
        ("upsample4", bf16, "bilinear alpha=4 TecoGAN (72,32,32,2)",
         lambda x: upsample4(x, "bilinear", 4.0), [arr((72, 32, 32, 2), 0.5)]),
        ("upsample4", bf16, "bicubic skip training (4,32,32,3)",
         lambda x: upsample4(x, "bicubic"), [arr((4, 32, 32, 3), 1.0)]),
        ("upsample4", bf16, "bilinear LR triplets TecoGAN (24,32,32,9)",
         lambda x: upsample4(x, "bilinear"), [arr((24, 32, 32, 9), 1.0)]),
    ]
    names = ("x", "w1", "b1", "w2", "b2")
    for kernel, dtype, label, fn, inputs in cases:
        grads = []
        dname = str(dtype).split(".")[-1]
        for device in (dev, torch.device("cpu")):
            xs = [t.to(device, dtype, copy=True).requires_grad_() for t in inputs]
            out = fn(*xs)
            if out.grad_fn is None or out.dtype != dtype:
                raise RuntimeError(f"[autograd] {label} on {device}: grad_fn "
                                   f"{out.grad_fn}, {out.dtype}")
            cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                                   .astype(np.float32)).to(device, dtype)
            raw = torch.autograd.grad(out, xs, cot)
            if any(g.dtype != dtype for g in raw):
                raise RuntimeError(f"[autograd] {label} on {device}: a gradient not in {dtype}")
            grads.append([g.float().cpu() for g in raw])
        tol = GRAD_TOL[(kernel, dtype)]
        for name, g_dev, g_cpu in zip(names, *grads):
            err = (g_dev - g_cpu).abs().max().item()
            rel = err / max(g_cpu.abs().max().item(), 1e-30)
            log(f"[autograd] {kernel} {dname} {label} d{name}: grad_fn ok, CUDA vs CPU "
                f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:.0e}")
            if not rel <= tol:
                raise RuntimeError(f"[autograd] {dname} {label} d{name}: {rel:.3e}")


def frvsr_batch(cfg, batch: int, seed: int) -> np.ndarray:
    """(batch, rnn_n, tar, tar, 3) uint8 HR crops: synthetic "natural" clips."""
    from tecogan_tpu_torch.data.synthetic import synthetic_clip

    tar = cfg.hr_load_size
    clips = [synthetic_clip(cfg.rnn_n, tar, tar, seed=seed + i, content="natural")
             for i in range(batch)]
    return (np.stack(clips) * 255).astype(np.uint8)


def fix_flows_mid_cell(state) -> None:
    """At the glorot init every flow is within ~1e-5 px of zero, so each
    warp query sits on a pixel boundary, where the flow's gradient jumps
    between two cells and a 1-ulp difference moves it. This bias and a 10x
    smaller output conv hold the HR flows at 1.43..1.53 / -2.52..-2.45 px
    (LR: a quarter), mid-cell. Measured on phase 7's batch: float32 vs
    float64 gradients then differ by 1.5e-4 of a parameter's largest
    entry, 6.2e-4 with the output conv as drawn (flows then cross pixel
    boundaries)."""
    with torch.no_grad():
        state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
        state.fnet.output_conv2.weight.mul_(0.1)


def check_step_vs_cpu(dev) -> dict:
    """Phase 7: one FRVSR step at full width, GPU against CPU, float32.
    Returns the CPU's losses and gradients (phase 7b's float32 yardstick)."""
    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.train import Trainer

    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    cfg = FRVSR_PRESET.replace(batch_size=2, rnn_n=4)
    batch = frvsr_batch(cfg, cfg.batch_size, 11)
    runs = []
    for device in (dev, torch.device("cpu")):
        trainer = Trainer(cfg, device)
        state = trainer.init_state(12)
        fix_flows_mid_cell(state)
        captures = CapturedProgram.captures
        t0 = time.perf_counter()
        _, metrics = trainer.train_step(state, batch)
        if trainer.capture != (device.type == "cuda") or \
                CapturedProgram.captures - captures != trainer.capture:
            raise RuntimeError(f"[step] {device}: capture {trainer.capture}, "
                               f"{CapturedProgram.captures - captures} captures")
        losses = {k: float(v) for k, v in metrics.items() if k != "learning_rate"}
        grads = {}
        for prefix, module in (("generator", state.generator), ("fnet", state.fnet)):
            for name, p in module.named_parameters():
                if p.grad is None:
                    raise RuntimeError(f"[step] {device}: {prefix}.{name} got no gradient")
                grads[f"{prefix}.{name}"] = p.grad.detach().cpu()
        log(f"[step] {device} ({'captured' if trainer.capture else 'eager'}): one step in "
            f"{time.perf_counter() - t0:.2f} s, "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(losses.items())))
        runs.append((losses, grads))
    (loss_gpu, grad_gpu), (loss_cpu, grad_cpu) = runs
    for k, want in loss_cpu.items():
        rel = abs(loss_gpu[k] - want) / abs(want)
        if not (math.isfinite(loss_gpu[k]) and rel <= STEP_LOSS_TOL):
            raise RuntimeError(f"[step] {k}: GPU {loss_gpu[k]} vs CPU {want} ({rel:.3e})")
    worst, worst_name = 0.0, ""
    for name, want in grad_cpu.items():
        scale = want.abs().max().item()
        if scale == 0.0 or grad_gpu[name].abs().max().item() == 0.0:
            raise RuntimeError(f"[step] {name}: zero gradient")
        rel = (grad_gpu[name] - want).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= STEP_GRAD_TOL:
            raise RuntimeError(f"[step] {name}: gradient rel error {rel:.3e}")
    log(f"[step] GPU (the captured step) vs CPU, float32, {cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, {cfg.rnn_n} frames, crop {cfg.crop_size}: "
        f"losses within {STEP_LOSS_TOL:.0e}; {len(grad_cpu)} parameters, every "
        f"gradient non-zero, worst rel {worst:.3e} ({worst_name}) tol {STEP_GRAD_TOL:.0e}")
    return dict(losses=loss_cpu, grads=grad_cpu)


@contextlib.contextmanager
def timed_train_steps(kernels):
    """Time each ``Trainer.train_step`` between two synchronisations (loader
    waits, saves, summaries and validation fall outside) and count each
    kernel wrapper's launches inside it. Yields the three lists it fills:
    seconds, {kernel: launches} per step, and the trainers that stepped."""
    from tecogan_tpu_torch.train import Trainer

    step_secs, step_launches, trainers = [], [], []
    train_step = Trainer.train_step

    def timed_step(self, state, hr_seq):
        if self not in trainers:
            trainers.append(self)
        torch.cuda.synchronize()
        before = {name: k.launches for name, k in kernels.items()}
        start = time.perf_counter()
        result = train_step(self, state, hr_seq)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - start)
        step_launches.append({name: k.launches - before[name] for name, k in kernels.items()})
        return result

    Trainer.train_step = timed_step
    try:
        yield step_secs, step_launches, trainers
    finally:
        Trainer.train_step = train_step


def step_launch_want(cfg):
    """The kernel launches of one training step: the chain once a block and
    frame, K1 for the flow, each frame's bicubic skip and (TecoGAN) the
    Dst's LR triplets, K2 once for the flow's backward."""
    return {"resblock_chain": cfg.num_resblock * cfg.unroll_frames,
            "upsample4": cfg.unroll_frames + 1 + int(cfg.gan), "upsample4_bwd": 1}


def check_step_launches(step_launches, capturing, want, label) -> None:
    """Exactly ``want`` launches a step; twice that at the steps in
    ``capturing`` (a program's first step: its eager warm-up, then one
    replay; the capture itself launches nothing)."""
    for i, got in enumerate(step_launches):
        need = {k: n * (2 if i in capturing else 1) for k, n in want.items()}
        if got != need:
            raise RuntimeError(f"{label} step {i + 1}: launches {got}, want {need}")


def check_captured_equals_eager(dev, cfg, label: str, vgg=None, steps: int = 3) -> None:
    """The same initial state stepped ``steps`` times by the captured
    program and by the eager step on the same batches, under
    ``torch.use_deterministic_algorithms`` and cuDNN's deterministic
    algorithms: every state tensor (weights, Adam moments and counts, the
    learning rates, EMAs, the device step; in TecoGAN mode the
    discriminator's statistics, its Adam state, the gate's EMA and
    counters) must end bit-equal."""
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.trainer import named_state_tensors

    batches = [frvsr_batch(cfg, cfg.batch_size, 41 + i) for i in range(steps)]
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    finals = {}
    try:
        for capture in (None, False):
            trainer = Trainer(cfg, dev, vgg=None if vgg is None else vgg(), capture=capture)
            state = trainer.init_state(cfg.rand_seed)
            for batch in batches:
                trainer.train_step(state, batch)
            finals[trainer.capture] = [(n, t.detach().clone())
                                       for n, t in named_state_tensors(state)]
            del trainer, state
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
    captured, eager = finals[True], finals[False]
    if [n for n, _ in captured] != [n for n, _ in eager]:
        raise RuntimeError(f"{label} captured vs eager: the states hold other tensors")
    differ = [(n, (a.double() - b.double()).abs().max().item())
              for (n, a), (_, b) in zip(captured, eager) if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"{label} captured vs eager after {steps} steps: {len(differ)} of "
                           f"{len(captured)} state tensors differ, e.g. {differ[:5]}")
    log(f"{label} {steps} steps captured vs {steps} eager from one initial state, under "
        f"torch.use_deterministic_algorithms and cudnn.deterministic: all {len(captured)} "
        f"state tensors bit-equal (weights, Adam moments and counts, learning rates, EMAs, "
        f"device step{', D statistics, D Adam, gate EMA and counters' if cfg.gan else ''})")


def train_modes(cfg, kernels, runs, capturing, label):
    """``runs``: {mode: [calls of train()]}, captured (the default) then
    eager (``capture=False``), each step timed and its launches counted:
    exactly ``step_launch_want`` a step, twice that at the ``capturing``
    steps of the captured mode. Returns {mode: dict(secs, launches, totals,
    peak MiB and graph pool MiB of the largest call, capture s, wall s, the
    last call's state)}."""
    want = step_launch_want(cfg)
    out = {}
    for mode, calls in runs.items():
        m = dict(peak=0.0, pool=0.0, capture_s=0.0, recaptures=0, modes=set())
        with timed_train_steps(kernels) as (step_secs, step_launches, trainers):
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            for call in calls:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                m["state"] = call()
                m["peak"] = max(m["peak"], (torch.cuda.max_memory_allocated() - base) / 2**20)
                m["pool"] = max(m["pool"], sum(t.pool_bytes() for t in trainers) / 2**20)
                m["capture_s"] += sum(t.capture_s for t in trainers)
                m["recaptures"] += sum(t.recaptures for t in trainers)
                m["modes"] |= {t.capture for t in trainers}
                del trainers[:]  # its graphs and pools go with it
            m["wall"] = time.perf_counter() - t0
            m["totals"] = {name: k.launches for name, k in kernels.items()}
        m.update(secs=step_secs, launches=step_launches)
        if m["modes"] != {mode == "captured"} or m["recaptures"]:
            raise RuntimeError(f"{label} {mode}: capture {m['modes']}, "
                               f"{m['recaptures']} recaptures")
        check_step_launches(step_launches, capturing if mode == "captured" else (), want,
                            f"{label} {mode}")
        out[mode] = m
    return out


def log_modes(label, cfg, modes, steady, card) -> None:
    """ms/step, frames/s, peak memory, graph pool and capture seconds of
    each mode's train() run."""
    frames = cfg.batch_size * cfg.unroll_frames
    for mode, m in modes.items():
        a, b = steady[mode]
        ms = sum(m["secs"][a:b]) / (b - a) * 1e3
        m["ms"] = ms
        log(f"{label} {mode}: steady {ms:.2f} ms/step over steps {a + 1}-{b}, "
            f"{frames / ms * 1e3:.1f} frames/s; {len(m['secs'])} steps in {m['wall']:.2f} s "
            f"wall; peak {m['peak']:.0f} MiB above the run's start; graph pools "
            f"{m['pool']:.0f} MiB; capture (warm-up + capture) {m['capture_s']:.3f} s; "
            f"launches a step {m['launches'][-1]}; card: {card}")


def run_training(dev, card: str, tmp: str):
    """Phase 8: FRVSR_PRESET through ``train()`` on synthetic scenes under
    ``tmp``, captured: 40 steps and a resume to 45 (checkpoints in
    ``<tmp>/run/checkpoints``); then 15 steps with ``capture=False``; then
    the captured and eager programs stepped 3 times from one state and
    compared, and the profile. Returns the launch counts of the 45 captured
    steps and of one steady step, and a summary for phase 8c (the captured
    ms/step, peak and pool MiB, the profile's)."""
    import io

    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.loop import train

    kernels = {"upsample4": upsample4, "upsample4_bwd": upsample4_bwd,
               "resblock_chain": resblock_chain}
    data, out_dir = os.path.join(tmp, "scenes"), os.path.join(tmp, "run")
    t0 = time.perf_counter()
    write_synthetic_scenes(data, 3, SCENE_FRAMES, SCENE_H, SCENE_W, start_index=2000)
    write_synthetic_scenes(data, 1, SCENE_FRAMES, SCENE_H, SCENE_W,
                           start_index=2251, seed=100)
    log(f"[train] 4 synthetic scenes of {SCENE_FRAMES} {SCENE_H}x{SCENE_W} PNG "
        f"frames written in {time.perf_counter() - t0:.1f} s")
    cfg = FRVSR_PRESET.replace(input_video_dir=data, max_frm=SCENE_FRAMES - 1,
                               save_freq=SAVE_FREQ, summary_freq=10)
    printed = io.StringIO()
    runs = {"captured": [lambda: train(cfg, out_dir, dev, max_steps=TRAIN_STEPS),
                         lambda: train(cfg, out_dir, dev, max_steps=RESUME_STEPS)],
            "eager": [lambda: train(cfg, os.path.join(tmp, "run_eager"), dev,
                                    max_steps=EAGER_STEPS, capture=False)]}
    with contextlib.redirect_stdout(printed):
        modes = train_modes(cfg, kernels, runs, (0, TRAIN_STEPS), "[train]")
    state = modes["captured"]["state"]
    for line in printed.getvalue().splitlines():
        if line.startswith(("step ", "Resumed", "Saved", "Dataset")):
            log(f"[train] | {line}")
    if state.step != RESUME_STEPS or len(modes["captured"]["secs"]) != RESUME_STEPS or \
            modes["eager"]["state"].step != EAGER_STEPS:
        raise RuntimeError(f"[train] steps to {state.step}, "
                           f"{len(modes['captured']['secs'])} step calls; eager "
                           f"{modes['eager']['state'].step}")
    if f"Resumed from step {TRAIN_STEPS}" not in printed.getvalue():
        raise RuntimeError("[train] the second run did not resume")
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "log", "scalars.jsonl"))]
    if not rows or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise RuntimeError(f"[train] scalars.jsonl: {len(rows)} rows, not all finite")
    if not all(math.isfinite(float(v)) for v in state.ema_losses.values()):
        raise RuntimeError(f"[train] loss EMAs {state.ema_losses}")
    fresh = Trainer(cfg, "cpu").init_state(cfg.rand_seed)
    for prefix, a, b in (("generator", fresh.generator, state.generator),
                         ("fnet", fresh.fnet, state.fnet)):
        for (name, p0), p1 in zip(a.named_parameters(), b.parameters()):
            if torch.equal(p0, p1.detach().cpu()):
                raise RuntimeError(f"[train] {prefix}.{name} did not move")
    launches = modes["captured"]["totals"]
    log(f"[train] launches over {RESUME_STEPS} captured steps with validation {launches}; "
        f"every step exactly {step_launch_want(cfg)} (the first of each train() call "
        f"twice that: its warm-up and one replay), eager too")
    log(f"[train] FRVSR_PRESET ({cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, crop {cfg.crop_size}, {cfg.rnn_n} frames, float32, "
        f"cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}): captured "
        f"{TRAIN_STEPS} steps, resumed to {RESUME_STEPS}; eager {EAGER_STEPS} steps; every "
        f"parameter moved; {len(rows)} scalar rows")
    log_modes("[train]", cfg, modes, {"captured": (20, TRAIN_STEPS),
                                      "eager": (EAGER_STEPS - 10, EAGER_STEPS)}, card)
    check_captured_equals_eager(dev, cfg, "[train]")
    prof = profile_step(dev, cfg, state, {m: modes[m]["ms"] for m in modes}, "FRVSR_PRESET")
    summary = dict(ms=modes["captured"]["ms"], peak=modes["captured"]["peak"],
                   pool=modes["captured"]["pool"], profile=prof)
    return launches, modes["captured"]["launches"][-1], summary


# Profile groups: a kernel goes to the first group one of whose needles is
# in its name; the rest is glue.
PROFILE_GROUPS = {
    "chain kernel": ("resblock_kernel",),
    "K2 (flow upsample backward)": ("upsample4_bwd_kernel",),
    "K1 (flow upsample, bicubic skip)": ("upsample4_kernel",),
    "cuDNN/cuBLAS convs and GEMMs": ("conv", "cudnn", "xmma", "gemm", "dgrad",
                                     "wgrad", "cutlass", "sm90"),
    "Adam": ("multi_tensor", "adam")}
GLUE = "glue (elementwise, gathers, copies)"


def device_us(evt, total: bool = False) -> float:
    name = "device_time_total" if total else "self_device_time_total"
    if not hasattr(evt, name):  # older torch
        name = name.replace("device", "cuda")
    return getattr(evt, name)


def busy_us(spans) -> float:
    """The time covered by the union of (start, end) intervals: kernels
    that overlap (a chain block launched while the previous one runs) count
    once."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def device_split(prof):
    """A torch.profiler window's device time by kernel group: the time the
    device was busy, the union of its kernels' intervals, in all and per
    group. An operator's row holds the device time of the kernels it
    launched itself (by_op: where the glue comes from). Returns (total us,
    {group: us}, {group: {kernel: launches}}, by_op)."""
    from torch.autograd import DeviceType

    spans = {g: [] for g in [*PROFILE_GROUPS, GLUE]}
    names = {g: {} for g in spans}
    for evt in prof.events():
        # A user annotation on the device's timeline spans kernels; it is none.
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        key = evt.name.lower()
        group = next((g for g, needles in PROFILE_GROUPS.items()
                      if any(n.lower() in key for n in needles)), GLUE)
        spans[group].append((evt.time_range.start, evt.time_range.end))
        names[group][evt.name] = names[group].get(evt.name, 0) + 1
    by_op = [(device_us(row), row.count, row.key) for row in prof.key_averages()
             if row.device_type != DeviceType.CUDA and device_us(row) > 0]
    total = busy_us([s for group in spans.values() for s in group])
    split = {g: busy_us(s) for g, s in spans.items()}
    return total, split, names, sorted(by_op, reverse=True)


def log_split(total: float, split, by_op) -> None:
    for group, us in split.items():
        log(f"[profile]   {group}: {us / 1e3:.3f} ms ({us / total:.1%})")
    for us, count, key in by_op[:8]:
        log(f"[profile]   by op: {us / 1e3:.3f} ms in {count} calls of {key[:80]}")


def _annotated(cls, label: str):
    """``cls.forward`` inside a ``record_function(label)`` range."""
    from torch.profiler import record_function

    forward = cls.forward

    def wrapped(self, *args, **kwargs):
        with record_function(label):
            return forward(self, *args, **kwargs)
    return wrapped


def module_kernel_us(prof, labels):
    """{label: (conv us, other us)}: the device time of the kernels launched
    inside each ``record_function(label)`` range (a module's forward) and
    inside the autograd engine's functions of the nodes those forwards made
    (matched by sequence number): the module's forward and backward. Sums
    of kernel durations, from each CPU op's own kernels."""
    import bisect

    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = {label: {} for label in labels}

    def add(label, e):
        spans[label].setdefault(e.thread, []).append((e.time_range.start, e.time_range.end))

    def inside(label, e):
        ranges = spans[label].get(e.thread, [])
        i = bisect.bisect_right(ranges, (e.time_range.start, math.inf)) - 1
        return i >= 0 and e.time_range.end <= ranges[i][1]

    for e in cpu:
        if e.name in labels:
            add(e.name, e)
    for label in labels:
        for ranges in spans[label].values():
            ranges.sort()
    seqs = {label: {e.sequence_nr for e in cpu if e.sequence_nr >= 0 and inside(label, e)}
            for label in labels}
    for e in cpu:
        if e.name.startswith("autograd::engine::evaluate_function:"):
            for label in labels:
                if e.sequence_nr in seqs[label]:
                    add(label, e)
    for label in labels:
        for ranges in spans[label].values():
            ranges.sort()
    conv_needles = PROFILE_GROUPS["cuDNN/cuBLAS convs and GEMMs"]
    out = {}
    for label in labels:
        conv = other = 0.0
        for e in cpu:
            if e.kernels and inside(label, e):
                for k in e.kernels:
                    if any(n in k.name.lower() for n in conv_needles):
                        conv += k.duration
                    else:
                        other += k.duration
        out[label] = (conv, other)
    return out


def profile_step(dev, cfg, state, steady: dict, name: str, vgg=None,
                 modes=("captured", "eager")) -> dict:
    """Both modes (or those in ``modes``) on one batch, with no loader
    running: ms/step in turns (captured, eager, eager, captured), then one
    step of each under torch.profiler, split by kernel group: device time
    (the union of kernel intervals) and the idle share against each mode's
    ms/step in train() (``steady``, where it has the mode) and alone. A
    profile must show the chain (as the kernel of the step's dtype: the
    float32 cluster kernel or the bfloat16 tensor-core one), K1 and K2 as
    often as the counters say. In TecoGAN mode VGG19's and the
    discriminator's kernels are split out of the eager step's profile
    (``record_function`` ranges are not replayed; :func:`module_kernel_us`).
    Returns {mode: dict(device_ms, alone=(min, max) ms/step, split={group:
    ms})}, and under "chain_bwd_ms" the eager step's chain backward."""
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.models import Discriminator, VGG19Features
    from tecogan_tpu_torch.train import Trainer

    trainers = {mode: Trainer(cfg, dev, vgg=vgg, capture=None if mode == "captured" else False)
                for mode in modes}
    batch = frvsr_batch(cfg, cfg.batch_size, 21)
    for trainer in trainers.values():
        for _ in range(2):
            trainer.train_step(state, batch)
    alone = {mode: [] for mode in trainers}
    for mode in [m for m in ("captured", "eager", "eager", "captured") if m in trainers]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            trainers[mode].train_step(state, batch)
        torch.cuda.synchronize()
        alone[mode].append((time.perf_counter() - t0) / PROFILE_STEPS * 1e3)
    log(f"[profile] {name} on one batch, no loader running, {PROFILE_STEPS} steps a window "
        f"in turns: " + "; ".join(f"{mode} {', '.join(f'{ms:.2f}' for ms in v)} ms/step"
                                 for mode, v in alone.items()))
    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    want = step_launch_want(cfg)
    chain_name = ("resblock_kernel_mma" if cfg.compute_dtype == "bfloat16"
                  else "resblock_kernel_tf32x3")
    summary = {}
    for mode, trainer in trainers.items():
        # The counters must count a step's launches every time. The
        # profile must show them too; a profile that misses one (CUPTI
        # has been seen to drop a kernel record of a replay: 10 of 11 K1
        # in phase 8's float32 replay on an H100) is taken again, at most
        # PROFILE_ATTEMPTS times.
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            forwards = {cls: cls.forward for cls in (VGG19Features, Discriminator)}
            before = {k: w.launches for k, w in kernels.items()}
            try:
                if mode == "eager":
                    VGG19Features.forward = _annotated(VGG19Features, "vgg19")
                    Discriminator.forward = _annotated(Discriminator, "discriminator")
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    trainer.train_step(state, batch)
                    torch.cuda.synchronize()
            finally:
                for cls, forward in forwards.items():
                    cls.forward = forward
            counted = {k: w.launches - before[k] for k, w in kernels.items()}
            total, split, names, by_op = device_split(prof)
            if total <= 0:
                raise RuntimeError(f"[profile] {name} {mode}: torch.profiler recorded no "
                                   "device time")
            chain = names["chain kernel"]
            shown = {"resblock_chain": sum(n for key, n in chain.items() if chain_name in key),
                     "upsample4": sum(names["K1 (flow upsample, bicubic skip)"].values()),
                     "upsample4_bwd": sum(names["K2 (flow upsample backward)"].values())}
            log(f"[profile] {name} {mode}: the profile shows {shown} launches (the chain as "
                f"{chain_name}); the counters {counted}; want {want}")
            if counted != want:
                raise RuntimeError(f"[profile] {name} {mode}: counters {counted}, want {want}")
            if shown == want and sum(chain.values()) == shown["resblock_chain"]:
                break
            if attempt == PROFILE_ATTEMPTS:
                raise RuntimeError(f"[profile] {name} {mode}: profile {shown} (chain {chain}) "
                                   f"in each of {attempt} profiles, counters {counted}")
            log(f"[profile] {name} {mode}: the profile missed launches the counters "
                f"count; profiling again ({attempt} of {PROFILE_ATTEMPTS})")
        ms = total / 1e3
        in_train = (f"{steady[mode]:.2f} ms/step in train() (device idle share "
                    f"{max(0.0, 1 - ms / steady[mode]):.1%}) and " if mode in steady else "")
        log(f"[profile] one {name} step {mode}: {ms:.2f} ms of device time against "
            f"{in_train}{min(alone[mode]):.2f}-"
            f"{max(alone[mode]):.2f} ms/step on one batch with no loader running (idle "
            f"{max(0.0, 1 - ms / min(alone[mode])):.1%}-{max(0.0, 1 - ms / max(alone[mode])):.1%})")
        log_split(total, split, by_op)
        summary[mode] = dict(device_ms=ms, alone=(min(alone[mode]), max(alone[mode])),
                             split={g: us / 1e3 for g, us in split.items()})
        if mode == "captured":
            continue
        replay = sum(device_us(e, total=True) for e in prof.events() if e.name.startswith(
            "autograd::engine::evaluate_function: _ResblockChain"))
        summary["chain_bwd_ms"] = replay / 1e3
        log(f"[profile]   of which the chain's backward (plain-chain replay + its "
            f"cuDNN backward, all kinds): {replay / 1e3:.3f} ms ({replay / total:.1%})")
        if not cfg.gan:
            continue
        modules = module_kernel_us(prof, ("vgg19", "discriminator"))
        convs = split["cuDNN/cuBLAS convs and GEMMs"]
        for label, (conv, other) in modules.items():
            log(f"[profile]   of which {label} (forward and backward, kernel durations): "
                f"convs {conv / 1e3:.3f} ms ({conv / total:.1%}), other kernels "
                f"{other / 1e3:.3f} ms ({other / total:.1%})")
            convs -= conv
        if not all(conv > 0 for conv, _ in modules.values()):
            log("[profile]   (the module attribution found no kernels: the profiler's CPU "
                "ops carry no kernels here)")
        log(f"[profile]   other cuDNN/cuBLAS (the chain's backward replay, FNet, the "
            f"generator's stem and upsample, the Gaussian): {convs / 1e3:.3f} ms "
            f"({convs / total:.1%})")
    return summary


def profiled_launches(names, chain_want: int, k1_want: int, label: str):
    """The profile's launches of the bfloat16 chain kernel and of K1, which
    must equal the counters' (``want``): the chain only as
    ``resblock_kernel_mma``. Returns (chain, K1)."""
    chain = names["chain kernel"]
    for key, count in chain.items():
        log(f"[profile]   chain kernel: {count} launches of {key[:100]}")
    mma = sum(n for key, n in chain.items() if "resblock_kernel_mma" in key)
    k1 = sum(names["K1 (flow upsample, bicubic skip)"].values())
    log(f"[profile]   {label}: the profile shows {mma} launches of resblock_kernel_mma "
        f"and {k1} of K1; the counters {chain_want} and {k1_want}")
    if (mma, k1) != (chain_want, k1_want) or sum(chain.values()) != mma:
        raise RuntimeError(f"[profile] {label}: the chain ran {chain} and K1 {k1} times, "
                           f"want {chain_want} launches of resblock_kernel_mma and "
                           f"{k1_want} of K1")
    return mma, k1


def profile_streaming(sr, frames, secs: float, launches) -> dict:
    """One StreamingSR.run under torch.profiler, split by kernel group; the
    profile's chain (the bfloat16 tensor-core kernel) and K1 launches must
    equal the counters' ``launches`` of a run. Returns the device time and
    the idle share against ``secs`` of unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    mode = "captured" if sr.capture else "eager (capture=False)"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sr.run(frames, warmup=WARMUP)
        torch.cuda.synchronize()
    total, split, names, by_op = device_split(prof)
    if total <= 0:
        raise RuntimeError(f"[profile] streaming {mode}: torch.profiler recorded no device time")
    idle = max(0.0, 1 - total / 1e3 / (secs * 1e3))
    log(f"[profile] streaming {mode}, one StreamingSR.run of {FRAMES} frames: "
        f"{total / 1e3:.2f} ms of device time, {total / 1e3 / FRAMES:.3f} ms/frame, "
        f"against {secs * 1e3:.2f} ms of wall unprofiled ({FRAMES / secs:.2f} "
        f"frames/s processed; device idle share {idle:.1%})")
    log_split(total, split, by_op)
    profiled_launches(names, launches["resblock_chain"], launches["upsample4"],
                      f"streaming {mode}")
    return {"device_ms": total / 1e3, "idle": idle,
            "chain_ms": split["chain kernel"] / 1e3,
            "k1_ms": split["K1 (flow upsample, bicubic skip)"] / 1e3}


def build_models(seed: int, config):
    from tecogan_tpu_torch.models import FNet, Generator
    from tecogan_tpu_torch.models.layers import glorot_init_

    gen = torch.Generator().manual_seed(seed)
    g = glorot_init_(Generator(config.num_resblock, config.gen_channels), gen)
    f = glorot_init_(FNet(config.fnet_channels, config.fnet_up_channels,
                          config.flow_max_velocity), gen)
    with torch.no_grad():  # non-zero biases, so the kernels' bias paths count
        for m in (g, f):
            for name, p in m.named_parameters():
                if name.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return g, f


def check_path_vs_cpu(dev) -> float:
    """Phase 5: full-width streaming, GPU vs CPU, float32."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="float32", infer_chunk=4)
    rng = np.random.RandomState(4)
    frames = rng.rand(6, 64, 96, 3).astype(np.float32)
    outs = []
    for device in (dev, torch.device("cpu")):
        sr = StreamingSR(cfg, *build_models(5, cfg), output="float32", device=device)
        out, secs = sr.run(frames)
        log(f"[path] {device}: {out.shape} in {secs:.2f} s")
        outs.append(torch.from_numpy(out))
    if outs[0].shape != (6, 256, 384, 3):
        raise RuntimeError(f"unexpected output shape {tuple(outs[0].shape)}")
    err, rel = rel_err(*outs)
    log(f"[path] GPU kernels vs CPU plain, float32: max_abs_err={err:.3e} "
        f"rel={rel:.3e} tol={PATH_TOL:.0e} (output range "
        f"[{outs[1].min().item():.3f}, {outs[1].max().item():.3f}])")
    if not rel <= PATH_TOL:
        raise RuntimeError(f"GPU path disagrees with CPU path: {rel:.3e}")
    return err


def run_main_path(dev, card: str):
    """Phase 6: the streaming path at size, captured (the default on the
    card) and with ``capture=False``, in the same call: the two outputs
    bit-equal under cuDNN's deterministic algorithms; then, with the
    default flags, each mode's frames/s (runs in turns: eager, captured,
    captured, eager), launches, peak memory (and the graph's pool) and a
    profile. Returns the captured run's launch counts."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16",
                     infer_chunk=CHUNK)
    models = build_models(6, cfg)
    rng = np.random.RandomState(7)
    frames = (rng.rand(FRAMES, LR_H, LR_W, 3) * 255).astype(np.uint8)
    want = (FRAMES - WARMUP, 4 * LR_H, 4 * LR_W, 3)
    modes = {"captured": None, "eager": False}

    # (a) Captured against eager, under cuDNN's deterministic algorithms:
    # the same kernels on the same inputs, so bit-equal.
    torch.backends.cudnn.deterministic = True
    try:
        equal = {m: StreamingSR(cfg, *models, output="uint8", device=dev,
                                capture=c).run(frames, warmup=WARMUP)[0]
                 for m, c in modes.items()}
    finally:
        torch.backends.cudnn.deterministic = False
    same = np.array_equal(equal["captured"], equal["eager"])
    log(f"[main] streaming {LR_H}x{LR_W} -> {4 * LR_H}x{4 * LR_W}, bfloat16, cuDNN "
        f"deterministic: captured vs capture=False outputs "
        f"{'bit-equal' if same else 'DIFFER in %d values' % (equal['captured'] != equal['eager']).sum()}")
    if not same or equal["captured"].shape != want:
        raise RuntimeError("[main] the captured streaming run differs from the eager one")

    # (b) Each mode with the default flags: a first run (the capture, for
    # the captured mode), peak memory from there; then timed runs in turns.
    runs = {}
    for mode, capture in modes.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        captures = CapturedProgram.captures
        sr = StreamingSR(cfg, *models, output="uint8", device=dev, capture=capture)
        _, first = sr.run(frames, warmup=WARMUP)
        torch.cuda.synchronize()
        pool = sum(c.run.pool_bytes() for c in sr._chunks.values()) if sr.capture else 0
        runs[mode] = {"sr": sr, "secs": [], "first_s": first, "capture_s": sr.capture_s,
                      "captures": CapturedProgram.captures - captures,
                      "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
                      "reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
                      "pool_mib": pool / 2**20}
    for mode in ("eager", "captured", "captured", "eager"):
        rec = runs[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        upsample4.launches = 0
        resblock_chain.launches = 0
        hr, secs = rec["sr"].run(frames, warmup=WARMUP)
        rec["launches"] = {"upsample4": upsample4.launches,
                           "resblock_chain": resblock_chain.launches}
        rec["steady_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        rec["secs"].append(secs)
        if hr.shape != want or hr.dtype != np.uint8 or hr.min() == hr.max():
            raise RuntimeError(f"[main] {mode}: output {hr.shape} {hr.dtype}, want {want} uint8")
    need = {"upsample4": FRAMES + FRAMES // CHUNK, "resblock_chain": NUM_RESBLOCK * FRAMES}
    for mode, rec in runs.items():
        log(f"[main] {mode}: launches of a run {rec['launches']}, want {need}")
        if rec["launches"] != need:
            raise RuntimeError(f"[main] {mode} launched {rec['launches']}, want {need}")
    if (runs["captured"]["captures"], runs["eager"]["captures"]) != (1, 0):
        raise RuntimeError(f"[main] captures: {runs['captured']['captures']} captured, "
                           f"{runs['eager']['captures']} eager; want 1 and 0")
    for mode, rec in runs.items():
        secs = min(rec["secs"])
        rec["frames_per_s"] = [FRAMES / s for s in rec["secs"]]
        log(f"[main] {mode}: {FRAMES} frames ({FRAMES - WARMUP} delivered) {LR_H}x{LR_W} -> "
            f"{4 * LR_H}x{4 * LR_W}, bfloat16, {NUM_RESBLOCK} resblocks, chunk {CHUNK}: "
            f"runs of {', '.join(f'{s:.4f}' for s in rec['secs'])} s wall, "
            f"{', '.join(f'{f:.2f}' for f in rec['frames_per_s'])} frames/s processed "
            f"({(FRAMES - WARMUP) / secs:.2f} delivered at best); the first run "
            f"{rec['first_s']:.3f} s (of which building the chunk's program "
            f"{rec['capture_s']:.3f} s); peak allocated above the models "
            f"{rec['peak_mib']:.0f} MiB in the first run, {rec['steady_peak_mib']:.0f} MiB in a "
            f"later one; graph pool {rec['pool_mib']:.0f} MiB; card: {card}")
    for mode in ("captured", "eager"):
        rec = runs[mode]
        rec.update(profile_streaming(rec["sr"], frames, float(np.median(rec["secs"])),
                                     rec["launches"]))
    log("[main] streaming records " + json.dumps(
        {m: {k: v for k, v in r.items() if k != "sr"} for m, r in runs.items()}))
    return runs["captured"]["launches"]


def _csv_cells(path: str):
    """metrics.csv as (column, row index, cell) triples, the header rows
    of its blocks included as column names."""
    cells, header = [], []
    for line in Path(path).read_text().splitlines():
        row = line.split(",")
        if row[0] == "":
            header = row
            continue
        cells += [(name, row[0], cell) for name, cell in zip(header[1:], row[1:])]
    return cells


def run_cli(dev, card: str, tmp: str, ckpt_dir: str):
    """Phase 9: the inference CLI and the metrics suite at the main path's
    width, under ``tmp``; ``ckpt_dir`` is phase 8's checkpoint dir. Returns
    the launch counts of the CLI's run."""
    import io
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from tecogan_tpu_torch.cli import main as cli_main
    from tecogan_tpu_torch.cli import metrics as cli_metrics
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.inference import hr_to_lr, load_inference_frames, read_frames
    from tecogan_tpu_torch.data.png import write_png
    from tecogan_tpu_torch.data.synthetic import synthetic_clip
    from tecogan_tpu_torch.eval import LPIPS, evaluate_folders, random_alexnet_params
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.ops import list_png_in_dir
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram
    from tecogan_tpu_torch.weights import (
        from_jax_params, params_to_npz, read_params_npz, to_jax_params)

    # (a) 41 HR PNGs and the phase-6 model (16 blocks) as a params npz.
    hr_dir, npz = os.path.join(tmp, "cli_hr"), os.path.join(tmp, "cli_params.npz")
    os.makedirs(hr_dir)
    t0 = time.perf_counter()
    hr = (synthetic_clip(CLI_FRAMES, 4 * LR_H, 4 * LR_W, seed=31, content="natural")
          * 255).astype(np.uint8)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: write_png(os.path.join(hr_dir, f"im{i + 1}.png"), hr[i]),
                      range(CLI_FRAMES)))
    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16", infer_chunk=CHUNK)
    gen_tree, fnet_tree = to_jax_params(*build_models(6, cfg))
    params_to_npz(npz, generator=gen_tree, fnet=fnet_tree)
    log(f"[cli] {CLI_FRAMES} synthetic HR PNGs of {4 * LR_H}x{4 * LR_W} and a "
        f"{NUM_RESBLOCK}-block params npz written in {time.perf_counter() - t0:.1f} s")

    # (b) The CLI, in-process, as a user calls it; counted. Run 1 and the
    # direct StreamingSR.run it is compared with use cuDNN's deterministic
    # algorithms: a transposed conv may otherwise sum with atomics, and one
    # float ulp can flip a uint8 level. Run 2, into another directory, keeps
    # PyTorch's default flags, as a user's run does, and shows the spread of
    # the wall time.
    def cli(out_dir, *extra, codec="native"):
        """One CLI run with the native or the python PNG codec; ``stats``
        gains the frames the native library decoded and encoded in it."""
        printed = io.StringIO()
        counts = codec_counts()
        with contextlib.redirect_stdout(printed), (
                python_codec() if codec == "python" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            stats = cli_main.main(["--mode", "inference", "--input_dir_HR", hr_dir,
                                   "--output_dir", out_dir, "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
        stats.update(codec=codec, native=tuple(n - c for n, c in zip(codec_counts(), counts)))
        return stats, wall, printed.getvalue()

    out_dir = os.path.join(tmp, "cli_out")
    argv = ["--params_npz", npz, "--compute_dtype", "bfloat16", "--infer_chunk", str(CHUNK)]
    torch.backends.cudnn.deterministic = True
    try:
        upsample4.launches = 0
        resblock_chain.launches = 0
        captures = CapturedProgram.captures
        runs = [cli(out_dir, *argv)]
        launches = {"upsample4": upsample4.launches,
                    "resblock_chain": resblock_chain.launches}
        captures = CapturedProgram.captures - captures
        data = load_inference_frames(input_dir_hr=hr_dir, device=dev)
        trees = read_params_npz(npz)
        sr = StreamingSR(cfg, *from_jax_params(trees["generator"], trees["fnet"]),
                         output="uint8", device=dev)
        direct, _ = sr.run(data.inputs, warmup=WARMUP)
    finally:
        torch.backends.cudnn.deterministic = False
    # Runs 2-5 keep the default flags, the PNG codecs in turns (phase 9b
    # holds the two codecs' pixels equal).
    for codec in ("native", "python", "python", "native"):
        runs.append(cli(os.path.join(tmp, f"cli_out{len(runs) + 1}"), *argv, codec=codec))
    for i, (stats, _, _) in enumerate(runs, 1):
        want = (CLI_FRAMES, CLI_FRAMES) if stats["codec"] == "native" else (0, 0)
        if stats["native"] != want:
            raise RuntimeError(f"[cli] run {i} ({stats['codec']} codec): the native library "
                               f"decoded and encoded {stats['native']} frames, want {want}")

    # (c) 41 PNGs of 576x720x3, byte-equal to StreamingSR.run on the card.
    names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if names != [f"output_{i:04d}.png" for i in range(CLI_FRAMES)]:
        raise RuntimeError(f"[cli] wrote {names}")
    got = read_frames([os.path.join(out_dir, n) for n in names])
    if got.shape != (CLI_FRAMES, 4 * LR_H, 4 * LR_W, 3):
        raise RuntimeError(f"[cli] frames of {got.shape}")
    if direct.shape != got.shape or not np.array_equal(direct, got):
        raise RuntimeError(f"[cli] PNGs differ from StreamingSR.run in "
                           f"{int((direct != got).sum())} values")
    if got.min() == got.max():
        raise RuntimeError("[cli] output is constant")
    blur_err = float(np.abs(hr_to_lr(hr[:3], dev) - hr_to_lr(hr[:3], "cpu")).max())
    log(f"[cli] {len(names)} PNGs of {got.shape[1:]} byte-equal to StreamingSR.run on "
        f"the card; HR->LR blur card vs CPU max_abs_err={blur_err:.3e} tol={BLUR_TOL:.0e}")
    if not blur_err <= BLUR_TOL:
        raise RuntimeError(f"[cli] blur card vs CPU {blur_err:.3e}")
    # The CLI's StreamingSR captures its chunk on the first chunk: the
    # capture's eager warm-up runs one chunk more than the 2 chunks of the run.
    ran = FRAMES + CHUNK
    need = {"upsample4": ran + ran // CHUNK, "resblock_chain": NUM_RESBLOCK * ran}
    log(f"[cli] launches {launches} and {captures} capture(s), want {need} (the run's "
        f"{FRAMES} frames and the capture's warm-up chunk of {CHUNK}) and 1")
    if launches != need or captures != 1:
        raise RuntimeError(f"[cli] launched {launches} with {captures} captures, want "
                           f"{need} and 1")
    for i, (stats, wall, printed) in enumerate(runs, 1):
        flags = "cuDNN deterministic" if i == 1 else "default flags"
        log(f"[cli] run {i} ({flags}, {stats['codec']} PNG codec: the native library decoded "
            f"and encoded {stats['native']} frames): {CLI_FRAMES} HR PNGs {4 * LR_H}x{4 * LR_W} "
            f"-> LR {LR_H}x{LR_W} "
            f"(+{WARMUP} warm-up) -> {stats['written']} HR PNGs, bfloat16, "
            f"{NUM_RESBLOCK} resblocks, chunk {CHUNK}: decode + blur "
            f"{stats['decode_s']:.3f} s, stream {stats['stream_s']:.3f} s "
            f"({stats['frames'] / stats['stream_s']:.2f} frames/s processed; of it the "
            f"capture {stats['capture_s']:.3f} s), encode {stats['encode_s']:.3f} s on the "
            f"writer thread, writer flush {stats['flush_s']:.3f} s, {stats['threads']} encode "
            f"threads; end to end {wall:.3f} s wall, {stats['written'] / wall:.2f} frames/s "
            f"PNG dir to PNG dir; card: {card}")
    for line in runs[0][2].splitlines():
        if line.startswith(("total time", "Wrote", "io:")):
            log(f"[cli] | {line}")

    # (d) The checkpoint route: phase 8's 10-block checkpoint, float32.
    stats, wall, printed = cli(os.path.join(tmp, "cli_ckpt"), "--checkpoint", ckpt_dir,
                               "--max_frames", "10")
    note = [ln for ln in printed.splitlines() if ln.startswith(("Loaded checkpoint", "NOTE:"))]
    if stats["written"] != 10 or not any(
            "NOTE: checkpoint has 10 resblocks; overriding --num_resblock 16" in ln
            for ln in note):
        raise RuntimeError(f"[cli] --checkpoint run: {stats}, {note}")
    for line in note:
        log(f"[cli] --checkpoint | {line}")
    log(f"[cli] --checkpoint: {stats['written']} frames, float32, in {wall:.3f} s")

    # (e) The metrics CLI on the 41 outputs against their HR frames.
    metrics_dir = os.path.join(tmp, "cli_metrics")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        avg = cli_metrics.main(["--output", metrics_dir, "--results", out_dir,
                                "--targets", hr_dir, "--device", "cuda"])
        wall = time.perf_counter() - t0
    header = Path(metrics_dir, "metrics.csv").read_text().splitlines()[0]
    scored = CLI_FRAMES - 4
    if "tOF_00" not in header or sorted(avg) != [
            "FrameAvg_PSNR", "FrameAvg_SSIM", "FrameAvg_tOF"] or not all(
            math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[eval] metrics CLI: header {header}, {avg}")
    log(f"[eval] cli.metrics --device cuda, {scored} frames scored (PSNR, SSIM, tOF; "
        f"no LPIPS weights): {wall:.3f} s, {wall / scored:.4f} s/frame; "
        + ", ".join(f"{k} {v:.6f}" for k, v in avg.items()) + f"; card: {card}")

    # (f) evaluate_folders with a seeded random LPIPS, card against CPU.
    res8, tar8 = os.path.join(tmp, "eval_res"), os.path.join(tmp, "eval_tar")
    for src, dst in ((out_dir, res8), (hr_dir, tar8)):
        os.makedirs(dst)
        for path in list_png_in_dir(src, prefix_skip="\x00")[:CLI_EVAL_FRAMES]:
            shutil.copy(path, dst)
    alex = random_alexnet_params(5)
    rng = np.random.RandomState(6)
    lin = [np.abs(rng.randn(c)).astype(np.float32) for c in (64, 192, 384, 256, 256)]
    evals = []
    for device in (dev, torch.device("cpu")):
        timings = {}
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            avg = evaluate_folders([res8], [tar8], os.path.join(tmp, f"eval_{len(evals)}"),
                                   lpips_model=LPIPS(alex, lin, device), device=device,
                                   timings=timings)
            wall = time.perf_counter() - t0
        evals.append((avg, timings, wall, _csv_cells(
            os.path.join(tmp, f"eval_{len(evals)}", "metrics.csv"))))
    (avg_d, t_d, wall_d, cells_d), (avg_c, t_c, wall_c, cells_c) = evals
    if [(n, i) for n, i, _ in cells_d] != [(n, i) for n, i, _ in cells_c]:
        raise RuntimeError("[eval] card and CPU metrics.csv differ in layout")
    scored = sum(name == "PSNR_00" for name, _, _ in cells_d)
    if scored != CLI_EVAL_FRAMES - 4:
        raise RuntimeError(f"[eval] {scored} frames scored, want {CLI_EVAL_FRAMES - 4}")
    worst = {}
    for (name, _, a), (_, _, b) in zip(cells_d, cells_c):
        key = next(p for p in name.split("_") if p in ("PSNR", "SSIM", "LPIPS", "tOF", "tLP100"))
        if key in ("PSNR", "SSIM") or "" in (a, b):
            if a != b:
                raise RuntimeError(f"[eval] {name}: card {a} vs CPU {b}, want byte-equal")
            continue
        rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        worst[key] = max(worst.get(key, 0.0), rel)
    log(f"[eval] evaluate_folders, {CLI_EVAL_FRAMES} frames ({CLI_EVAL_FRAMES - 4} scored), "
        f"random-weight LPIPS: card vs CPU PSNR/SSIM cells byte-equal; worst relative "
        f"difference {', '.join(f'{k} {v:.3e}' for k, v in sorted(worst.items()))} "
        f"tol {EVAL_TOL:.0e}")
    if sorted(worst) != ["LPIPS", "tLP100", "tOF"] or max(worst.values()) > EVAL_TOL:
        raise RuntimeError(f"[eval] card vs CPU: {worst}")
    n = CLI_EVAL_FRAMES - 4
    for name, t, wall in (("card", t_d, wall_d), ("CPU", t_c, wall_c)):
        log(f"[eval] {name}: {wall / n:.4f} s/frame in all: PNG read {t['read'] / n:.4f}, "
            f"PSNR+SSIM {t['psnr_ssim'] / n:.4f}, Farneback {t['farneback'] / n:.4f}, "
            f"LPIPS {t['lpips'] / n:.4f} s/frame; card: {card}")
    log("[eval] FrameAvg card: " + ", ".join(f"{k} {v:.6f}" for k, v in avg_d.items()))
    log("[eval] FrameAvg CPU:  " + ", ".join(f"{k} {v:.6f}" for k, v in avg_c.items()))
    return launches


def check_gan_step_vs_cpu(dev) -> dict:
    """Phase 10: one TecoGAN step at TECOGAN_PRESET's widths, GPU against
    CPU, float32 with TF32 off, the gate forced open and closed. Returns
    the CPU's losses and gradients with the gate open (phase 10b's float32
    yardstick)."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.train import Trainer

    cfg = TECOGAN_PRESET.replace(batch_size=1, rnn_n=3)
    batch = frvsr_batch(cfg, cfg.batch_size, 13)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for gate, ema in (("open", -100.0), ("closed", 100.0)):
            runs = []
            for device in (dev, torch.device("cpu")):
                trainer = Trainer(cfg, device, vgg=random_vgg19(7))
                state = trainer.init_state(12)
                fix_flows_mid_cell(state)
                state.ema_tbalance = torch.tensor(ema, device=device)
                disc = state.discriminator
                d_before = {n: p.detach().cpu().clone() for n, p in disc.named_parameters()}
                stats_before = {n: b.detach().cpu().clone() for n, b in disc.named_buffers()}
                t0 = time.perf_counter()
                _, metrics = trainer.train_step(state, batch)
                secs = time.perf_counter() - t0
                grads = {}
                for prefix, module in (("generator", state.generator), ("fnet", state.fnet),
                                       ("discriminator", disc)):
                    for name, p in module.named_parameters():
                        if p.grad is None:
                            raise RuntimeError(f"[gan step] {device}: {prefix}.{name} got no "
                                               "gradient")
                        grads[f"{prefix}.{name}"] = p.grad.detach().cpu()
                runs.append(dict(
                    losses={k: float(v) for k, v in metrics.items()}, grads=grads,
                    stats={n: b.detach().cpu() for n, b in disc.named_buffers()},
                    stats_before=stats_before, before=d_before,
                    after={n: p.detach().cpu() for n, p in disc.named_parameters()},
                    counters=(int(state.counter_with_d), int(state.counter_wo_d),
                              int(state.d_opt.count))))
                log(f"[gan step] {device} ({'captured' if trainer.capture else 'eager'}), "
                    f"gate {gate}: one step in {secs:.2f} s, "
                    + ", ".join(f"{k} {v:.6f}" for k, v in sorted(runs[-1]["losses"].items())))
            gpu, cpu = runs
            if gate == "open":
                cpu_open = cpu
            for k, want in cpu["losses"].items():
                # t_balance = mean(log D(real)) + adv: a difference of two
                # ~0.6 terms, held to the tolerance of adv.
                scale = abs(cpu["losses"]["t_adversarial_loss"]) if k == "t_balance" else abs(want)
                got = gpu["losses"][k]
                if not (math.isfinite(got) and abs(got - want) <= STEP_LOSS_TOL * scale):
                    raise RuntimeError(f"[gan step] {gate} {k}: GPU {got} vs CPU {want}")
            worst, worst_name = 0.0, ""
            for name, want in cpu["grads"].items():
                scale = want.abs().max().item()
                if scale == 0.0 or gpu["grads"][name].abs().max().item() == 0.0:
                    raise RuntimeError(f"[gan step] {name}: zero gradient")
                rel = (gpu["grads"][name] - want).abs().max().item() / scale
                if rel > worst:
                    worst, worst_name = rel, name
                if not rel <= STEP_GRAD_TOL:
                    raise RuntimeError(f"[gan step] {gate} {name}: gradient rel error {rel:.3e}")
            stats_err = max((gpu["stats"][n] - b).abs().max().item() / max(1.0, b.abs().max().item())
                            for n, b in cpu["stats"].items())
            if not stats_err <= STEP_LOSS_TOL or any(
                    torch.equal(run["stats"][n], b) for run in runs
                    for n, b in run["stats_before"].items()):
                raise RuntimeError(f"[gan step] {gate}: running statistics {stats_err:.3e} "
                                   "GPU vs CPU, or unmoved")
            param_err = 0.0
            for run in runs:
                moved = [n for n, p in run["after"].items() if not torch.equal(p, run["before"][n])]
                if gate == "open" and len(moved) != len(run["after"]):
                    raise RuntimeError(f"[gan step] gate open: only {moved} moved")
                if gate == "closed" and moved:
                    raise RuntimeError(f"[gan step] gate closed: {moved} moved")
                want_counters = (1, 0, 1) if gate == "open" else (0, 1, 0)
                if run["counters"] != want_counters:
                    raise RuntimeError(f"[gan step] gate {gate}: counters (with D, without D, "
                                       f"Adam count) {run['counters']}, want {want_counters}")
            for n, want in cpu["after"].items():
                g = cpu["grads"][f"discriminator.{n}"].abs()
                mask = g > max(STEP_PARAM_MASK * g.max().item(), 1e3 * cfg.adam_eps)
                if mask.any():
                    param_err = max(param_err, (gpu["after"][n] - want)[mask].abs().max().item())
            if not param_err <= STEP_PARAM_ATOL:
                raise RuntimeError(f"[gan step] {gate}: D parameters after the step differ by "
                                   f"{param_err:.3e}")
            log(f"[gan step] GPU vs CPU, float32 (TF32 off), gate {gate}, TECOGAN_PRESET "
                f"widths ({cfg.num_resblock} resblocks, merged Dst, VGG19 random weights), "
                f"batch {cfg.batch_size}, {cfg.unroll_frames} frames, crop {cfg.crop_size}: "
                f"{len(cpu['losses'])} losses within {STEP_LOSS_TOL:.0e}; {len(cpu['grads'])} "
                f"parameters, every gradient non-zero, worst rel {worst:.3e} ({worst_name}) tol "
                f"{STEP_GRAD_TOL:.0e}; D running stats {stats_err:.3e}; D parameters "
                f"{'moved on both, within ' + f'{param_err:.1e}' if gate == 'open' else 'bit-unchanged on both'}; "
                f"counters {gpu['counters']}")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return cpu_open


def run_tecogan_training(dev, card: str, tmp: str):
    """Phase 11: TECOGAN_PRESET through ``train()`` with random VGG19
    weights on phase 8's scenes under ``tmp``, warm-started from phase 8's
    FRVSR checkpoint, captured: 20 steps and a resume to 25; then 10 steps
    with ``capture=False`` from the same warm start; then the captured and
    eager programs stepped 3 times from one state and compared, and the
    profile. Returns the launches of one steady ``train_step`` and a
    summary for phase 11b (as phase 8's)."""
    import io

    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.train.loop import train

    kernels = {"upsample4": upsample4, "upsample4_bwd": upsample4_bwd,
               "resblock_chain": resblock_chain}
    frvsr_ckpt = os.path.join(tmp, "run", "checkpoints")
    out_dir = os.path.join(tmp, "tecogan")
    cfg = TECOGAN_PRESET.replace(input_video_dir=os.path.join(tmp, "scenes"),
                                 max_frm=SCENE_FRAMES - 1, save_freq=GAN_STEPS, summary_freq=10)

    def vgg():
        return random_vgg19(cfg.rand_seed)

    runs = {"captured": [
        lambda: train(cfg, out_dir, dev, vgg=vgg(), pre_trained_dir=frvsr_ckpt,
                      max_steps=GAN_STEPS),
        lambda: train(cfg, out_dir, dev, vgg=vgg(), max_steps=GAN_RESUME_STEPS)],
        "eager": [lambda: train(cfg, os.path.join(tmp, "tecogan_eager"), dev, vgg=vgg(),
                                pre_trained_dir=frvsr_ckpt, max_steps=GAN_EAGER_STEPS,
                                capture=False)]}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        modes = train_modes(cfg, kernels, runs, (0, GAN_STEPS), "[gan train]")
    state = modes["captured"]["state"]
    text = printed.getvalue()
    for line in text.splitlines():
        if line.startswith(("step ", "Resumed", "Saved", "Dataset", "Warm-started",
                            "warm_start", "WARNING")):
            log(f"[gan train] | {line}")
    if state.step != GAN_RESUME_STEPS or len(modes["captured"]["secs"]) != GAN_RESUME_STEPS \
            or modes["eager"]["state"].step != GAN_EAGER_STEPS:
        raise RuntimeError(f"[gan train] steps to {state.step}, "
                           f"{len(modes['captured']['secs'])} step calls; eager "
                           f"{modes['eager']['state'].step}")
    for want in (f"Warm-started weights from {frvsr_ckpt}",
                 "warm_start: partial generator restore", f"Resumed from step {GAN_STEPS}"):
        if want not in text:
            raise RuntimeError(f"[gan train] no {want!r} in train()'s output")
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "log", "scalars.jsonl"))]
    if not rows or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise RuntimeError(f"[gan train] scalars.jsonl: {len(rows)} rows, not all finite")
    gate_rows = [r for r in rows if "t_balance_EMA" in r]
    if [r["step"] for r in gate_rows] != [10, 20]:
        raise RuntimeError(f"[gan train] gate scalars at {[r['step'] for r in gate_rows]}")
    counters = (int(state.counter_with_d), int(state.counter_wo_d))
    if sum(counters) != GAN_RESUME_STEPS or int(state.d_opt.count) != counters[0]:
        raise RuntimeError(f"[gan train] gate counters {counters}, Adam count "
                           f"{int(state.d_opt.count)}")
    if not all(math.isfinite(float(v)) for v in [*state.ema_losses.values(), state.ema_tbalance]):
        raise RuntimeError(f"[gan train] loss EMAs {state.ema_losses}")
    # One train_step's launches (validation and the profile are outside):
    # the chain 16 blocks x 19 frames, K1 the flow upsample, 19 skips and
    # the Dst's LR triplets, K2 the flow upsample's backward.
    step = modes["captured"]["launches"][-1]
    log(f"[gan train] launches per train_step {step} (every step of both modes; the "
        f"first of each captured train() call twice that), over the {GAN_RESUME_STEPS} "
        f"captured steps with validation {modes['captured']['totals']}")
    log(f"[gan train] TECOGAN_PRESET ({cfg.num_resblock} resblocks, batch {cfg.batch_size}, "
        f"crop {cfg.crop_size}, {cfg.rnn_n} frames ping-pong = {cfg.unroll_frames}, float32, "
        f"cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}, VGG19 random "
        f"weights), warm-started from phase 8's 10-block FRVSR checkpoint: captured "
        f"{GAN_STEPS} steps, resumed to {GAN_RESUME_STEPS}; eager {GAN_EAGER_STEPS}; gate: "
        f"{counters[0]} steps with D, {counters[1]} without, t_balance EMA "
        f"{float(state.ema_tbalance):.4f}; {len(rows)} scalar rows")
    log_modes("[gan train]", cfg, modes, {"captured": (10, GAN_STEPS),
                                          "eager": (GAN_EAGER_STEPS - 5, GAN_EAGER_STEPS)}, card)
    check_captured_equals_eager(dev, cfg, "[gan train]", vgg=vgg)
    prof = profile_step(dev, cfg, state, {m: modes[m]["ms"] for m in modes}, "TECOGAN_PRESET",
                        vgg=vgg())
    return step, dict(ms=modes["captured"]["ms"], peak=modes["captured"]["peak"],
                      pool=modes["captured"]["pool"], profile=prof)


# ---------------------------------------------------------------- bfloat16 training
# bfloat16 steps on the card against the CPU (phases 7b, 10b). The two round
# at other points (the chain kernel once per conv, as the Pallas kernel; the
# CPU's plain chain after every op, as flax; cuDNN and the CPU's
# convolutions sum in other orders), so, as tests/test_torch_train_bf16.py
# holds the port against the JAX package, each is held against the CPU's
# own bfloat16 error, its bfloat16 step against its float32 step (phases 7
# and 10) on the same init and batch: a loss within max(1e-3 of its scale,
# twice the CPU's own gap); a gradient, ||card - CPU|| / ||CPU|| per
# parameter, within twice the CPU's own error on it plus 0.02, and the
# median over the parameters within 0.08. The losses read from the
# discriminator (its outputs, their logs and its layers' features) get
# 2^-6 of their scale instead of 1e-3: its outputs are bfloat16 values
# (2^-8 apart near 0.6) behind batch norms over one triplet, which amplify
# the bfloat16 rounding upstream, so the card and the CPU each land a few
# ulps from float32, independently (on an H100 with phase 10's batch: the
# adversarial loss 5.1e-3 apart, the CPU 4.1e-4 from float32 by chance,
# the card 5.5e-3).
BF16_LOSS_RTOL, BF16_D_LOSS_RTOL = 1e-3, 2.0 ** -6
BF16_GRAD_OWN, BF16_GRAD_FLOOR, BF16_GRAD_MEDIAN = 2.0, 0.02, 0.08
# Phase 8c: FRVSR_PRESET in bfloat16 through train(), captured, paced over
# steps 11-25 (0-based starts 10 and 24); phase 11b: TECOGAN_PRESET, steps
# 4-10.
BF16_TRAIN_STEPS, BF16_STEADY = 25, (10, 24)
BF16_GAN_STEPS, BF16_GAN_STEADY = 10, (3, 9)
# The library entries a bfloat16 training step calls, and no other.
BF16_ENTRIES = {"tt_resblock_chain_bf16", "tt_upsample4_bf16", "tt_upsample4_bwd_bf16"}


@contextlib.contextmanager
def entries_called():
    """Counts, by name, the kernel library's entry points (``tt_...``) that
    the wrappers call while open: which dtype's kernel each launched. A
    replay runs no Python; a program's warm-up and its capture do."""
    from tecogan_tpu_torch.kernels import _build

    library, seen = _build.library, {}

    class Counting:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            if name.startswith("tt_"):
                seen[name] = seen.get(name, 0) + 1
            return getattr(self.lib, name)

    _build.library = lambda: Counting(library())
    try:
        yield seen
    finally:
        _build.library = library


def loss_scale(k: str, losses: dict) -> float:
    """A loss's scale for its tolerance: t_balance, a difference of two
    ~0.6 terms, that of the adversarial loss; a VGG loss (1 - a mean
    cosine) 1."""
    if k == "t_balance":
        return abs(losses["t_adversarial_loss"])
    return 1.0 if k.startswith("vgg_") else abs(losses[k])


def bf16_step_vs_cpu(dev, label: str, cfg, batch, cpu_f32: dict, vgg_seed=None) -> None:
    """One bfloat16 step of ``cfg`` on the card (captured, the default) and
    on the CPU from one seeded init (flows mid-cell) and batch, the gate
    open in TecoGAN mode: on the card only the bfloat16 kernel entries and
    exactly twice a step's launches (the capturing call's warm-up and one
    replay), on the CPU none; every parameter and gradient float32; losses
    and gradients against the CPU's, ``cpu_f32`` (the CPU's float32 step)
    the yardstick."""
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.train import Trainer

    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    runs = []
    for device in (dev, torch.device("cpu")):
        trainer = Trainer(cfg, device, vgg=None if vgg_seed is None else random_vgg19(vgg_seed))
        state = trainer.init_state(12)
        fix_flows_mid_cell(state)
        if cfg.gan:
            state.ema_tbalance = torch.tensor(-100.0, device=device)
        before = {k: w.launches for k, w in kernels.items()}
        t0 = time.perf_counter()
        with entries_called() as entries:
            _, metrics = trainer.train_step(state, batch)
        secs = time.perf_counter() - t0
        grads = {}
        for prefix, module in (("generator", state.generator), ("fnet", state.fnet),
                               ("discriminator", state.discriminator)):
            for name, p in ([] if module is None else module.named_parameters()):
                if p.grad is None or not p.dtype == p.grad.dtype == torch.float32:
                    raise RuntimeError(f"{label} {device}: {prefix}.{name} is {p.dtype}, "
                                       f"its gradient {None if p.grad is None else p.grad.dtype}")
                grads[f"{prefix}.{name}"] = p.grad.detach().cpu()
        runs.append(dict(losses={k: float(v) for k, v in metrics.items() if k != "learning_rate"},
                         grads=grads, entries=entries,
                         launches={k: w.launches - before[k] for k, w in kernels.items()}))
        log(f"{label} {device} ({'captured' if trainer.capture else 'eager'}): one bfloat16 "
            f"step in {secs:.2f} s, library entries {entries}, launches {runs[-1]['launches']}, "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(runs[-1]["losses"].items())))
    gpu, cpu = runs
    want = {k: 2 * n for k, n in step_launch_want(cfg).items()}
    if gpu["launches"] != want or set(gpu["entries"]) != BF16_ENTRIES:
        raise RuntimeError(f"{label} card: launches {gpu['launches']} (want {want}), entries "
                           f"{gpu['entries']} (want only {sorted(BF16_ENTRIES)})")
    if cpu["entries"] or any(cpu["launches"].values()):
        raise RuntimeError(f"{label} CPU launched {cpu['launches']}, {cpu['entries']}")
    worst_loss = (0.0, "")
    for k, want_k in cpu["losses"].items():
        got, own = gpu["losses"][k], abs(want_k - cpu_f32["losses"][k])
        rtol = BF16_D_LOSS_RTOL if k.startswith(("t_", "D_layer")) else BF16_LOSS_RTOL
        tol = max(rtol * loss_scale(k, cpu["losses"]), 2 * own)
        if not (math.isfinite(got) and abs(got - want_k) <= tol):
            raise RuntimeError(f"{label} {k}: card {got} vs CPU {want_k}, tol {tol:.3e} (the "
                               f"CPU's own bfloat16 gap {own:.3e})")
        worst_loss = max(worst_loss, (abs(got - want_k) / tol, k))
    rels = []
    for name, want_g in cpu["grads"].items():
        norm = want_g.norm().item()
        got = gpu["grads"][name]
        if norm == 0.0 or got.abs().max().item() == 0.0:
            raise RuntimeError(f"{label} {name}: zero gradient")
        rel = (got - want_g).norm().item() / norm
        own = (cpu_f32["grads"][name] - want_g).norm().item() / norm
        if not rel <= BF16_GRAD_OWN * own + BF16_GRAD_FLOOR:
            raise RuntimeError(f"{label} {name}: gradient rel {rel:.3e} > {BF16_GRAD_OWN} x "
                               f"the CPU's own {own:.3e} + {BF16_GRAD_FLOOR}")
        rels.append((rel, name, own))
    median = float(np.median([r for r, _, _ in rels]))
    if not median <= BF16_GRAD_MEDIAN:
        raise RuntimeError(f"{label}: median gradient rel {median:.3e} > {BF16_GRAD_MEDIAN}")
    rel, name, own = max(rels)
    log(f"{label} card (captured) vs CPU, bfloat16, {cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, {cfg.unroll_frames} frames, crop {cfg.crop_size}"
        f"{', gate open' if cfg.gan else ''}: {len(cpu['losses'])} losses within max(1e-3 of "
        f"scale (the discriminator's 2^-6), 2x the CPU's own bfloat16 gap) (worst "
        f"{worst_loss[0]:.2f} of its tolerance, "
        f"{worst_loss[1]}); {len(rels)} parameters, every gradient non-zero and float32, "
        f"median rel {median:.3e} (tol {BF16_GRAD_MEDIAN}), worst {rel:.3e} ({name}; the CPU's "
        f"own bfloat16 error there {own:.3e}); library entries {sorted(gpu['entries'])} only; "
        f"launches {gpu['launches']} (warm-up + one replay)")


def check_bf16_step_vs_cpu(dev, cpu_f32: dict) -> None:
    """Phase 7b: phase 7's FRVSR step (10 blocks, the real FNet, batch 2,
    4 frames, crop 32) in bfloat16, the card's captured step against the
    CPU."""
    from tecogan_tpu_torch.config import FRVSR_PRESET

    cfg = FRVSR_PRESET.replace(batch_size=2, rnn_n=4, compute_dtype="bfloat16")
    bf16_step_vs_cpu(dev, "[bf16 step]", cfg, frvsr_batch(cfg, cfg.batch_size, 11), cpu_f32)


def check_bf16_gan_step_vs_cpu(dev, cpu_f32: dict) -> None:
    """Phase 10b: phase 10's TecoGAN step (TECOGAN_PRESET's widths, batch 1,
    3 frames with ping-pong, VGG19 random weights) in bfloat16, gate open,
    TF32 off, the card's captured step against the CPU."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET

    cfg = TECOGAN_PRESET.replace(batch_size=1, rnn_n=3, compute_dtype="bfloat16")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        bf16_step_vs_cpu(dev, "[bf16 gan step]", cfg, frvsr_batch(cfg, cfg.batch_size, 13),
                         cpu_f32, vgg_seed=7)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def bf16_train(dev, cfg, out_dir: str, steps: int, steady, label: str, **train_kw) -> dict:
    """``train()`` of ``cfg`` (bfloat16) for ``steps`` steps, captured (the
    default), paced by the device as a user's run: nothing synchronises
    inside, and a step's time is the gap between successive steps' starts
    over ``steady``. Each step's launches are read on the host (a replay
    adds its capture's): exactly a step's, twice that at the first (its
    warm-up and one replay); only the bfloat16 library entries run; the
    state stays float32. Returns the state, ms/step, peak and graph pool
    MiB, capture s, one steady step's launches and train()'s output."""
    import io

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.loop import train
    from tecogan_tpu_torch.train.trainer import named_state_tensors

    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    starts, launches, trainers = [], [], []
    train_step = Trainer.train_step

    def step(self, state, hr_seq):
        if self not in trainers:
            trainers.append(self)
        before = {k: w.launches for k, w in kernels.items()}
        starts.append(time.perf_counter())
        out = train_step(self, state, hr_seq)
        launches.append({k: w.launches - before[k] for k, w in kernels.items()})
        return out

    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    Trainer.train_step = step
    try:
        with contextlib.redirect_stdout(printed), entries_called() as entries:
            state = train(cfg, out_dir, dev, max_steps=steps, test_while_train=False, **train_kw)
        torch.cuda.synchronize()
    finally:
        Trainer.train_step = train_step
    wall = time.perf_counter() - t0
    text = printed.getvalue()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    if len(trainers) != 1 or not trainers[0].capture or trainers[0].recaptures:
        raise RuntimeError(f"{label}: {len(trainers)} trainers, capture "
                           f"{[t.capture for t in trainers]}")
    pool, capture_s = trainers[0].pool_bytes() / 2**20, trainers[0].capture_s
    del trainers[:]
    if state.step != steps or len(starts) != steps:
        raise RuntimeError(f"{label}: {state.step} steps, {len(starts)} step calls")
    check_step_launches(launches, (0,), step_launch_want(cfg), label)
    if set(entries) != BF16_ENTRIES:
        raise RuntimeError(f"{label}: library entries {entries}, want only {BF16_ENTRIES}")
    if "compute dtype bfloat16, float32 master weights" not in text:
        raise RuntimeError(f"{label}: train() did not name the dtype: {text[-2000:]}")
    ints = {"device_step", "counter_with_d", "counter_wo_d", "d_opt.count"}
    for name, t in named_state_tensors(state):
        if t.dtype != (torch.int32 if name in ints else torch.float32):
            raise RuntimeError(f"{label}: state tensor {name} is {t.dtype}")
    if not all(math.isfinite(float(v)) for v in state.ema_losses.values()):
        raise RuntimeError(f"{label}: loss EMAs {state.ema_losses}")
    a, b = steady
    return dict(state=state, ms=(starts[b] - starts[a]) / (b - a) * 1e3, peak=peak, pool=pool,
                capture_s=capture_s, launches=launches[-1], text=text, wall=wall,
                entries=entries)


def log_against_f32(label: str, name: str, bf16: dict, prof: dict, f32: dict) -> None:
    """bfloat16 beside float32 from the same call: the replay's device time
    and split, one batch alone, the eager chain backward, peak and pool."""
    b, f = prof["captured"], f32["profile"]["captured"]
    log(f"{label} {name}, bfloat16 beside float32 (same call): a replay's device time "
        f"{b['device_ms']:.2f} vs {f['device_ms']:.2f} ms; one batch alone, captured, "
        f"{b['alone'][0]:.2f}-{b['alone'][1]:.2f} vs {f['alone'][0]:.2f}-{f['alone'][1]:.2f} "
        f"ms/step; peak {bf16['peak']:.0f} vs {f32['peak']:.0f} MiB above the run's start; "
        f"graph pool {bf16['pool']:.0f} vs {f32['pool']:.0f} MiB")
    log(f"{label} {name} replay split, bfloat16 vs float32 ms: " + "; ".join(
        f"{g} {b['split'][g]:.3f} vs {f['split'][g]:.3f}" for g in b["split"]))
    if "eager" in prof:
        e, fe = prof["eager"], f32["profile"]["eager"]
        log(f"{label} {name} eager step, bfloat16 vs float32: device {e['device_ms']:.2f} vs "
            f"{fe['device_ms']:.2f} ms, of which the chain's backward (plain-chain replay on "
            f"cuDNN) {prof['chain_bwd_ms']:.3f} vs {f32['profile']['chain_bwd_ms']:.3f} ms, "
            f"the chain forward {e['split']['chain kernel']:.3f} vs "
            f"{fe['split']['chain kernel']:.3f} ms; alone {e['alone'][0]:.2f}-"
            f"{e['alone'][1]:.2f} vs {fe['alone'][0]:.2f}-{fe['alone'][1]:.2f} ms/step")


def run_bf16_training(dev, card: str, tmp: str, f32: dict, f32_paced: dict):
    """Phase 8c: FRVSR_PRESET in bfloat16 through ``train()`` on phase 8's
    scenes, captured, paced (:func:`bf16_train`); 3 captured steps against
    3 eager ones, bit-equal; the profile, whose chain is the bfloat16
    tensor-core kernel; everything beside phase 8's float32 numbers
    (``f32``) and phase 8b's paced float32 ``train()`` (``f32_paced``).
    Returns one step's launches."""
    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.train import Trainer

    cfg = FRVSR_PRESET.replace(compute_dtype="bfloat16",
                               input_video_dir=os.path.join(tmp, "scenes"),
                               max_frm=SCENE_FRAMES - 1, display_freq=10**6,
                               summary_freq=10**6, save_freq=10**6)
    r = bf16_train(dev, cfg, os.path.join(tmp, "bf16_run"), BF16_TRAIN_STEPS, BF16_STEADY,
                   "[bf16 train]")
    state = r["state"]
    fresh = Trainer(cfg, "cpu").init_state(cfg.rand_seed)
    for prefix, m0, m1 in (("generator", fresh.generator, state.generator),
                           ("fnet", fresh.fnet, state.fnet)):
        for (name, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
            if torch.equal(p0, p1.detach().cpu()):
                raise RuntimeError(f"[bf16 train] {prefix}.{name} did not move")
    frames = cfg.batch_size * cfg.unroll_frames
    a, b = BF16_STEADY
    log(f"[bf16 train] FRVSR_PRESET ({cfg.num_resblock} resblocks, batch {cfg.batch_size}, "
        f"crop {cfg.crop_size}, {cfg.rnn_n} frames) in bfloat16, float32 master weights, "
        f"through train(), captured, {BF16_TRAIN_STEPS} steps in {r['wall']:.2f} s wall: paced "
        f"{r['ms']:.2f} ms/step over steps {a + 1}-{b + 1}, {frames / r['ms'] * 1e3:.1f} "
        f"frames/s (float32, phase 8b's native loader paced: {f32_paced['paced_ms']:.2f}); "
        f"launches a step {r['launches']} (the first twice that), library entries "
        f"{sorted(r['entries'])} only; every parameter moved, the state float32; capture "
        f"{r['capture_s']:.3f} s; card: {card}")
    check_captured_equals_eager(dev, cfg, "[bf16 train]")
    prof = profile_step(dev, cfg, state, {"captured": r["ms"]}, "FRVSR_PRESET bfloat16")
    log(f"[bf16 train] paced idle share {max(0.0, 1 - prof['captured']['device_ms'] / r['ms']):.1%}"
        f" (float32: {max(0.0, 1 - f32_paced['device_ms'] / f32_paced['paced_ms']):.1%}, "
        f"phase 8b)")
    log_against_f32("[bf16 train]", "FRVSR_PRESET", r, prof, f32)
    return r["launches"]


def run_bf16_tecogan_training(dev, card: str, tmp: str, f32: dict):
    """Phase 11b: TECOGAN_PRESET in bfloat16 through ``train()`` with random
    VGG19 weights on phase 8's scenes, warm-started from phase 8's float32
    FRVSR checkpoint, captured, paced (:func:`bf16_train`); the gate's
    counters; a replay's profile (the bfloat16 chain kernel), beside phase
    11's float32 numbers (``f32``). Returns one step's launches."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19

    cfg = TECOGAN_PRESET.replace(compute_dtype="bfloat16",
                                 input_video_dir=os.path.join(tmp, "scenes"),
                                 max_frm=SCENE_FRAMES - 1, display_freq=10**6,
                                 summary_freq=10**6, save_freq=10**6)
    ckpt = os.path.join(tmp, "run", "checkpoints")
    r = bf16_train(dev, cfg, os.path.join(tmp, "bf16_tecogan"), BF16_GAN_STEPS,
                   BF16_GAN_STEADY, "[bf16 gan train]", vgg=random_vgg19(cfg.rand_seed),
                   pre_trained_dir=ckpt)
    state = r["state"]
    if f"Warm-started weights from {ckpt}" not in r["text"]:
        raise RuntimeError("[bf16 gan train] no warm start in train()'s output")
    counters = (int(state.counter_with_d), int(state.counter_wo_d))
    if sum(counters) != BF16_GAN_STEPS or int(state.d_opt.count) != counters[0]:
        raise RuntimeError(f"[bf16 gan train] gate counters {counters}, Adam count "
                           f"{int(state.d_opt.count)}")
    frames = cfg.batch_size * cfg.unroll_frames
    a, b = BF16_GAN_STEADY
    log(f"[bf16 gan train] TECOGAN_PRESET ({cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, crop {cfg.crop_size}, {cfg.unroll_frames} frames ping-pong, VGG19 "
        f"random weights) in bfloat16, warm-started from phase 8's float32 FRVSR checkpoint, "
        f"captured, {BF16_GAN_STEPS} steps in {r['wall']:.2f} s wall: paced {r['ms']:.2f} "
        f"ms/step over steps {a + 1}-{b + 1}, {frames / r['ms'] * 1e3:.1f} frames/s (float32, "
        f"phase 11, synchronised around each step: {f32['ms']:.2f}); launches a step "
        f"{r['launches']} (the first twice that), library entries {sorted(r['entries'])} "
        f"only; gate: {counters[0]} steps with D, {counters[1]} without; the state float32; "
        f"capture {r['capture_s']:.3f} s; card: {card}")
    prof = profile_step(dev, cfg, state, {"captured": r["ms"]}, "TECOGAN_PRESET bfloat16",
                        vgg=random_vgg19(cfg.rand_seed), modes=("captured",))
    log_against_f32("[bf16 gan train]", "TECOGAN_PRESET", r, prof, f32)
    return r["launches"]


def check_serving_vs_cpu(dev) -> None:
    """Phase 12 (a): a 3-slot VSRServer at full width (16 blocks, the real
    FNet), float32 with TF32 off, GPU against CPU: streams attach on ticks
    0, 1 and 2, stream b sits out tick 2. Every output within PATH_TOL of
    the CPU's; b's state on the card bit-unchanged across its idle tick."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="float32")
    h, w = 64, 96
    rng = np.random.RandomState(12)
    frames = {sid: rng.rand(4, h, w, 3).astype(np.float32) for sid in "abc"}
    script = ["a", {"a": 0}, "b", {"a": 1, "b": 0}, "c", {"a": 2, "c": 0},
              {"a": 3, "b": 1, "c": 1}]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        outs, frozen = [], None
        for device in (dev, torch.device("cpu")):
            srv = VSRServer(cfg, *build_models(5, cfg), h, w, max_streams=3,
                            output="float32", device=device)
            got = {}
            for i, tick in enumerate(script):
                if isinstance(tick, str):
                    srv.open(tick)
                    continue
                before = [t[1].clone() for t in srv._state]
                out = srv.step({sid: frames[sid][k] for sid, k in tick.items()})
                got.update({(i, sid): torch.from_numpy(hr.copy()) for sid, hr in out.items()})
                if device.type == "cuda" and "b" in srv.open_streams and "b" not in tick:
                    frozen = all(torch.equal(a, t[1]) for a, t in zip(before, srv._state))
            outs.append(got)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    worst = 0.0
    for key, want in outs[1].items():
        if outs[0][key].shape != (4 * h, 4 * w, 3):
            raise RuntimeError(f"[serve] output {key} of {tuple(outs[0][key].shape)}")
        worst = max(worst, rel_err(outs[0][key], want)[1])
    log(f"[serve] (a) VSRServer GPU vs CPU, float32 (TF32 off), {NUM_RESBLOCK} resblocks, "
        f"3 slots of {h}x{w}, streams attached on ticks 0-2, b idle on tick 2: "
        f"{len(outs[1])} outputs, worst rel {worst:.3e} tol {PATH_TOL:.0e}; idle slot's "
        f"state on the card {'bit-unchanged' if frozen else 'CHANGED'}")
    if not worst <= PATH_TOL or frozen is not True or outs[0].keys() != outs[1].keys():
        raise RuntimeError(f"[serve] GPU vs CPU {worst:.3e}, idle slot unchanged: {frozen}")


def serve_ticks(srv, frames, ticks: int = FRAMES):
    """`ticks` ticks of every open stream of `srv` (stream k on frame t + k),
    fetch=False, each tick's frames read one tick later, as a writer
    thread reads them. Returns (wall seconds, the last tick's frames);
    ``serve_ticks.step_s`` holds the host's seconds inside ``step``."""
    streams = list(srv.open_streams)
    t0 = time.perf_counter()
    last, step_s = {}, 0.0
    for t in range(ticks):
        t_s = time.perf_counter()
        out = srv.step({sid: frames[sid][(t + k) % len(frames[sid])]
                        for k, sid in enumerate(streams)}, fetch=False)
        step_s += time.perf_counter() - t_s
        for hr in last.values():
            np.asarray(hr)
        last = out
    arrays = {sid: np.asarray(hr) for sid, hr in last.items()}
    torch.cuda.synchronize()
    serve_ticks.step_s = step_s
    return time.perf_counter() - t0, arrays


def profile_serving(srv, frames, secs: float, label: str) -> dict:
    """One serve_ticks run under torch.profiler, split by kernel group; the
    profile must show the chain (the bfloat16 tensor-core kernel) and K1
    launched as often as the counters say."""
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4

    before = (upsample4.launches, resblock_chain.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_ticks(srv, frames)
    counted = (upsample4.launches - before[0], resblock_chain.launches - before[1])
    total, split, names, by_op = device_split(prof)
    if total <= 0:
        raise RuntimeError(f"[profile] serving {label}: torch.profiler recorded no device time")
    idle = max(0.0, 1 - total / 1e3 / (secs * 1e3))
    log(f"[profile] serving {label}, one run of {FRAMES} ticks: {total / 1e3:.2f} ms of "
        f"device time, {total / 1e3 / FRAMES:.3f} ms/tick, against {secs * 1e3:.2f} ms of "
        f"wall unprofiled (device idle share {idle:.1%})")
    log_split(total, split, by_op)
    if counted != (2 * FRAMES, NUM_RESBLOCK * FRAMES):
        raise RuntimeError(f"[profile] serving {label}: the counters say K1 {counted[0]}, "
                           f"chain {counted[1]}; want {2 * FRAMES}, {NUM_RESBLOCK * FRAMES}")
    profiled_launches(names, counted[1], counted[0], f"serving {label}")
    return {"device_ms": total / 1e3, "idle": idle}


def run_serving(dev, card: str):
    """Phase 12 (b): MultiGeometryServer in bfloat16 at full width, a
    4-slot bucket of 144x180 streams and a bucket of two 120x180 ones,
    FRAMES ticks after prewarm (which captures each bucket's tick),
    counted (the main path of serving), each bucket's graph pool, and an
    eviction that gives the evicted bucket's pool back; then VSRServer
    pools of 1, 4 and 8 slots at 144x180, captured and with
    ``capture=False``, each timed in turns and profiled. Returns (launches
    per bucket tick, the models, the pool records)."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.serve import MultiGeometryServer, VSRServer

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16")
    rng = np.random.RandomState(13)
    geos = {"cal": (LR_H, LR_W), "walk": SERVE_GEO2}
    clips = {g: (rng.rand(FRAMES, *hw, 3) * 255).astype(np.uint8) for g, hw in geos.items()}
    srv = MultiGeometryServer(cfg, *build_models(6, cfg), slots_per_geometry=SERVE_SLOTS,
                              output="uint8", device=dev)
    t0 = time.perf_counter()
    srv.prewarm(geos.values())
    warm = time.perf_counter() - t0
    streams = {**{f"cal{i}": "cal" for i in range(SERVE_SLOTS)}, "walk0": "walk", "walk1": "walk"}
    for sid, g in streams.items():
        srv.open(sid, *geos[g])
    frames = {sid: np.roll(clips[g], -i, axis=0) for i, (sid, g) in enumerate(streams.items())}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    upsample4.launches = 0
    resblock_chain.launches = 0
    secs, last = serve_ticks(srv, frames)
    launches = {"upsample4": upsample4.launches, "resblock_chain": resblock_chain.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    bucket_ticks = FRAMES * len(geos)
    need = {"upsample4": 2 * bucket_ticks, "resblock_chain": NUM_RESBLOCK * bucket_ticks}
    log(f"[serve] (b) launches over {FRAMES} ticks of {len(geos)} captured buckets "
        f"{launches}, want {need}")
    if launches != need:
        raise RuntimeError(f"[serve] launched {launches}, want {need}")
    for sid, hr in last.items():
        h, w = geos[streams[sid]]
        if hr.shape != (4 * h, 4 * w, 3) or hr.dtype != np.uint8 or hr.min() == hr.max():
            raise RuntimeError(f"[serve] {sid}: output {hr.shape} {hr.dtype}, "
                               f"range [{hr.min()}, {hr.max()}]")
    pools = {geo: b.graph_pool_bytes() / 2**20 for geo, b in srv._buckets.items()}
    log(f"[serve] (b) MultiGeometryServer, bfloat16, {NUM_RESBLOCK} resblocks, buckets "
        f"{srv.geometries}: prewarm (capture) {warm:.2f} s; {FRAMES} ticks of {len(streams)} "
        f"streams in {secs:.3f} s, {secs / FRAMES * 1e3:.2f} ms/tick, "
        f"{len(streams) * FRAMES / secs:.2f} frames/s aggregate; peak allocated "
        f"{peak:.0f} MiB; graph pools {', '.join(f'{g}: {m:.1f} MiB' for g, m in pools.items())} "
        f"(bucket_bytes, the JAX formula, counts {', '.join(f'{g}: {srv.bucket_bytes(*g) / 2**20:.1f} MiB' for g in pools)}); card: {card}")
    check_eviction(srv, geos["walk"], ["walk0", "walk1"])
    models = (srv.generator, srv.fnet)
    pools = {}
    for slots in SERVE_POOLS:
        ids = [f"s{i}" for i in range(slots)]
        frames = {sid: np.roll(clips["cal"], -i, axis=0) for i, sid in enumerate(ids)}
        recs = {}
        for mode, capture in (("captured", None), ("eager", False)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            pool = VSRServer(cfg, *models, LR_H, LR_W, max_streams=slots, output="uint8",
                             device=dev, capture=capture)
            pool.prewarm()
            for sid in ids:
                pool.open(sid)
            first, _ = serve_ticks(pool, frames)  # the first run after prewarm
            recs[mode] = {"pool": pool, "first_ms_per_tick": first / FRAMES * 1e3,
                          "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
                          "graph_pool_mib": pool.graph_pool_bytes() / 2**20,
                          "secs": [], "step_s": []}
        for mode in ("eager", "captured", "captured", "eager"):
            rec = recs[mode]
            secs, _ = serve_ticks(rec["pool"], frames)
            rec["secs"].append(secs)
            rec["step_s"].append(serve_ticks.step_s)
        for mode, rec in recs.items():
            secs = float(np.median(rec["secs"]))
            rec.update({"slots": slots, "ms_per_tick": [s / FRAMES * 1e3 for s in rec["secs"]],
                        "frames_per_s": [slots * FRAMES / s for s in rec["secs"]],
                        "host_step_ms": [s / FRAMES * 1e3 for s in rec["step_s"]]})
            log(f"[serve] (b) VSRServer {slots} slot(s) of {LR_H}x{LR_W}, bfloat16, {mode}: "
                f"{FRAMES} ticks, {', '.join(f'{m:.3f}' for m in rec['ms_per_tick'])} ms/tick, "
                f"{', '.join(f'{f:.2f}' for f in rec['frames_per_s'])} frames/s aggregate (the "
                f"first {FRAMES} ticks after prewarm: {rec['first_ms_per_tick']:.3f} ms/tick); "
                f"the host spends {', '.join(f'{m:.3f}' for m in rec['host_step_ms'])} ms/tick "
                f"inside step(); peak allocated {rec['peak_mib']:.0f} MiB above what was "
                f"allocated before the pool (prewarm and first run), graph pool "
                f"{rec['graph_pool_mib']:.1f} MiB; card: {card}")
            rec.update(profile_serving(rec["pool"], frames, secs, f"{slots} slot(s) {mode}"))
        if slots == 1:
            log_tick_host_split(recs["captured"]["pool"], recs["eager"]["pool"])
        pools[slots] = {m: {k: v for k, v in r.items() if k not in ("pool", "secs", "step_s")}
                        for m, r in recs.items()}
    log("[serve] (b) pool records " + json.dumps({str(k): v for k, v in pools.items()}))
    per_tick = {k: v / bucket_ticks for k, v in launches.items()}
    return per_tick, models, pools


def check_eviction(srv, geo, stream_ids) -> None:
    """Close the streams of bucket ``geo``, then open a smaller third
    geometry under a budget that fits two buckets: the idle ``geo`` bucket
    is evicted, and no device segment of its graphs' pools remains."""
    tick = next(iter(srv._buckets[geo]._programs.values()))
    pool_id, held = tick.pool_id, tick.pool_bytes()
    for sid in stream_ids:
        srv.close(sid)
    third = (geo[0] - 24, geo[1])
    saved = srv.state_budget_mb
    srv.state_budget_mb = (srv.footprint_bytes + srv.bucket_bytes(*third) - 1) / 2**20
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    try:
        srv.open("third", *third)
    finally:
        srv.state_budget_mb = saved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool_id)
    log(f"[serve] (b) eviction: opening {third[0]}x{third[1]} evicted the idle "
        f"{geo[0]}x{geo[1]} bucket (its graph pool held {held / 2**20:.1f} MiB); the card's "
        f"reserved memory went from {reserved / 2**20:.1f} to "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB with the new bucket's buffers, "
        f"{left} bytes of the evicted pool left; buckets {srv.geometries}")
    if geo in srv.geometries or left or held <= 0:
        raise RuntimeError(f"[serve] eviction: buckets {srv.geometries}, {left} bytes of the "
                           f"pool left of {held}")
    srv.close("third")


def log_tick_host_split(captured, eager) -> None:
    """The host's seconds to queue a 1-slot tick (no wait on the device:
    each is queued FRAMES times, then the device is synchronised): the
    captured tick's replay, and the eager tick and its parts."""
    from tecogan_tpu_torch.recurrent.step import RecurrentState, generator_step, upscale_flow

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            fn()
        ms = (time.perf_counter() - t0) / FRAMES * 1e3
        torch.cuda.synchronize()
        return ms

    lr = eager._lr_batch(torch.uint8)
    with torch.inference_mode():
        state = RecurrentState(*(t.clone() for t in eager._state))
        x = (lr.float() / 255.0).to(eager.dtype)
        pair = torch.cat([state.prev_lr, x], dim=-1)
        flow = upscale_flow(eager.fnet(pair), eager.height, eager.width)
        parts = {"captured tick (replay)": captured._programs[torch.uint8],
                 "eager tick (masks, frame step, state)": eager._programs[torch.uint8],
                 "FNet": lambda: eager.fnet(pair),
                 "warp + generator": lambda: generator_step(eager.generator, state, x, flow)}
        times = {name: host_ms(fn) for name, fn in parts.items()}
    log("[serve] (b) host time to queue one 1-slot tick's parts: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))


def recurrence_gain(dev, gen, fnet, frames: int = 16) -> list:
    """max|hr - hr'| after frames 1, frames // 2 and frames of two float32
    runs from the zero state, one with 1e-4 added to prev_hr: how much the
    generator amplifies a change of its previous output."""
    from tecogan_tpu_torch.data.synthetic import synthetic_clip
    from tecogan_tpu_torch.recurrent.step import frame_step, init_state

    clip = torch.from_numpy(synthetic_clip(frames, 48, 64, seed=45, content="natural")
                            .astype(np.float32)).to(dev)
    a = init_state(1, 48, 64, device=dev)
    b = a._replace(prev_hr=a.prev_hr + 1e-4)
    diffs = []
    with torch.inference_mode():
        for t in range(frames):
            a, hr_a = frame_step(gen, fnet, a, clip[t:t + 1])
            b, hr_b = frame_step(gen, fnet, b, clip[t:t + 1])
            diffs.append((hr_a - hr_b).abs().max().item())
    return [diffs[0], diffs[frames // 2 - 1], diffs[-1]]


EXPORT_CHILD = r"""
import json, sys
import torch
import tecogan_tpu_torch.kernels as kernels
torch.backends.cudnn.deterministic = True
program = torch.export.load(sys.argv[1]).module()
inputs = torch.load(sys.argv[2])
args = [inputs[k].cuda() for k in ("prev_lr", "prev_hr", "lr")]
kernels.upsample4.launches = kernels.resblock_chain.launches = 0
with torch.inference_mode():
    out = program(*args)
torch.cuda.synchronize()
torch.save([t.cpu() for t in out], sys.argv[3])
print(json.dumps({"upsample4": kernels.upsample4.launches,
                  "resblock_chain": kernels.resblock_chain.launches,
                  "modules": sorted(m for m in sys.modules if m.startswith("tecogan_tpu"))}))
"""


def check_export(dev, tmp: str, models) -> None:
    """Phase 12 (c): three ticks of a 4-slot VSRServer at 144x180 in
    bfloat16, captured and with ``capture=False``, bit-equal (outputs and
    state) under cuDNN's deterministic algorithms; then the frame step
    exported at (4, 144, 180), saved, loaded and run in a fresh process
    that imports only torch and tecogan_tpu_torch.kernels: bit-equal to the
    captured tick on the same state and frames."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import VSRServer, export_frame_step, save_frame_step
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16")
    rng = np.random.RandomState(14)
    clip = (rng.rand(3, SERVE_SLOTS, LR_H, LR_W, 3) * 255).astype(np.uint8)
    path, inputs, outputs = (os.path.join(tmp, n) for n in ("step.pt2", "in.pt", "out.pt"))
    torch.backends.cudnn.deterministic = True
    try:
        ids = [f"s{i}" for i in range(SERVE_SLOTS)]
        ticks = {}
        for mode, capture in (("eager", False), ("captured", None)):
            srv = VSRServer(cfg, *models, LR_H, LR_W, max_streams=SERVE_SLOTS,
                            output="uint8", device=dev, capture=capture)
            for sid in ids:
                srv.open(sid)
            ticks[mode] = []
            for t in range(3):
                if t == 2:
                    torch.save({"prev_lr": srv._state.prev_lr.cpu(),
                                "prev_hr": srv._state.prev_hr.cpu(),
                                "lr": torch.from_numpy(clip[2])}, inputs)
                out = srv.step(dict(zip(ids, clip[t])))
                ticks[mode].append([np.stack([out[sid] for sid in ids]),
                                    *(t_.view(torch.int16).cpu().numpy() for t_ in srv._state)])
        if not isinstance(srv._programs[torch.uint8], CapturedProgram):
            raise RuntimeError("[serve] (c) the server's tick is not a captured graph")
        same = all(np.array_equal(a, b) for got, want in zip(ticks["captured"], ticks["eager"])
                   for a, b in zip(got, want))
        log(f"[serve] (c) VSRServer {SERVE_SLOTS} slots of {LR_H}x{LR_W}, bfloat16, cuDNN "
            f"deterministic: 3 captured ticks vs capture=False, outputs and state "
            f"{'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError("[serve] (c) the captured tick differs from the eager one")
        want = [srv._state.prev_lr.cpu(), srv._state.prev_hr.cpu(),
                torch.from_numpy(np.stack([out[sid] for sid in ids]))]
        t0 = time.perf_counter()
        save_frame_step(export_frame_step(cfg, *models, batch=SERVE_SLOTS, height=LR_H,
                                          width=LR_W, device=dev), path)
        export_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, inputs, outputs],
                           cwd=REPO, capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise RuntimeError(f"[serve] the exported step's process failed:\n{child.stderr[-4000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    got = torch.load(outputs)
    equal = [torch.equal(g, w) for g, w in zip(got, want)]
    loaded = [m for m in report["modules"] if m.startswith(("tecogan_tpu_torch.models",
                                                             "tecogan_tpu_torch.serve",
                                                             "tecogan_tpu_torch.recurrent"))]
    log(f"[serve] (c) exported frame step ({SERVE_SLOTS},{LR_H},{LR_W}) bfloat16 uint8: "
        f"export + save {export_s:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB; a fresh "
        f"process loaded and ran it in {child_s:.2f} s with launches upsample4 "
        f"{report['upsample4']}, resblock_chain {report['resblock_chain']}; (prev_lr, "
        f"prev_hr, hr) bit-equal to VSRServer's captured tick: {equal}; model modules imported "
        f"there: {loaded or 'none'}")
    if not all(equal) or loaded or report["upsample4"] != 2 or \
            report["resblock_chain"] != NUM_RESBLOCK:
        raise RuntimeError(f"[serve] exported step: equal {equal}, modules {loaded}, {report}")


def write_png_paeth(path: str, img: np.ndarray) -> None:
    """An RGB PNG whose every row is Paeth-filtered (as PIL writes
    natural images), filtered in numpy from the original pixels."""
    import struct
    import zlib

    from tecogan_tpu_torch.data.png import SIGNATURE, _chunk

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a, b, d = (np.zeros_like(x) for _ in range(3))
    a[:, c:], b[1:], d[1:, c:] = x[:, :-c], x[:-1], x[:-1, :-c]
    p = a + b - d
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - d)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)],
                         axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def run_serve_cli(dev, card: str, tmp: str) -> None:
    """Phase 12 (d): ``cli.serve`` on three LR PNG dirs (two 144x180, one
    120x180 written with Paeth rows) with a 16-block params npz: in float32
    (TF32 off) each stream within 1 u8 level of ``cli.main --mode
    inference`` on its dir; then a timed bfloat16 run with the split of its
    wall. Also times the PNG decode of one Paeth frame at 144x180 and at
    576x720."""
    import io

    from tecogan_tpu_torch.cli import main as cli_main
    from tecogan_tpu_torch.cli import serve as cli_serve
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.png import read_png, write_png
    from tecogan_tpu_torch.data.synthetic import synthetic_clip
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram
    from tecogan_tpu_torch.weights import params_to_npz, to_jax_params

    npz = os.path.join(tmp, "serve_params.npz")
    cfg = TecoConfig(num_resblock=NUM_RESBLOCK)
    gen, fnet = build_models(6, cfg)
    # At full width the random generator amplifies a change of its warped
    # previous output from frame to frame (logged below), so a float32
    # rounding difference between two batchings (cli.serve's 4-slot ticks,
    # cli.main's 23-frame FNet chunks) grows to 255 levels within a few
    # dozen frames. Trained weights are stable; scaling the stem's weights
    # on the 48 warped channels by DAMP_WARPED makes these so, and the
    # comparison then checks the plumbing: frame order, warm-up, streams
    # and buckets.
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gains = {"as drawn": recurrence_gain(dev, *(m.to(dev) for m in (gen, fnet)))}
        with torch.no_grad():
            gen.input_stage_conv.weight[:, 3:].mul_(DAMP_WARPED)
        gains[f"damped x{DAMP_WARPED}"] = recurrence_gain(dev, gen, fnet)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log("[serve] (d) a 1e-4 change of prev_hr, float32, 48x64, max|hr - hr'| after frames "
        "1, 8, 16: " + "; ".join(f"{k} " + ", ".join(f"{v:.1e}" for v in g)
                                 for k, g in gains.items()))
    if not gains[f"damped x{DAMP_WARPED}"][-1] < 1e-3:
        raise RuntimeError(f"[serve] the damped recurrence does not settle: {gains}")
    params_to_npz(npz, **dict(zip(("generator", "fnet"), to_jax_params(gen, fnet))))
    dirs = {"cal_a": ((LR_H, LR_W), 24, write_png), "cal_b": ((LR_H, LR_W), 16, write_png),
            "walk": (SERVE_GEO2, 20, write_png_paeth)}
    for i, (name, ((h, w), n, writer)) in enumerate(dirs.items()):
        os.makedirs(os.path.join(tmp, "LR", name))
        clip = (synthetic_clip(n, h, w, seed=40 + i, content="natural") * 255).astype(np.uint8)
        for t in range(n):
            writer(os.path.join(tmp, "LR", name, f"{t:04d}.png"), clip[t])
    paths = [os.path.join(tmp, "LR", name) for name in dirs]

    def quiet(fn, argv):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            result = fn(argv)
            wall = time.perf_counter() - t0
        return result, wall, printed.getvalue()

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # The budget counts the captured ticks' graph pools, about twice
        # bfloat16's in float32: two 4-slot buckets need more than the
        # default 2048 MB.
        stats, _, _ = quiet(cli_serve.main, [
            "--device", str(dev), "--input_dirs", ",".join(paths), "--output_dir",
            os.path.join(tmp, "served32"), "--params_npz", npz, "--compute_dtype", "float32",
            "--state_budget_mb", "16384"])
        worst = {}
        for name, path in zip(dirs, paths):
            quiet(cli_main.main, ["--mode", "inference", "--device", str(dev), "--input_dir_LR",
                                  path, "--output_dir", os.path.join(tmp, "single32"),
                                  "--output_pre", name, "--params_npz", npz,
                                  "--compute_dtype", "float32"])
            files = [f"output_{i:04d}.png" for i in range(dirs[name][1])]
            got = read_frames([os.path.join(tmp, "served32", name, f) for f in files])
            want = read_frames([os.path.join(tmp, "single32", name, f) for f in files])
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            worst[name] = (int(diff.max()), float((diff != 0).mean()))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log(f"[serve] (d) cli.serve float32 (TF32 off) vs cli.main --mode inference per dir: "
        f"(max u8 difference, share of values that differ) {worst}; written {stats['written']}")
    if stats["written"] != {n: d[1] for n, d in dirs.items()} or \
            max(m for m, _ in worst.values()) > 1:
        raise RuntimeError(f"[serve] cli.serve vs cli.main: {worst}, {stats['written']}")

    # Timed bfloat16 runs, the PNG codecs in turns.
    source_frames = sum(d[1] for d in dirs.values())
    for i, codec in enumerate(("native", "python", "python", "native")):
        captures, counts = CapturedProgram.captures, codec_counts()
        with python_codec() if codec == "python" else contextlib.nullcontext():
            stats, wall, printed = quiet(cli_serve.main, [
                "--device", str(dev), "--input_dirs", ",".join(paths), "--output_dir",
                os.path.join(tmp, f"served16_{i}"), "--params_npz", npz,
                "--compute_dtype", "bfloat16"])
        captures = CapturedProgram.captures - captures
        native = tuple(n - c for n, c in zip(codec_counts(), counts))
        if captures != 2:  # one tick graph per geometry bucket, captured by its prewarm
            raise RuntimeError(f"[serve] (d) cli.serve captured {captures} graphs, want 2")
        want = (source_frames, stats["frames"]) if codec == "native" else (0, 0)
        if native != want:
            raise RuntimeError(f"[serve] (d) cli.serve ({codec} codec): the native library "
                               f"decoded and encoded {native} frames, want {want}")
        if i == 0:
            for line in printed.splitlines():
                if line.startswith(("total time", "io:", "[serve] prewarmed")) or \
                        "aggregate" in line:
                    log(f"[serve] (d) | {line}")
        log(f"[serve] (d) cli.serve bfloat16, {codec} PNG codec (the native library decoded "
            f"and encoded {native} frames), 3 PNG dirs ({', '.join(f'{n} {d[0][0]}x{d[0][1]} x{d[1]}' for n, d in dirs.items())}; walk Paeth-filtered): "
            f"{stats['frames']} HR PNGs in {stats['secs']:.3f} s of serving, "
            f"{stats['frames'] / stats['secs']:.2f} frames/s aggregate, {wall:.3f} s end to end "
            f"with the writer flush; {stats['ticks']} ticks; decode {stats['decode_s']:.3f} s "
            f"on the source threads, ticks {stats['tick_s']:.3f} s, waiting for decode or a "
            f"prewarm {stats['idle_s']:.3f} s, encode {stats['encode_s']:.3f} s on the writer "
            f"threads, writer flush {stats['flush_s']:.3f} s; {captures} tick graphs captured "
            f"(one a geometry); card: {card}")

    rng = np.random.RandomState(15)
    for h, w in ((LR_H, LR_W), (4 * LR_H, 4 * LR_W)):
        img = (synthetic_clip(1, h, w, seed=50, content="natural")[0] * 255).astype(np.uint8)
        img = np.clip(img.astype(np.int16) + rng.randint(-3, 4, img.shape), 0, 255).astype(np.uint8)
        times = {}
        for kind, writer in (("filter 0", write_png), ("Paeth", write_png_paeth)):
            path = os.path.join(tmp, f"decode_{h}x{w}_{kind[0]}.png")
            writer(path, img)
            if not np.array_equal(read_png(path), img):
                raise RuntimeError(f"[serve] {kind} PNG {h}x{w} decodes wrong")
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                read_png(path)
                reps.append(time.perf_counter() - t0)
            times[kind] = float(np.median(reps)) * 1e3
        log(f"[serve] PNG decode {h}x{w} RGB (median of 5, host CPU of the card's machine): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()))


# ---------------------------------------------------------------- native data path
# The FRVSR train() split (phase 8b): steps a train() call, the steady
# window (steps 11-25, 1-based), steps of the one-batch and upload timings.
SPLIT_STEPS, SPLIT_STEADY, SPLIT_ALONE = 25, (10, 24), 20


@contextlib.contextmanager
def python_codec():
    """The python PNG codec (``data/png.py``) for the inference CLI's and
    the serving sources' frame I/O, as where the native library cannot be
    built: ``_native_io`` returns None."""
    from tecogan_tpu_torch.data import inference

    native_io = inference._native_io
    inference._native_io = lambda num_threads=8: None
    try:
        yield
    finally:
        inference._native_io = native_io


def codec_counts():
    """(frames decoded, frames encoded) by the native library so far."""
    from tecogan_tpu_torch.data.native_loader import NativeFrameIO

    return NativeFrameIO.decoded, NativeFrameIO.encoded


def build_native(card: str) -> None:
    """Phase 3b: the card machine's toolchain for the native data-loader
    core, and its build from ``tecogan_tpu_torch/csrc/tecodata.cpp``."""
    from tecogan_tpu_torch.data import native_loader

    found = {}
    for header in ("png.h", "zlib.h"):
        probe = subprocess.run(["g++", "-xc++", "-E", "-"], input=f"#include <{header}>\n",
                               capture_output=True, text=True)
        found[header] = probe.returncode == 0
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    libs = [line.strip() for line in ldconfig.splitlines()
            if "libpng" in line or "libz." in line]
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    log(f"[native] toolchain: {gxx.splitlines()[0]}; "
        + ", ".join(f"<{h}> {'found' if ok else 'missing'}" for h, ok in found.items())
        + f"; ldconfig -p: {libs or 'no libpng or libz'}")
    if not found["zlib.h"]:
        raise RuntimeError("[native] no <zlib.h>: the native data-loader core cannot build")
    path = native_loader.library_path()
    fresh = not path.exists()
    t0 = time.perf_counter()
    native_loader.load_library()
    log(f"[native] {'built' if fresh else 'found'} {path.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.2f} s from tecogan_tpu_torch/csrc/tecodata.cpp: "
        f"{' '.join(('g++', *native_loader._CXXFLAGS, '...', *native_loader._LDFLAGS))}, the "
        f"port's own PNG codec on zlib (libpng {'present' if found['png.h'] else 'absent'} "
        f"here; the build never uses it); card: {card}")


def run_loader_split(dev, card: str, tmp: str) -> dict:
    """Phase 8b: where FRVSR_PRESET's ``train()`` loses time against its
    one-batch step. On phase 8's scenes, captured, in turns: ``train()``
    with the native executor, the python executor, and a loader whose
    every batch was decoded before the first step; each once with a
    synchronisation around every step (as phase 8 times it) and once
    paced by the device (a user's run: the time between successive steps'
    starts, one synchronisation at the end); the uploads' and the loader
    waits' host seconds inside. Then on one batch with no loader: steps
    synchronised one by one and queued back to back, and the upload alone
    (``_Program.upload``: the staging copy and its event wait). Idle share
    = 1 - a replay's device time (profiled) / ms a step. Returns the
    native loader's paced ms/step and the replay's device ms (phase 8c's
    float32 yardstick)."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.data.loader import BatchLoader
    from tecogan_tpu_torch.data.native_loader import NativeExecutor
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train import loop
    from tecogan_tpu_torch.train import trainer as trainer_mod

    cfg = FRVSR_PRESET.replace(input_video_dir=os.path.join(tmp, "scenes"),
                               max_frm=SCENE_FRAMES - 1, display_freq=10**6,
                               summary_freq=10**6, save_freq=10**6)
    frames = cfg.batch_size * cfg.unroll_frames
    a, b = SPLIT_STEADY

    class Prefilled:
        """Stands in for train()'s loader: every batch of the run decoded
        (natively) before the first step, so no decode runs during the
        steps."""

        executor_used = "prefilled"

        def __init__(self, dataset, seed=None, executor=None):
            self.dataset, self.seed, self.batches = dataset, seed, None

        def start(self):
            if self.batches is None:
                with BatchLoader(self.dataset, seed=self.seed, executor="native") as src:
                    self.batches = [src.next_batch() for _ in range(SPLIT_STEPS)]
            return self

        def next_batch(self):
            return self.start().batches.pop(0)

        def stop(self):
            pass

        __enter__ = start

        def __exit__(self, *exc):
            self.stop()

    upload = trainer_mod._Program.upload
    train_step = Trainer.train_step
    results = {}
    for executor, synced in (("native", True), ("python", True), ("prefilled", True),
                             ("prefilled", False), ("python", False), ("native", False)):
        made, waits, uploads, starts, synced_s = [], [], [], [], []

        def make(dataset, **kw):
            loader = (Prefilled(dataset, kw.get("seed")) if executor == "prefilled"
                      else BatchLoader(dataset, **{**kw, "executor": executor}))
            made.append(loader)
            next_batch = loader.next_batch

            def timed_next():
                t0 = time.perf_counter()
                batch = next_batch()
                waits.append(time.perf_counter() - t0)
                return batch
            loader.next_batch = timed_next
            return loader

        def timed_upload(self, batch):
            t0 = time.perf_counter()
            upload(self, batch)
            uploads.append(time.perf_counter() - t0)

        def step(self, state, hr_seq):
            if synced:
                torch.cuda.synchronize()
            starts.append(time.perf_counter())
            out = train_step(self, state, hr_seq)
            if synced:
                torch.cuda.synchronize()
                synced_s.append(time.perf_counter() - starts[-1])
            return out

        loop.BatchLoader, trainer_mod._Program.upload, Trainer.train_step = (
            make, timed_upload, step)
        sequences = NativeExecutor.sequences
        try:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                state = loop.train(cfg, os.path.join(tmp, f"split_{executor}_{synced}"), dev,
                                   max_steps=SPLIT_STEPS, test_while_train=False)
            torch.cuda.synchronize()
            end = time.perf_counter()
        finally:
            loop.BatchLoader, trainer_mod._Program.upload, Trainer.train_step = (
                BatchLoader, upload, train_step)
        sequences = NativeExecutor.sequences - sequences
        used = made[0].executor_used
        if used != executor or state.step != SPLIT_STEPS or len(starts) != SPLIT_STEPS:
            raise RuntimeError(f"[split] {executor}: the loader ran {used}, {state.step} steps; "
                               f"{printed.getvalue()[-2000:]}")
        if (sequences > 0) != (executor != "python"):
            raise RuntimeError(f"[split] {executor}: the native executor loaded {sequences} "
                               "sequences")
        ms = (sum(synced_s[a:b + 1]) / (b + 1 - a) if synced
              else (starts[b] - starts[a]) / (b - a)) * 1e3
        results[(executor, synced)] = dict(
            ms=ms, upload_ms=1e3 * float(np.mean(uploads[a:b + 1])),
            wait_ms=1e3 * float(np.mean(waits[a:b + 1])), sequences=sequences,
            wall=end - starts[0])

    # One batch, no loader: synchronised step by step, and back to back.
    trainer = Trainer(cfg, dev)
    state = trainer.init_state(cfg.rand_seed)
    batch = frvsr_batch(cfg, cfg.batch_size, 21)
    for _ in range(2):
        trainer.train_step(state, batch)
    alone = {}
    for mode in ("synced", "queued", "queued", "synced"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPLIT_ALONE):
            trainer.train_step(state, batch)
            if mode == "synced":
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        alone.setdefault(mode, []).append((time.perf_counter() - t0) / SPLIT_ALONE * 1e3)
    prog = trainer._program("train", state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SPLIT_ALONE):
            prog.upload(batch)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) / SPLIT_ALONE * 1e3
    copy_ms = device_split(prof)[0] / 1e3 / SPLIT_ALONE  # the staging copies' device time
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    device_ms = device_split(prof)[0] / 1e3
    if device_ms <= 0:
        raise RuntimeError("[split] torch.profiler recorded no device time")

    def idle(ms):
        return f"idle {max(0.0, 1 - device_ms / ms):.1%}"

    log(f"[split] FRVSR_PRESET train(), captured, batch {cfg.batch_size} x {cfg.unroll_frames} "
        f"frames ({batch.nbytes / 2**20:.2f} MiB uint8 a batch), steps {a + 1}-{b + 1} of "
        f"{SPLIT_STEPS}; a replay's device time {device_ms:.2f} ms; card: {card}")
    for (executor, synced), r in results.items():
        log(f"[split] train() {executor} loader, "
            f"{'a synchronisation around each step' if synced else 'paced by the device'}: "
            f"{r['ms']:.2f} ms/step, {frames / r['ms'] * 1e3:.1f} frames/s, {idle(r['ms'])}; "
            f"inside: upload {r['upload_ms']:.3f} ms, waiting for the loader "
            f"{r['wait_ms']:.3f} ms a step; native sequences {r['sequences']}")
    log(f"[split] one batch, no loader, {SPLIT_ALONE} steps a window in turns: "
        + "; ".join(f"{mode} {', '.join(f'{ms:.2f}' for ms in v)} ms/step ({idle(min(v))}-"
                    f"{idle(max(v))[5:]})" for mode, v in alone.items())
        + f"; the upload alone (staging copy + event wait, {batch.nbytes / 2**20:.2f} MiB): "
        f"{upload_ms:.3f} ms, {frames / upload_ms * 1e3:.1f} frames/s, the device busy "
        f"{copy_ms:.3f} ms of it with the copy (idle {max(0.0, 1 - copy_ms / upload_ms):.1%})")
    return dict(paced_ms=results[("native", False)]["ms"], device_ms=device_ms)


def check_codec(tmp: str, card: str) -> None:
    """Phase 9b: the native PNG codec against the python one on the card's
    machine: the 41 synthetic 576x720 HR PNGs of phase 9 (filter 0) and 8
    of them rewritten with every row Paeth-filtered decode bit-equal
    (``decode_frames_u8`` against ``read_rgb``); ``encode_frames`` then
    ``read_png`` gives the input back. Times both codecs on 8 threads."""
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.native_loader import NativeFrameIO
    from tecogan_tpu_torch.data.png import read_png, write_png
    from tecogan_tpu_torch.ops import list_png_in_dir

    paths = list_png_in_dir(os.path.join(tmp, "cli_hr"), prefix_skip="\x00")
    io = NativeFrameIO(8)
    try:
        t0 = time.perf_counter()
        native = io.decode_frames_u8(paths)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = read_frames(paths, 8)
        python_s = time.perf_counter() - t0
        if len(paths) != CLI_FRAMES or not np.array_equal(native, python):
            raise RuntimeError(f"[codec] {len(paths)} filter-0 PNGs: native != read_rgb in "
                               f"{int((native != python).sum())} values")
        paeth = [os.path.join(tmp, "codec", f"paeth_{i}.png") for i in range(8)]
        os.makedirs(os.path.dirname(paeth[0]))
        for path, img in zip(paeth, native):
            write_png_paeth(path, img)
        t0 = time.perf_counter()
        got = io.decode_frames_u8(paeth)
        paeth_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = read_frames(paeth, 8)
        paeth_python_s = time.perf_counter() - t0
        if not (np.array_equal(got, want) and np.array_equal(got, native[:8])):
            raise RuntimeError("[codec] Paeth PNGs: native != read_rgb")
        encoded = [os.path.join(tmp, "codec", f"enc_{i}.png") for i in range(8)]
        t0 = time.perf_counter()
        io.encode_frames(encoded, native[:8])
        encode_s = time.perf_counter() - t0
    finally:
        io.close()
    back = np.stack([read_png(p) for p in encoded])
    if not np.array_equal(back, native[:8]):
        raise RuntimeError("[codec] encode_frames -> read_png does not give the input back")
    t0 = time.perf_counter()
    for i, img in enumerate(native[:8]):
        write_png(os.path.join(tmp, "codec", f"py_{i}.png"), img)
    write_s = time.perf_counter() - t0
    mb = {name: np.mean([os.path.getsize(p) for p in ps]) / 1e6
          for name, ps in (("filter 0", paths), ("Paeth", paeth), ("native", encoded))}
    h, w = native.shape[1:3]
    log(f"[codec] native decode_frames_u8 == data/png.py read_rgb, bit for bit: {len(paths)} "
        f"{h}x{w} filter-0 PNGs and 8 Paeth-filtered ones; encode_frames -> read_png gives "
        f"the 8 frames back")
    log(f"[codec] {h}x{w} RGB, ms a frame (host CPU of the card's machine): decode, 8 threads: "
        f"filter 0 native {native_s / len(paths) * 1e3:.2f}, python "
        f"{python_s / len(paths) * 1e3:.2f}; Paeth native {paeth_native_s / 8 * 1e3:.2f}, "
        f"python {paeth_python_s / 8 * 1e3:.2f}; encode: native (8 threads, Sub, level 1, "
        f"Z_RLE) {encode_s / 8 * 1e3:.2f}, python write_png (one thread, filter 0, level 6) "
        f"{write_s / 8 * 1e3:.2f}; mean file MB: "
        + ", ".join(f"{k} {v:.3f}" for k, v in mb.items()) + f"; card: {card}")


def check_budget(dev, card: str, models) -> None:
    """Phase 12e: the serving state budget counts a captured bucket's graph
    pool. A 4-slot 144x180 bfloat16 bucket is prewarmed (its tick
    captured); the budget is then set below its pool, halfway between it
    and what a 120x180 bucket needs with its estimated pool, far above
    what the JAX formula (``bucket_bytes``) counts for both buckets
    together: the 120x180 geometry is refused while the first bucket
    serves a stream and evicts it once it is idle."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import MultiGeometryServer

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16")
    geo1, geo2 = (LR_H, LR_W), SERVE_GEO2
    srv = MultiGeometryServer(cfg, *models, slots_per_geometry=SERVE_SLOTS, output="uint8",
                              state_budget_mb=None, device=dev)
    srv.prewarm([geo1])
    pool = srv._buckets[geo1].graph_pool_bytes()
    formula = srv.bucket_bytes(*geo1) + srv.bucket_bytes(*geo2)
    estimate = srv.pool_estimate(*geo2)
    need = srv.bucket_bytes(*geo2) + estimate
    budget = (need + pool) / 2
    if not formula < need < budget < pool:
        raise RuntimeError(f"[budget] cannot set a budget below the pool: formula {formula}, "
                           f"the second bucket's need {need}, pool {pool}")
    srv.state_budget_mb = budget / 2**20
    srv.open("a", *geo1)
    try:
        srv.open("b", *geo2)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    if refused is None or set(srv.geometries) != {geo1}:
        raise RuntimeError(f"[budget] {geo2} admitted beside a busy captured bucket: "
                           f"{srv.geometries}")
    srv.close("a")
    srv.open("b", *geo2)
    if set(srv.geometries) != {geo2}:
        raise RuntimeError(f"[budget] {geo2} did not evict the idle bucket: {srv.geometries}")
    srv.close("b")
    log(f"[budget] {SERVE_SLOTS}-slot {geo1[0]}x{geo1[1]} bfloat16 bucket captured: graph pool "
        f"{pool / 2**20:.1f} MiB; state_budget_mb {srv.state_budget_mb:.1f} while "
        f"bucket_bytes, the JAX formula, counts {formula / 2**20:.1f} MiB for it and a "
        f"{geo2[0]}x{geo2[1]} bucket together; the {geo2[0]}x{geo2[1]} bucket's estimated pool "
        f"{estimate / 2**20:.1f} MiB. With a stream open it was refused ({refused[:120]}...); "
        f"once idle, the {geo1[0]}x{geo1[1]} bucket was evicted for it; card: {card}")


def phase(name: str, fn, *args):
    """Run one phase; its seconds go to ``phase.seconds``."""
    t0 = time.perf_counter()
    result = fn(*args)
    phase.seconds[name] = time.perf_counter() - t0
    return result


phase.seconds = {}
START = time.perf_counter()


def main() -> None:
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a GPU")
    card = card_line()
    log(f"[card] {card}")
    sys.path.insert(0, str(REPO))
    from tecogan_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[build] kernels built and loaded in {_build.build_and_load(verbose=True):.1f} s "
        f"-> {_build.library_path().relative_to(REPO)}")
    blocks = ctypes.c_int(0)
    _build.check(_build.library().tt_resblock_chain_bf16_blocks_per_sm(
        ctypes.byref(blocks)), "resblock_chain occupancy")
    log(f"[build] bfloat16 chain kernel: {blocks.value} resident blocks per SM")
    size, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().tt_resblock_chain_f32_clusters(
        ctypes.byref(size), ctypes.byref(clusters)), "resblock_chain clusters")
    log(f"[build] float32 chain kernel: clusters of {size.value} CTAs, {clusters.value} "
        f"clusters ({size.value * clusters.value} CTAs) resident at once "
        f"(cudaOccupancyMaxActiveClusters) on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    records = phase("3 kernels", check_kernels, dev)
    if "--kernels-only" in sys.argv[1:]:
        log("[main] --kernels-only: phases 1-3 done; no result line")
        return
    phase("3b native loader build", build_native, card)
    phase("4 autograd", check_autograd, dev)
    phase("5 path vs CPU", check_path_vs_cpu, dev)
    stream_launches = phase("6 streaming", run_main_path, dev, card)
    frvsr_cpu_f32 = phase("7 FRVSR step vs CPU", check_step_vs_cpu, dev)
    phase("7b bf16 FRVSR step vs CPU", check_bf16_step_vs_cpu, dev, frvsr_cpu_f32)
    # Phase 8 runs as a user's training does, with PyTorch's default flags:
    # cuDNN convolutions in TF32, float32 matmuls in full float32.
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_step_launches, train_f32 = phase(
            "8 FRVSR training", run_training, dev, card, tmp)
        paced_f32 = phase("8b loader split", run_loader_split, dev, card, tmp)
        bf16_step_launches = phase("8c bf16 FRVSR training", run_bf16_training, dev, card, tmp,
                                   train_f32, paced_f32)
        # Phase 9 runs as a user's CLI does, with the same default flags.
        cli_launches = phase("9 CLI and suite", run_cli, dev, card, tmp,
                             os.path.join(tmp, "run", "checkpoints"))
        phase("9b codec parity", check_codec, tmp, card)
        gan_cpu_f32 = phase("10 TecoGAN step vs CPU", check_gan_step_vs_cpu, dev)  # TF32 off
        phase("10b bf16 TecoGAN step vs CPU", check_bf16_gan_step_vs_cpu, dev, gan_cpu_f32)
        # Phase 11 trains as a user does, with the default flags, on phase
        # 8's scenes and from its checkpoint; 11b in bfloat16 likewise.
        gan_launches, gan_f32 = phase("11 TecoGAN training", run_tecogan_training, dev, card,
                                      tmp)
        bf16_gan_launches = phase("11b bf16 TecoGAN training", run_bf16_tecogan_training, dev,
                                  card, tmp, gan_f32)
        # Phase 12: serving. (a) and (d)'s comparison switch TF32 off inside.
        phase("12a server vs CPU", check_serving_vs_cpu, dev)
        serve_launches, serve_models, _ = phase("12b serving", run_serving, dev, card)
        phase("12c export", check_export, dev, tmp, serve_models)
        phase("12d cli.serve", run_serve_cli, dev, card, tmp)
        phase("12e state budget", check_budget, dev, card, serve_models)
    log("[main] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase.seconds.items())
        + f"; in all {time.perf_counter() - START:.1f} s since the script started")

    # Every timed case of phase 3 beside its wrapper's launches on each
    # path: a 46-frame streaming run (phase 6), an FRVSR training step
    # (phase 8, 45 steps with validation) and a TecoGAN train_step (phase 11).
    for r in records:
        k = r["kernel"]
        lib = "None" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[yardstick] {k} {r['dtype']} {r['label']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.5f} ({r['bound_by']}), "
            f"share of bound {r['bound_ms'] / r['ms']:.1%}; launches of {k}: "
            f"{stream_launches.get(k, 0)} per {FRAMES}-frame streaming run, "
            f"{train_step_launches.get(k, 0)} per FRVSR train_step, "
            f"{gan_launches.get(k, 0)} per TecoGAN train_step, "
            f"{bf16_step_launches.get(k, 0)} / {bf16_gan_launches.get(k, 0)} per bfloat16 "
            f"FRVSR / TecoGAN train_step, "
            f"{serve_launches.get(k, 0):g} per serving bucket tick; paths "
            f"{', '.join(r['paths']) or 'none at this shape and dtype'}; card: {card}")

    # One entry per kernel, from its timed cases on the path it serves
    # (bfloat16 serves streaming, float32 training; the chain's two kernels
    # share the wrapper's count, and each path runs one of them): ms,
    # plain_ms, library_ms and bound_ms summed over those cases; launches:
    # that path's count; "cases": every timed case of the kernel and dtype;
    # "tecogan": the same sums over its float32 cases on TecoGAN training's
    # path, with the launches of one train_step there (phase 11);
    # "bf16_training": the sums over its bfloat16 cases on either training
    # path, with the launches of one bfloat16 FRVSR and TecoGAN train_step
    # (phases 8c and 11b).
    launches = {"streaming": stream_launches, "training": train_launches}
    kernels = []
    for name, key, source, replaces, dtype, path in (
            ("upsample4", "upsample4", "tecogan_tpu_torch/csrc/upsample4.cu",
             "tecogan_tpu/kernels/upsample4.py:68", "bfloat16", "streaming"),
            ("upsample4_bwd", "upsample4_bwd", "tecogan_tpu_torch/csrc/upsample4.cu",
             "tecogan_tpu/kernels/upsample4.py:129", "float32", "training"),
            ("resblock_chain", "resblock_chain",
             "tecogan_tpu_torch/csrc/resblock_chain_mma.cu",
             "tecogan_tpu/kernels/resblocks.py:87", "bfloat16", "streaming"),
            ("resblock_chain_f32", "resblock_chain",
             "tecogan_tpu_torch/csrc/resblock_chain.cu",
             "tecogan_tpu/kernels/resblocks.py:87", "float32", "training")):
        cases = [r for r in records if (r["kernel"], r["dtype"]) == (key, dtype)]
        own = [r for r in cases if path in r["paths"]]
        libs = [r["library_ms"] for r in own]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[path].get(key, 0),
                 "max_abs_err": max(r["max_abs_err"] for r in own),
                 "ms": sum(r["ms"] for r in own),
                 "plain_ms": sum(r["plain_ms"] for r in own),
                 "bound_ms": sum(r["bound_ms"] for r in own),
                 "bound_by": own[0]["bound_by"],
                 "library_ms": None if None in libs else sum(libs),
                 "path": path, "dtype": dtype,
                 "cases": [{k: v for k, v in r.items() if k not in ("kernel", "dtype")}
                           for r in cases]}
        if entry["library_ms"] is None:
            entry["library_note"] = CHAIN_NO_LIBRARY
        gan = [r for r in records if (r["kernel"], r["dtype"]) == (key, "float32")
               and "tecogan" in r["paths"]]
        if gan and (dtype == "float32" or key == "upsample4"):
            gan_libs = [r["library_ms"] for r in gan]
            entry["tecogan"] = {
                "launches": gan_launches.get(key, 0),
                "max_abs_err": max(r["max_abs_err"] for r in gan),
                **{k: sum(r[k] for r in gan) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None if None in gan_libs else sum(gan_libs),
                "cases": [r["label"] for r in gan]}
        if path == "streaming":  # the inference CLI runs the streaming path
            entry["cli_launches"] = cli_launches.get(key, 0)
            # Serving (phase 12 (b)): launches per bucket tick, and the sums
            # over the kernel's cases at a 4-slot tick's shapes.
            served = [r for r in cases if "serving" in r["paths"]]
            entry["serving_launches"] = serve_launches.get(key, 0)
            entry["serving"] = {
                "max_abs_err": max(r["max_abs_err"] for r in served),
                **{k: sum(r[k] for r in served) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": (None if any(r["library_ms"] is None for r in served)
                               else sum(r["library_ms"] for r in served)),
                "cases": [r["label"] for r in served]}
        bf16_cases = [r for r in records if (r["kernel"], r["dtype"]) == (key, "bfloat16")
                      and {"training", "tecogan"} & set(r["paths"])]
        if name != "resblock_chain_f32":
            bf16_libs = [r["library_ms"] for r in bf16_cases]
            entry["bf16_training"] = {
                "launches_frvsr_step": bf16_step_launches.get(key, 0),
                "launches_tecogan_step": bf16_gan_launches.get(key, 0),
                "max_abs_err": max(r["max_abs_err"] for r in bf16_cases),
                **{k: sum(r[k] for r in bf16_cases) for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None if None in bf16_libs else sum(bf16_libs),
                "cases": [r["label"] for r in bf16_cases]}
        if key == "resblock_chain":
            entry["also_replaces"] = ["tecogan_tpu/kernels/resblocks.py:305",
                                      "tecogan_tpu/kernels/resblocks.py:466"]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
