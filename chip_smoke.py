#!/usr/bin/env python3
"""Correctness check of the PyTorch port (``tecogan_tpu_torch``) on one
NVIDIA GPU, with each kernel timed alone beside its plain version.

    python3 chip_smoke.py

The port's speed end to end is measured by the benchmark's cells
(``BENCHMARK.json``, ``portbench/``); this script checks what the cells do
not: bit-equality, launch counts, resumes, codecs, NVDEC, orbax and the
parallel paths. Phase 3's table of kernels is its one measurement, with
the benchmark's own bounds (``portbench/harness/flops.py``) and kernel
groups (``portbench/harness/trace.py``). Phases, each raising on failure
(so the exit code is non-zero):

1. versions, the card's name and power limit; no CUDA -> exit non-zero;
2. build the CUDA kernels from ``tecogan_tpu_torch/csrc`` with nvcc
   (``-Xptxas -v``), with the bfloat16 chain kernel's resident blocks per
   SM and the float32 chain kernel's cluster size and resident clusters;
3. each kernel against its plain PyTorch version on the card (K1, K2 the
   upsample's adjoint, the chain), at the streaming, serving and training
   paths' shapes and ragged ones, float32 (TF32 off) and bfloat16, with the
   error beside its tolerance and CUDA-event times of the device's work
   (median and range of 5 alternating windows, each queued behind a
   device-side spin so the host's dispatch is not timed) of the kernel,
   its plain version and, where one PyTorch call computes the same
   function (``torch.einsum`` for K1 and K2; none for the chain), that
   call, with the bound (bytes over HBM's rate or operations over the
   units' peak, its arithmetic printed; the chain's as the benchmark's
   ``chain_launch_bound``) and the kernel's share of it; the bfloat16
   chain also, one block at each path's shape, against its own rounding
   points in float32 (8e-3);
3c. the transposed convs' epilogue (bias, ReLU and SAME crop in one pass)
   in bfloat16 at the 2160p, 5-slot 1080p serving and Vid4 convs' output
   shapes: bit-equal to its plain version and to the two ATen passes it
   replaces (``add_``, ``F.relu``), timed beside both, with its byte bound;
3d. the recurrent step's input in one pass (``warp_pack``: the warp of the
   previous HR frame, its 4x space-to-depth and the concat with the LR
   frame) in bfloat16 at the 2160p, 5-slot 1080p serving and Vid4 frames:
   bit-equal to the ATen route it replaces, timed beside it, with its byte
   bound;
3b. the native data-loader core: the machine's toolchain and the build of
   ``tecogan_tpu_torch/csrc/tecodata.cpp`` with g++;
4. autograd: the upsample (both filters) and the chain on the card against
   the same functions on the CPU, gradients of every input, float32; K1
   and K2 also in bfloat16 at bfloat16 training's shapes;
5. the whole streaming path at full width (16 resblocks, 64 channels) on
   the GPU against the same seeded weights on the CPU, float32, 6 frames
   of 64x96;
6. the streaming path at size: 46 uint8 frames of 144x180 -> 41 of
   576x720, bfloat16, chunks of 23, captured and with ``capture=False``:
   the two outputs bit-equal under cuDNN's deterministic algorithms;
   exactly 736 chain, 48 K1, 92 epilogue and 46 ``warp_pack`` launches a
   run in each mode,
   one capture; a ``torch.profiler`` run of each mode whose chain and K1
   launches equal the counters';
7. one FRVSR training step at full width, batch 2, 4 frames, crop 32,
   float32, the card's captured step against the CPU: losses and the
   gradient of every parameter;
7b. the same step in bfloat16 (float32 master weights), card against CPU,
   each held against the CPU's own bfloat16 error; only the kernels'
   bfloat16 entries ran, twice a step's launches;
8. FRVSR_PRESET through ``train.loop.train`` on synthetic PNG scenes,
   captured: 40 steps, then a resume to 45; then 15 steps with
   ``capture=False``; exactly 100 chain, 11 K1 and 1 K2 launches a step
   (twice that at a program's first step), no recapture; every save's
   GIFs and event CRCs and every ``generate`` call's launches; 3 captured
   against 3 eager steps bit-equal in every state tensor under
   ``torch.use_deterministic_algorithms``; a captured generate bit-equal
   to an eager one; a profiled step of each mode whose chain (the float32
   cluster kernel), K1 and K2 launches equal the counters'. With PyTorch's
   default precision flags, as the training CLI runs;
8c. FRVSR_PRESET in bfloat16 through ``train()``, captured, 25 steps: the
   same launches, only the bfloat16 library entries, the state float32,
   captured == eager, the generate check and the profiles' launches (the
   chain as ``resblock_kernel_wgmma``);
9. the inference CLI and the metrics suite at the main path's width: 41
   synthetic 576x720 HR PNGs -> ``cli.main --mode inference
   --input_dir_HR`` (bfloat16, 16 resblocks, chunks of 23) byte-equal to
   ``StreamingSR.run`` on the same LR frames, with the run's and its
   capture's warm-up chunk's launches and one capture; ``--spatial_shards
   2`` and ``--pipeline`` on one card byte-equal to their references; a
   run with the python PNG codec (the native library's counters 0, and 41
   and 41 in the native runs); the blur on the card against the CPU; a
   ``--checkpoint`` run on phase 8's checkpoint (the depth NOTE);
   ``cli.metrics`` on the outputs; ``evaluate_folders`` with a seeded
   random LPIPS on the card against the CPU;
9b. the native PNG codec against ``data/png.py``: decode bit-equal on the
   41 PNGs and 8 Paeth-filtered ones, encode then ``read_png`` gives the
   input back;
10. one TecoGAN step at TECOGAN_PRESET's widths, batch 1, crop 32, 3
   frames with ping-pong, float32 with TF32 off, the card's captured step
   against the CPU, with the discriminator's gate forced open and closed:
   every loss and gradient, D's running statistics and its parameters;
10b. the same step in bfloat16, gate open, as phase 7b;
11. TECOGAN_PRESET through ``train()`` with random VGG19 weights on phase
   8's scenes, warm-started from phase 8's checkpoint, captured: 20 steps
   and a resume to 25, then 10 eager, as phase 8 (exactly 304 chain, 21 K1
   and 1 K2 launches a step; the gate's counters; captured == eager, D's
   statistics, Adam state and gate included; the profiles' launches);
11b. TECOGAN_PRESET in bfloat16 through ``train()``, captured, 10 steps,
   as phase 8c, with the gate's counters;
12. serving: (a) a 3-slot ``VSRServer`` GPU against CPU, float32, with
   staggered attaches and an idle slot (its state bit-unchanged on the
   card); (b) ``MultiGeometryServer`` in bfloat16, a 4-slot 144x180 bucket
   and two 120x180 streams, 46 captured ticks with exactly 16 chain and 2
   K1 launches a bucket tick, and an eviction that leaves no segment of
   the evicted bucket's graph pool; ``VSRServer`` pools of 1, 4 and 8
   slots, captured and eager, each profiled (the chain, as
   ``resblock_kernel_wgmma``, and K1 launched as often as the counters
   say); (c) a 4-slot server's captured ticks bit-equal to ``capture=
   False`` ones, and the frame step exported, loaded in a fresh process
   that imports only torch and ``tecogan_tpu_torch.kernels``, bit-equal to
   the captured tick with its launches counted; (d) ``cli.serve`` on three
   LR PNG dirs in float32 within 1 u8 level of ``cli.main`` per dir (the
   random generator's recurrence damped, see ``run_serve_cli``), then in
   bfloat16 with the native and the python PNG codec (two captures, the
   native library's counters); (e) the state budget counting a captured
   bucket's graph pool: a geometry refused while the bucket is busy, which
   evicts it once idle;
13. the run cases: ``data.prepare --synthetic`` and ``cli.run`` cases 4,
   3, 1, 2 and 0 as subprocesses on the card;
14. video-file I/O without OpenCV (``run_video``): the port's video
   library's build; a seeded 30-frame 144x180 clip written as .avi, .mp4
   and .mkv and read back within the bound ``tests/test_torch_video_io.py``
   holds, at the written fps; ``cli.main --input_video`` bit-equal to the
   PNG route with equal launches; ``--output_video`` bit-equal to the
   writer on the PNG route's frames; ``cli.serve --output_videos`` on two
   geometries; ``extract_scene`` from inside the MPEG-4 GOP;
15. H.264 and VP9 input on the card's NVDEC (``run_nvdec``), over the test
   streams of ``tests/nvdec_streams.py``: the binding's build and
   ``cuvidGetDecoderCaps``; the parser's format of every stream. Where
   NVDEC refuses with CUDA_ERROR_OUT_OF_MEMORY in a container that
   withholds NVIDIA's ``video`` capability (``NvdecUnavailable``), every
   reader must raise it and the rest runs over ``ModelNvdec`` (which
   decodes nothing): NVDEC's decode is then NOT verified, as the log and
   the kernels line (``nvdec_decode_verified``) say. The H.264 streams
   bit-equal to their expected frames (with NVDEC also the VP9 fixture's
   SHA-256); the NV12 kernel bit-equal to its plain version and timed
   beside its bound; ``cli.main --input_video`` bit-equal to the PNG route
   with one NV12 launch a frame; ``cli.serve --output_videos``;
   ``extract_scene`` from inside a GOP with B-frames;
16. the JAX package's orbax checkpoints without JAX (``run_orbax``): the
   committed JAX-written fixture ``tests/data/jax_orbax_small`` read by the
   port, every leaf equal to its SHA-256; a TECOGAN_PRESET TrainState
   through ``save_jax_checkpoint`` and ``restore_checkpoint``, bit-equal;
   ``cli.main --checkpoint`` on that directory and on the port's
   ``state.pt`` of the same weights: byte-equal PNGs, launches counted;
17. parallelism on one card (the mesh names it twice): (a) ``StreamingSR``
   on 2 row shards, captured and eager, bit-equal to each other and within
   a level of the unsharded frame step, launches and halo warps counted;
   (b) ``PipelinedStreamingSR`` bit-equal to ``StreamingSR``; (c)
   ``DataParallelTrainer`` at world size 1 (NCCL) bit-equal to
   ``Trainer``, and at world size 2 (gloo, two processes: ``chip_smoke.py
   --dp-worker PORT RANK OUT``) against one process; (d) a ``VSRServer``
   over a 2-device mesh bit-equal to two 2-slot pools.

Then each phase's seconds (the run's own clock), one ``[yardstick]`` line
per timed case of phase 3 with its wrapper's launches on each path, a JSON
line with one entry per kernel (K1, K2, both chains, the NV12 kernel, the
epilogue and ``warp_pack``) and last ``{"ok": true, "device": {...}}``.
Imports no JAX.

``python3 chip_smoke.py --kernels-only`` stops after phase 3d and prints no
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

from portbench.harness.flops import HBM_BYTES_PER_S, chain_launch_bound, peak_flops  # noqa: E402
from portbench.harness.trace import group_of, union_s  # noqa: E402

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
# geometry (Vid4's foliage and walk) and the pool sizes profiled; ticks per
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
# the units that do them. The HBM rate, the tensor cores' peaks and the
# chain's work are the benchmark's (portbench/harness/flops.py); K1, K2 and
# the epilogue run on the float32 CUDA cores, whose peak the benchmark does
# not use (NVIDIA's H100 SXM data sheet, dense).
CUDA_CORE_FLOPS = 67e12


def bound(launches: int, bytes_: float, flops: float, peak: float, unit: str):
    """(bound ms, "bytes" or "operations", its arithmetic) of `launches`
    launches that each move `bytes_` and do `flops` on `unit`, whose peak
    is `peak` FLOP/s; each launch is bound by the larger of its two times."""
    mem_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak * 1e3
    by = "bytes" if mem_ms >= op_ms else "operations"
    per = f"{launches} launches x " if launches > 1 else ""
    text = (f"{per}max({bytes_ / 1e6:.2f} MB / {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
            f"{mem_ms:.5f} ms, {flops / 1e9:.4f} GFLOP / {peak / 1e12:.0f} TFLOP/s "
            f"{unit} = {op_ms:.5f} ms)")
    return launches * max(mem_ms, op_ms), by, text


def upsample_bound(lr_elems: int, itemsize: int, nt: int):
    """K1 on x (B, H, W, C) of `lr_elems` elements, or K2 onto dx of that
    size, NT taps a pass: x and the 16x larger output (or g) once each; NT
    multiply-adds for each element of the H pass (4H x W) and of the W
    pass (4H x 4W): 40 NT flops per x element, in float32 on the CUDA
    cores."""
    return bound(1, 17 * lr_elems * itemsize, 40 * nt * lr_elems, CUDA_CORE_FLOPS,
                 "float32 CUDA cores")


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
# The bfloat16 chain's time at phase 3's shapes with the kernel that the
# warpgroup-MMA one replaced (mma.sync.m16n8k16 fed by ldmatrix, 8x16-pixel
# tiles, 2 CTAs an SM), on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6).
MMA_SYNC_CHAIN_MS = {
    "chain N=16 (1,144,180,64)": 0.4031, "chain N=16 (4,144,180,64)": 1.3057,
    "chain N=10 (4,32,32,64)": 0.1623, "chain N=16 (4,32,32,64)": 0.2598,
    "chain N=16 (1,540,960,64)": 5.3842, "chain N=16 (5,270,480,64)": 6.7260,
    "chain N=4 (1,80,180,64)": 0.0703}
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
        if bf16:
            # A serving tick of the 4-slot pool (phase 12); the benchmark's
            # 2160p stream (a 540x960 LR frame) and 5-slot 1080p tick
            # (270x480 LR); the first of 2 row shards of a Vid4 frame with
            # its 8-row halo, 4 blocks a call (parallel/spatial.py, phase 17).
            chains += [(SERVE_SLOTS, LR_H, LR_W, NUM_RESBLOCK, True, "serving"),
                       (1, 540, 960, NUM_RESBLOCK, True, "stream_2160p"),
                       (5, 270, 480, NUM_RESBLOCK, True, "serve_1080p_live"),
                       (1, LR_H // 2 + 8, LR_W, 4, True, "sharded streaming")]
        chains += [(4, 32, 32, 10, True, "training"), (4, 32, 32, 16, True, "tecogan")]
        # Each launch bound as the benchmark bounds one (chain_launch_bound):
        # the model's work on the tensor cores of the dtype, TF32 for float32
        # (whose kernel takes each product as three TF32 products: work the
        # bound does not count).
        unit = "bf16 tensor cores" if bf16 else "TF32 tensor cores"
        for b, h, w, n, timed, path in chains:
            x = torch.relu(seeded((b, h, w, CHANNELS), 1.0, gen, dev, dtype))
            _, work = chain_launch_bound((b, h, w), x.element_size(), name)
            args = (x, seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype),
                    seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype))
            cases.append(("resblock_chain", f"chain N={n} ({b},{h},{w},64)",
                          lambda a=args: resblock_chain(*a),
                          lambda a=args: resblock_chain_plain(*a),
                          (path, CHAIN_NO_LIBRARY, bound(n, work["bytes"], work["flops"],
                                                         peak_flops(name), unit))
                          if timed else None))
        if bf16:
            # One block against its rounding points (chain_oracle_bf16) at
            # every path's shape: a dropped tap, a misplaced accumulator row
            # or a wrong edge of the tile walk shows here.
            for b, h, w in ((1, LR_H, LR_W), (2, 37, 53), (1, 5, 7), (1, 540, 960),
                            (5, 270, 480), (SERVE_SLOTS, LR_H, LR_W), (4, 32, 32),
                            (1, LR_H // 2 + 8, LR_W)):
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
                replaced = MMA_SYNC_CHAIN_MS.get(label) if (kernel, bf16) == (
                    "resblock_chain", True) else None
                if replaced is not None:
                    line += (f"; the mma.sync kernel it replaced: {replaced:.4f} ms "
                             f"({replaced / ms:.2f}x)")
                paths = [path] if isinstance(path, str) else list(path or ())
                line += f"; paths {', '.join(paths) or 'none at this shape and dtype'}"
                records.append(dict(kernel=kernel, dtype=name, label=label, paths=paths,
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound_ms,
                                    bound_by=bound_by))
            log(line)
    return records


# Phase 3c: the transposed convs' raw outputs (B, C, 2H + 1, 2W + 1) that the
# epilogue crops, with the paths they serve: the 4x and 2x convs of a 2160p
# frame (540x960 LR), of a 5-slot 1080p serving tick (270x480 LR) and of a
# Vid4 frame (144x180 LR, phase 6's geometry).
EPILOGUE_CASES = (
    ("2160p 4x", (1, 64, 2161, 3841), "stream_2160p"),
    ("2160p 2x", (1, 64, 1081, 1921), "stream_2160p"),
    ("serve 5 slots 4x", (5, 64, 1081, 1921), "serve_1080p_live"),
    ("serve 5 slots 2x", (5, 64, 541, 961), "serve_1080p_live"),
    ("Vid4 4x", (1, 64, 577, 721), "streaming"),
    ("Vid4 2x", (1, 64, 289, 361), "streaming"))


def check_epilogue(dev):
    """Phase 3c. The transposed convs' epilogue in bfloat16 (the inference
    path's dtype) at :data:`EPILOGUE_CASES`' shapes, bit-equal to its plain
    version and to the two ATen passes it replaces (``add_`` of the bias
    over the whole conv output, then ``F.relu`` of the SAME crop), timed
    beside both (the two passes' input drifts as ``add_`` repeats: timing
    only). Its bound: the conv output read once and the crop written once.
    Returns one record per case."""
    from tecogan_tpu_torch.kernels import bias_relu_crop, bias_relu_crop_plain

    gen = torch.Generator(device=dev).manual_seed(39)
    records = []
    for label, shape, path in EPILOGUE_CASES:
        c = shape[1]
        y = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bias = (0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        biased, column = y.clone(), bias.view(1, -1, 1, 1)
        got = bias_relu_crop(y, bias)
        same = (torch.equal(got, bias_relu_crop_plain(y, bias))
                and torch.equal(got, F.relu(y.clone().add_(column)[..., :-1, :-1])))
        if not same:
            raise RuntimeError(f"[epilogue] {label} {shape}: the kernel differs from the "
                               "two ATen passes")
        times = time_fns([lambda: bias_relu_crop(y, bias),
                          lambda: bias_relu_crop_plain(y, bias),
                          lambda: F.relu(biased.add_(column)[..., :-1, :-1])])
        (ms, lo, hi), (plain_ms, plo, phi), (two_ms, tlo, thi) = times
        bound_ms, bound_by, arithmetic = bound(
            1, (y.numel() + got.numel() + c) * y.element_size(), 2 * got.numel(),
            CUDA_CORE_FLOPS, "float32 CUDA cores")
        log(f"[kernel] bias_relu_crop bfloat16 {label} {shape}: bit-equal to plain and to the "
            f"two ATen passes; kernel_ms={ms:.4f} [{lo:.4f}-{hi:.4f}] plain_ms={plain_ms:.4f} "
            f"[{plo:.4f}-{phi:.4f}] two_pass_ms={two_ms:.4f} [{tlo:.4f}-{thi:.4f}] (add_ + "
            f"F.relu, median [min-max]) bound_ms={bound_ms:.5f} by {bound_by}: {arithmetic}; "
            f"share of bound {bound_ms / ms:.1%}; path {path}")
        records.append(dict(label=f"{label} {shape}", paths=[path], max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, two_pass_ms=two_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
        del y, biased, got
        torch.cuda.empty_cache()
    return records


# Phase 3d: the HR frames whose warp, pack and concat ``warp_pack`` makes in
# one pass: a 2160p frame, a 5-slot 1080p serving tick and a Vid4 frame.
WARP_PACK_CASES = (
    ("2160p", (1, 2160, 3840), "stream_2160p"),
    ("serve 5 slots", (5, 1080, 1920), "serve_1080p_live"),
    ("Vid4", (1, 576, 720), "streaming"))


def warp_pack_bytes(shape, itemsize: int) -> int:
    """What ``warp_pack`` must move for (B, H, W) HR frames: the flow (2
    values a pixel), the previous frame (3) and the LR frame (3 a 16th)
    read once, the (B, H/4, W/4, 51) input written once."""
    b, h, w = shape
    return (b * h * w * 5 + b * (h // 4) * (w // 4) * (3 + 51)) * itemsize


def check_warp_pack(dev):
    """Phase 3d. ``warp_pack`` in bfloat16 (the inference path's dtype) at
    :data:`WARP_PACK_CASES`' shapes, under a smooth pan and sway of up to
    5.5 HR pixels as the cells' clips have: bit-equal to the ATen route it
    replaces (``cat([lr, warp_space_to_depth(...)])``, its plain version),
    timed beside it. Its bound: :func:`warp_pack_bytes`. Returns one record
    per case."""
    from tecogan_tpu_torch.kernels import warp_pack, warp_pack_plain

    gen = torch.Generator(device=dev).manual_seed(40)
    records = []
    for label, shape, path in WARP_PACK_CASES:
        b, h, w = shape
        lr = torch.rand((b, h // 4, w // 4, 3), generator=gen, device=dev).to(torch.bfloat16)
        image = torch.rand((b, h, w, 3), generator=gen, device=dev).to(torch.bfloat16)
        ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) / h
        xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) / w
        phase_ = torch.arange(b, device=dev, dtype=torch.float32).view(b, 1, 1)
        flow = torch.stack([(1.5 + 2.0 * torch.sin(6.3 * xs + phase_)).expand(b, h, w),
                            (-2.5 + 3.0 * torch.cos(6.3 * ys + phase_)).expand(b, h, w)],
                           dim=-1).to(torch.bfloat16)
        got = warp_pack(lr, image, flow)
        if not torch.equal(got, warp_pack_plain(lr, image, flow)):
            raise RuntimeError(f"[warp_pack] {label} {shape}: the kernel differs from the "
                               "ATen route")
        (ms, lo, hi), (plain_ms, plo, phi) = time_fns(
            [lambda: warp_pack(lr, image, flow), lambda: warp_pack_plain(lr, image, flow)])
        bound_ms, bound_by, arithmetic = bound(
            1, warp_pack_bytes(shape, 2), 27 * b * h * w, CUDA_CORE_FLOPS,
            "float32 CUDA cores")
        log(f"[kernel] warp_pack bfloat16 {label} {shape}: bit-equal to the ATen route; "
            f"kernel_ms={ms:.4f} [{lo:.4f}-{hi:.4f}] plain_ms={plain_ms:.4f} "
            f"[{plo:.4f}-{phi:.4f}] (median [min-max]) bound_ms={bound_ms:.5f} by {bound_by}: "
            f"{arithmetic}; share of bound {bound_ms / ms:.1%}; plain / kernel "
            f"{plain_ms / ms:.1f}x; path {path}")
        records.append(dict(label=f"{label} {shape}", paths=[path], max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
        del lr, image, flow, got
        torch.cuda.empty_cache()
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
        log(f"[step] {device} ({'captured' if trainer.capture else 'eager'}): one step, "
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
def counted_train_steps(kernels):
    """Count each kernel wrapper's launches inside each
    ``Trainer.train_step`` (loader waits, saves, summaries and validation
    fall outside). Yields the two lists it fills: {kernel: launches} per
    step, and the trainers that stepped."""
    from tecogan_tpu_torch.train import Trainer

    step_launches, trainers = [], []
    train_step = Trainer.train_step

    def counted_step(self, state, hr_seq):
        if self not in trainers:
            trainers.append(self)
        before = {name: k.launches for name, k in kernels.items()}
        result = train_step(self, state, hr_seq)
        step_launches.append({name: k.launches - before[name] for name, k in kernels.items()})
        return result

    Trainer.train_step = counted_step
    try:
        yield step_launches, trainers
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


# Each training phase's summaries: generate's launches a replay, replay ms
# and graph pool MiB, by preset and dtype (phases 8, 8c, 11, 11b), for the
# kernels line.
GENERATE = {}


def generate_launch_want(cfg):
    """The kernel launches of one ``Trainer.generate``: the chain once a
    block and frame of the batch's own ``rnn_n`` frames (no ping-pong), K1
    for the flow (every pair in one launch) and each frame's bicubic skip,
    no K2 (no backward)."""
    return {"resblock_chain": cfg.num_resblock * cfg.rnn_n, "upsample4": cfg.rnn_n + 1,
            "upsample4_bwd": 0}


@contextlib.contextmanager
def watched_summaries(kernels):
    """While open, each ``Trainer.generate`` call's kernel launches are
    counted (apart from the steps': the loop calls it after a save, outside
    ``train_step``), and each ``SummaryLogger.gif`` (one GIF and its
    TensorBoard image) is recorded. Yields the two lists it fills:
    dict(trainer, launches) per generate call and (log dir, step, tag) per
    GIF."""
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.utils.summaries import SummaryLogger

    calls, writes = [], []
    generate, gif = Trainer.generate, SummaryLogger.gif

    def counted(self, state, hr_seq):
        before = {name: k.launches for name, k in kernels.items()}
        out = generate(self, state, hr_seq)
        calls.append(dict(trainer=self, launches={name: k.launches - before[name]
                                                  for name, k in kernels.items()}))
        return out

    def recorded(self, step, tag, sequence, **kw):
        gif(self, step, tag, sequence, **kw)
        writes.append((self.log_dir, step, tag))

    Trainer.generate, SummaryLogger.gif = counted, recorded
    try:
        yield calls, writes
    finally:
        Trainer.generate, SummaryLogger.gif = generate, gif


def check_summaries(label: str, cfg, saves: dict, calls, writes) -> dict:
    """Every save of ``saves`` ({log dir: [steps]}) wrote the four tags'
    GIFs and their TensorBoard images into an event file whose every
    record's CRC checks; every ``generate`` call launched exactly
    :func:`generate_launch_want`, twice that at a captured trainer's first
    call (its warm-up and one replay). Returns the launches of one replay."""
    from tecogan_tpu_torch.train.loop import SUMMARY_TAGS
    from tecogan_tpu_torch.utils.tb_events import read_records

    want = generate_launch_want(cfg)
    seen = set()
    for i, c in enumerate(calls):
        first = c["trainer"] not in seen
        seen.add(c["trainer"])
        need = {k: n * (2 if first and c["trainer"].capture else 1) for k, n in want.items()}
        if c["launches"] != need:
            raise RuntimeError(f"{label} generate call {i + 1}: launches {c['launches']}, "
                               f"want {need}")
    if len(calls) != sum(len(v) for v in saves.values()):
        raise RuntimeError(f"{label}: {len(calls)} generate calls for saves {saves}")
    per_save = {}
    for log_dir, step, tag in writes:
        per_save.setdefault((log_dir, step), []).append(tag)
    for log_dir, steps in saves.items():
        events = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents.")]
        records = [r for f in events for r in read_records(os.path.join(log_dir, f))]
        for step in steps:
            tags = per_save.get((log_dir, step), [])
            if sorted(tags) != sorted(SUMMARY_TAGS):
                raise RuntimeError(f"{label}: save {step} in {log_dir} wrote {tags}")
            for tag in SUMMARY_TAGS:
                path = os.path.join(log_dir, f"{tag}_0_step{step}.gif")
                if not os.path.isfile(path) or open(path, "rb").read(6) != b"GIF89a":
                    raise RuntimeError(f"{label}: no GIF {path}")
                if not any(f"{tag}/0".encode() in r for r in records):
                    raise RuntimeError(f"{label}: no {tag}/0 image in {events}")
    replays = [c["launches"] for c in calls if c["launches"] == want]
    log(f"{label} summaries: {len(calls)} generate calls (launches {want} a replay, twice "
        f"that at a captured trainer's first call), {len(per_save)} saves x 4 GIFs + "
        f"TensorBoard images, every event record's CRC checked")
    return dict(launches=replays[0] if replays else want)


def check_generate(dev, cfg, state, label: str, card: str, vgg=None) -> dict:
    """``Trainer.generate`` on one batch, captured (the default) against
    ``capture=False`` under ``torch.use_deterministic_algorithms`` and
    cuDNN's deterministic algorithms: the four sequences bit-equal, from the
    capturing call and from a replay; the replay's device time
    (``utils.profiling.device_time``, CUDA events) and the generate
    program's graph pool. Returns dict(ms, pool)."""
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.utils.profiling import device_time

    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    batch = torch.from_numpy(frvsr_batch(cfg, cfg.batch_size, 61)).to(dev)
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        captured = Trainer(cfg, dev, vgg=vgg)
        eager = Trainer(cfg, dev, vgg=vgg, capture=False)
        first = [t.clone() for t in captured.generate(state, batch)]
        before = {name: k.launches for name, k in kernels.items()}
        replay = captured.generate(state, batch)
        torch.cuda.synchronize()
        launches = {name: k.launches - before[name] for name, k in kernels.items()}
        want = eager.generate(state, batch)
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
    if launches != generate_launch_want(cfg):
        raise RuntimeError(f"{label} generate replay: launches {launches}, want "
                           f"{generate_launch_want(cfg)}")
    for name, a, b, w in zip(("InputLR", "TargetHR", "GeneratedHR", "WarpPreGen"),
                             first, replay, want):
        if not (torch.equal(a, w) and torch.equal(b, w)):
            raise RuntimeError(f"{label} generate {name}: captured vs eager differ by "
                               f"{(b.double() - w.double()).abs().max().item():.3e}")
    ms = device_time(captured.generate, state, batch, iters=10, warmup=2) * 1e3
    prog = captured._program("generate", state, batch)
    pool = prog.graph.pool_bytes() / 2**20
    log(f"{label} generate ({cfg.num_resblock} blocks, batch {cfg.batch_size} x {cfg.rnn_n} "
        f"frames, {cfg.compute_dtype}): captured == capture=False bit-equal (capture and "
        f"replay, all four sequences) under torch.use_deterministic_algorithms; launches a "
        f"replay {launches}; replay {ms:.3f} ms (CUDA events, utils.profiling.device_time, "
        f"with the batch's device copy and the four clones); graph pool {pool:.1f} MiB; "
        f"card: {card}")
    return dict(ms=ms, pool=pool)


def train_modes(cfg, kernels, runs, capturing, label):
    """``runs``: {mode: [calls of train()]}, captured (the default) then
    eager (``capture=False``), each step's launches counted: exactly
    ``step_launch_want`` a step, twice that at the ``capturing`` steps of
    the captured mode. Returns {mode: dict(launches a step, totals, the
    last call's state)}."""
    want = step_launch_want(cfg)
    out = {}
    for mode, calls in runs.items():
        m = dict(recaptures=0, modes=set())
        with counted_train_steps(kernels) as (step_launches, trainers):
            for k in kernels.values():
                k.launches = 0
            for call in calls:
                m["state"] = call()
                m["recaptures"] += sum(t.recaptures for t in trainers)
                m["modes"] |= {t.capture for t in trainers}
                del trainers[:]  # its graphs and pools go with it
            m["totals"] = {name: k.launches for name, k in kernels.items()}
        m["launches"] = step_launches
        if m["modes"] != {mode == "captured"} or m["recaptures"]:
            raise RuntimeError(f"{label} {mode}: capture {m['modes']}, "
                               f"{m['recaptures']} recaptures")
        check_step_launches(step_launches, capturing if mode == "captured" else (), want,
                            f"{label} {mode}")
        out[mode] = m
    return out


def run_training(dev, card: str, tmp: str):
    """Phase 8: FRVSR_PRESET through ``train()`` on synthetic scenes under
    ``tmp``, captured: 40 steps and a resume to 45 (checkpoints in
    ``<tmp>/run/checkpoints``); then 15 steps with ``capture=False``; then
    the captured and eager programs stepped 3 times from one state and
    compared, and the profile's launches. Returns the launch counts of the
    45 captured steps and of one steady step."""
    import io

    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.loop import train

    kernels = {"upsample4": upsample4, "upsample4_bwd": upsample4_bwd,
               "resblock_chain": resblock_chain}
    data, out_dir = os.path.join(tmp, "scenes"), os.path.join(tmp, "run")
    write_synthetic_scenes(data, 3, SCENE_FRAMES, SCENE_H, SCENE_W, start_index=2000)
    write_synthetic_scenes(data, 1, SCENE_FRAMES, SCENE_H, SCENE_W,
                           start_index=2251, seed=100)
    log(f"[train] 4 synthetic scenes of {SCENE_FRAMES} {SCENE_H}x{SCENE_W} PNG frames written")
    cfg = FRVSR_PRESET.replace(input_video_dir=data, max_frm=SCENE_FRAMES - 1,
                               save_freq=SAVE_FREQ, summary_freq=10)
    printed = io.StringIO()
    runs = {"captured": [lambda: train(cfg, out_dir, dev, max_steps=TRAIN_STEPS),
                         lambda: train(cfg, out_dir, dev, max_steps=RESUME_STEPS)],
            "eager": [lambda: train(cfg, os.path.join(tmp, "run_eager"), dev,
                                    max_steps=EAGER_STEPS, capture=False)]}
    with contextlib.redirect_stdout(printed), watched_summaries(kernels) as (calls, writes):
        modes = train_modes(cfg, kernels, runs, (0, TRAIN_STEPS), "[train]")
    summaries = check_summaries(
        "[train]", cfg, {os.path.join(out_dir, "log"): [SAVE_FREQ, TRAIN_STEPS, RESUME_STEPS],
                         os.path.join(tmp, "run_eager", "log"): [EAGER_STEPS]}, calls, writes)
    state = modes["captured"]["state"]
    for line in printed.getvalue().splitlines():
        if line.startswith(("step ", "Resumed", "Saved", "Dataset")):
            log(f"[train] | {line}")
    if state.step != RESUME_STEPS or len(modes["captured"]["launches"]) != RESUME_STEPS or \
            modes["eager"]["state"].step != EAGER_STEPS:
        raise RuntimeError(f"[train] steps to {state.step}, "
                           f"{len(modes['captured']['launches'])} step calls; eager "
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
    log(f"[train] launches over {RESUME_STEPS} captured steps with validation and the "
        f"summaries' generate calls {launches}; "
        f"every step exactly {step_launch_want(cfg)} (the first of each train() call "
        f"twice that: its warm-up and one replay), eager too")
    log(f"[train] FRVSR_PRESET ({cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, crop {cfg.crop_size}, {cfg.rnn_n} frames, float32, "
        f"cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}): captured "
        f"{TRAIN_STEPS} steps, resumed to {RESUME_STEPS}; eager {EAGER_STEPS} steps; every "
        f"parameter moved; {len(rows)} scalar rows")
    check_captured_equals_eager(dev, cfg, "[train]")
    GENERATE["FRVSR_PRESET float32"] = dict(summaries, **check_generate(
        dev, cfg, state, "[train]", card))
    profile_step(dev, cfg, state, "FRVSR_PRESET")
    return launches, modes["captured"]["launches"][-1]


def device_kernels(prof):
    """A torch.profiler window's device seconds, the union of its kernels'
    intervals (``portbench/harness/trace.py:union_s``: overlapping kernels
    count once), and each kernel's launches by name in the benchmark's
    groups (``group_of``): (seconds, {group: {kernel: launches}})."""
    from torch.autograd import DeviceType

    spans, names = [], {}
    for evt in prof.events():
        # A user annotation on the device's timeline spans kernels; it is none.
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        group = names.setdefault(group_of(evt.name), {})
        group[evt.name] = group.get(evt.name, 0) + 1
    return union_s(spans), names


def profile_step(dev, cfg, state, name: str, vgg=None, modes=("captured", "eager")) -> None:
    """One step of each mode (or those in ``modes``) on one batch under
    torch.profiler, after two unprofiled steps: the profile must show the
    chain (as the kernel of the step's dtype: the float32 cluster kernel or
    the bfloat16 tensor-core one), K1 and K2 as often as the counters say."""
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train import Trainer

    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    want = step_launch_want(cfg)
    chain_name = ("resblock_kernel_wgmma" if cfg.compute_dtype == "bfloat16"
                  else "resblock_kernel_tf32x3")
    batch = frvsr_batch(cfg, cfg.batch_size, 21)
    for mode in modes:
        trainer = Trainer(cfg, dev, vgg=vgg, capture=None if mode == "captured" else False)
        for _ in range(2):
            trainer.train_step(state, batch)
        # The counters must count a step's launches every time. The
        # profile must show them too; a profile that misses one (CUPTI
        # has been seen to drop a kernel record of a replay: 10 of 11 K1
        # in phase 8's float32 replay on an H100) is taken again, at most
        # PROFILE_ATTEMPTS times.
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            before = {k: w.launches for k, w in kernels.items()}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.train_step(state, batch)
                torch.cuda.synchronize()
            counted = {k: w.launches - before[k] for k, w in kernels.items()}
            busy, names = device_kernels(prof)
            if busy <= 0:
                raise RuntimeError(f"[profile] {name} {mode}: torch.profiler recorded no "
                                   "device time")
            chain = names.get("chain", {})
            shown = {"resblock_chain": sum(n for key, n in chain.items() if chain_name in key),
                     "upsample4": sum(names.get("k1", {}).values()),
                     "upsample4_bwd": sum(names.get("k2", {}).values())}
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


def profiled_launches(names, chain_want: int, k1_want: int, label: str):
    """The profile's launches of the bfloat16 chain kernel and of K1, which
    must equal the counters' (``want``): the chain only as
    ``resblock_kernel_wgmma``. Returns (chain, K1)."""
    chain = names.get("chain", {})
    for key, count in chain.items():
        log(f"[profile]   chain kernel: {count} launches of {key[:100]}")
    wgmma = sum(n for key, n in chain.items() if "resblock_kernel_wgmma" in key)
    k1 = sum(names.get("k1", {}).values())
    log(f"[profile]   {label}: the profile shows {wgmma} launches of resblock_kernel_wgmma "
        f"and {k1} of K1; the counters {chain_want} and {k1_want}")
    if (wgmma, k1) != (chain_want, k1_want) or sum(chain.values()) != wgmma:
        raise RuntimeError(f"[profile] {label}: the chain ran {chain} and K1 {k1} times, "
                           f"want {chain_want} launches of resblock_kernel_wgmma and "
                           f"{k1_want} of K1")
    return wgmma, k1


def profile_streaming(sr, frames, launches) -> None:
    """One StreamingSR.run under torch.profiler: the profile's chain (the
    bfloat16 tensor-core kernel) and K1 launches must equal the counters'
    ``launches`` of a run."""
    from torch.profiler import ProfilerActivity, profile

    mode = "captured" if sr.capture else "eager (capture=False)"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sr.run(frames, warmup=WARMUP)
        torch.cuda.synchronize()
    busy, names = device_kernels(prof)
    if busy <= 0:
        raise RuntimeError(f"[profile] streaming {mode}: torch.profiler recorded no device time")
    profiled_launches(names, launches["resblock_chain"], launches["upsample4"],
                      f"streaming {mode}")


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
        out, _ = sr.run(frames)
        log(f"[path] {device}: {out.shape}")
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
    default flags, each mode's launches and captures in a run after its
    first, and a profile of one run of each. Returns the captured run's
    launch counts."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import bias_relu_crop, resblock_chain, upsample4
    from tecogan_tpu_torch.kernels import warp_pack
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
    # the captured mode), then a run whose launches are counted.
    need = {"upsample4": FRAMES + FRAMES // CHUNK, "resblock_chain": NUM_RESBLOCK * FRAMES,
            "bias_relu_crop": 2 * FRAMES, "warp_pack": FRAMES}
    runs = {}
    for mode, capture in modes.items():
        captures = CapturedProgram.captures
        sr = StreamingSR(cfg, *models, output="uint8", device=dev, capture=capture)
        sr.run(frames, warmup=WARMUP)
        upsample4.launches = resblock_chain.launches = bias_relu_crop.launches = 0
        warp_pack.launches = 0
        hr, _ = sr.run(frames, warmup=WARMUP)
        launches = {"upsample4": upsample4.launches, "resblock_chain": resblock_chain.launches,
                    "bias_relu_crop": bias_relu_crop.launches, "warp_pack": warp_pack.launches}
        runs[mode] = {"sr": sr, "launches": launches,
                      "captures": CapturedProgram.captures - captures}
        if hr.shape != want or hr.dtype != np.uint8 or hr.min() == hr.max():
            raise RuntimeError(f"[main] {mode}: output {hr.shape} {hr.dtype}, want {want} uint8")
        log(f"[main] {mode}: launches of a run {launches}, want {need}; card: {card}")
        if launches != need:
            raise RuntimeError(f"[main] {mode} launched {launches}, want {need}")
    if (runs["captured"]["captures"], runs["eager"]["captures"]) != (1, 0):
        raise RuntimeError(f"[main] captures: {runs['captured']['captures']} captured, "
                           f"{runs['eager']['captures']} eager; want 1 and 0")
    for rec in runs.values():
        profile_streaming(rec["sr"], frames, rec["launches"])
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
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram
    from tecogan_tpu_torch.weights import (
        from_jax_params, params_to_npz, read_params_npz, to_jax_params)

    # (a) 41 HR PNGs and the phase-6 model (16 blocks) as a params npz.
    hr_dir, npz = os.path.join(tmp, "cli_hr"), os.path.join(tmp, "cli_params.npz")
    os.makedirs(hr_dir)
    hr = (synthetic_clip(CLI_FRAMES, 4 * LR_H, 4 * LR_W, seed=31, content="natural")
          * 255).astype(np.uint8)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: write_png(os.path.join(hr_dir, f"im{i + 1}.png"), hr[i]),
                      range(CLI_FRAMES)))
    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16", infer_chunk=CHUNK)
    gen_tree, fnet_tree = to_jax_params(*build_models(6, cfg))
    params_to_npz(npz, generator=gen_tree, fnet=fnet_tree)
    log(f"[cli] {CLI_FRAMES} synthetic HR PNGs of {4 * LR_H}x{4 * LR_W} and a "
        f"{NUM_RESBLOCK}-block params npz written")

    # (b) The CLI, in-process, as a user calls it; counted. Run 1 and the
    # direct StreamingSR.run it is compared with use cuDNN's deterministic
    # algorithms: a transposed conv may otherwise sum with atomics, and one
    # float ulp can flip a uint8 level. Run 2, into another directory, keeps
    # PyTorch's default flags, as a user's run does, with the python codec.
    def cli(out_dir, *extra, codec="native", mesh_devices=None):
        """One CLI run with the native or the python PNG codec (and the
        parallel flags' devices, as a library caller places them); ``stats``
        gains the frames the native library decoded and encoded in it."""
        printed = io.StringIO()
        counts = codec_counts()
        with contextlib.redirect_stdout(printed), (
                python_codec() if codec == "python" else contextlib.nullcontext()):
            stats = cli_main.main(["--mode", "inference", "--input_dir_HR", hr_dir,
                                   "--output_dir", out_dir, "--device", "cuda", *extra],
                                  mesh_devices=mesh_devices)
        stats.update(codec=codec, native=tuple(n - c for n, c in zip(codec_counts(), counts)))
        return stats, printed.getvalue()

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
        # The parallel flags on one card (main's mesh_devices puts both
        # shards or both stages there), captured by default: --spatial_shards
        # 2 against the eager sharded StreamingSR.run, --pipeline against
        # run 1, and at the CLI's default dtype (float32 frames in float32:
        # stage F's frames are its input buffer) against the plain CLI there.
        card_dev = f"cuda:{torch.cuda.current_device()}"
        argv32 = ["--params_npz", npz, "--infer_chunk", str(CHUNK)]
        par = {}
        for k, (name, flags, args) in enumerate((
                ("--spatial_shards 2", ["--spatial_shards", "2"], argv),
                ("--pipeline", ["--pipeline"], argv),
                ("plain float32", [], argv32),
                ("--pipeline float32", ["--pipeline"], argv32))):
            _zero_counts()
            before = CapturedProgram.captures
            stats, printed = cli(os.path.join(tmp, f"cli_par{k}"), *args, *flags,
                                 mesh_devices=[card_dev] * 2 if flags else None)
            par[name] = dict(stats=stats, launches=_launch_counts(),
                             captures=CapturedProgram.captures - before,
                             io=[ln for ln in printed.splitlines() if ln.startswith("io:")])
        sharded = StreamingSR(cfg, *from_jax_params(trees["generator"], trees["fnet"]),
                              output="uint8", device=dev, capture=False,
                              spatial_mesh=make_mesh({"space": 2}, [card_dev] * 2))
        direct_sharded, _ = sharded.run(data.inputs, warmup=WARMUP)
    finally:
        torch.backends.cudnn.deterministic = False
    # Run 2 keeps the default flags, with the python PNG codec (phase 9b
    # holds the two codecs' pixels equal).
    runs.append(cli(os.path.join(tmp, "cli_out2"), *argv, codec="python"))
    for i, (stats, _) in enumerate(runs, 1):
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
    for i, (stats, _) in enumerate(runs, 1):
        flags = "cuDNN deterministic" if i == 1 else "default flags"
        log(f"[cli] run {i} ({flags}, {stats['codec']} PNG codec: the native library decoded "
            f"and encoded {stats['native']} frames): {CLI_FRAMES} HR PNGs {4 * LR_H}x{4 * LR_W} "
            f"-> LR {LR_H}x{LR_W} (+{WARMUP} warm-up) -> {stats['written']} HR PNGs, bfloat16, "
            f"{NUM_RESBLOCK} resblocks, chunk {CHUNK}, {stats['threads']} encode threads; "
            f"card: {card}")
    for line in runs[0][1].splitlines():
        if line.startswith(("total time", "Wrote", "io:")):
            log(f"[cli] | {line}")
    # The parallel flags: each run's PNGs against its reference, its
    # launches (2 shards: twice the plain run's; the pipeline: the plain
    # run's), its captures (1 a chunk shape sharded or plain, 2 pipelined)
    # and a program built inside the stream.
    got32 = read_frames([os.path.join(par["plain float32"]["stats"]["out_dir"], n)
                         for n in names])
    if got32.shape != got.shape or got32.min() == got32.max():
        raise RuntimeError(f"[cli] plain float32 run: frames of {got32.shape}, "
                           f"{got32.min()}-{got32.max()}")
    for name, ref, shards, want_captures in (
            ("--spatial_shards 2", direct_sharded, 2, 1), ("--pipeline", got, 1, 2),
            ("plain float32", got32, 1, 1), ("--pipeline float32", got32, 1, 2)):
        rec = par[name]
        stats = rec["stats"]
        out = read_frames([os.path.join(stats["out_dir"], n) for n in names])
        same = out.shape == ref.shape and np.array_equal(out, ref)
        want = {"upsample4": shards * need["upsample4"],
                "resblock_chain": shards * need["resblock_chain"], "upsample4_bwd": 0}
        against = ("the eager sharded StreamingSR.run" if shards > 1 else
                   "the plain float32 CLI" if name.endswith("float32") else
                   "run 1 (the plain CLI)")
        placed = f"on [{card_dev}, {card_dev}]" if name.startswith("--") else "on the card"
        log(f"[cli] {name} {placed} (cuDNN deterministic, native codec): "
            f"{stats['written']} PNGs "
            f"{'byte-equal to' if same else 'DIFFERING from'} {against}; "
            f"route {stats['route']}; launches {rec['launches']} (want {want}), "
            f"{rec['captures']} capture(s) (want {want_captures}); card: {card}")
        for line in rec["io"]:
            log(f"[cli] {name} | {line}")
        if (not same or rec["launches"] != want or rec["captures"] != want_captures
                or not stats["capture_s"] > 0 or not stats["route"].startswith(
                    "stage F captured" if name.startswith("--pipeline") else "captured")):
            raise RuntimeError(f"[cli] {name}: byte-equal {same}, launches {rec['launches']} "
                               f"(want {want}), captures {rec['captures']} (want "
                               f"{want_captures}), program {stats['capture_s']} s, route "
                               f"{stats['route']!r}")

    # (d) The checkpoint route: phase 8's 10-block checkpoint, float32.
    stats, printed = cli(os.path.join(tmp, "cli_ckpt"), "--checkpoint", ckpt_dir,
                         "--max_frames", "10")
    note = [ln for ln in printed.splitlines() if ln.startswith(("Loaded checkpoint", "NOTE:"))]
    if stats["written"] != 10 or not any(
            "NOTE: checkpoint has 10 resblocks; overriding --num_resblock 16" in ln
            for ln in note):
        raise RuntimeError(f"[cli] --checkpoint run: {stats}, {note}")
    for line in note:
        log(f"[cli] --checkpoint | {line}")
    log(f"[cli] --checkpoint: {stats['written']} frames, float32")

    # (e) The metrics CLI on the 41 outputs against their HR frames.
    metrics_dir = os.path.join(tmp, "cli_metrics")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        avg = cli_metrics.main(["--output", metrics_dir, "--results", out_dir,
                                "--targets", hr_dir, "--device", "cuda"])
    header = Path(metrics_dir, "metrics.csv").read_text().splitlines()[0]
    scored = CLI_FRAMES - 4
    if "tOF_00" not in header or sorted(avg) != [
            "FrameAvg_PSNR", "FrameAvg_SSIM", "FrameAvg_tOF"] or not all(
            math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[eval] metrics CLI: header {header}, {avg}")
    log(f"[eval] cli.metrics --device cuda, {scored} frames scored (PSNR, SSIM, tOF; "
        f"no LPIPS weights): "
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
        with contextlib.redirect_stdout(io.StringIO()):
            avg = evaluate_folders([res8], [tar8], os.path.join(tmp, f"eval_{len(evals)}"),
                                   lpips_model=LPIPS(alex, lin, device), device=device)
        evals.append((avg, _csv_cells(os.path.join(tmp, f"eval_{len(evals)}", "metrics.csv"))))
    (avg_d, cells_d), (avg_c, cells_c) = evals
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
                _, metrics = trainer.train_step(state, batch)
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
                    f"gate {gate}: one step, "
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
    profile's launches. Returns the launches of one steady ``train_step``."""
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
    with contextlib.redirect_stdout(printed), watched_summaries(kernels) as (calls, writes):
        modes = train_modes(cfg, kernels, runs, (0, GAN_STEPS), "[gan train]")
    summaries = check_summaries(
        "[gan train]", cfg, {os.path.join(out_dir, "log"): [GAN_STEPS, GAN_RESUME_STEPS],
                             os.path.join(tmp, "tecogan_eager", "log"): [GAN_EAGER_STEPS]},
        calls, writes)
    state = modes["captured"]["state"]
    text = printed.getvalue()
    for line in text.splitlines():
        if line.startswith(("step ", "Resumed", "Saved", "Dataset", "Warm-started",
                            "warm_start", "WARNING")):
            log(f"[gan train] | {line}")
    if state.step != GAN_RESUME_STEPS or len(modes["captured"]["launches"]) != GAN_RESUME_STEPS \
            or modes["eager"]["state"].step != GAN_EAGER_STEPS:
        raise RuntimeError(f"[gan train] steps to {state.step}, "
                           f"{len(modes['captured']['launches'])} step calls; eager "
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
    check_captured_equals_eager(dev, cfg, "[gan train]", vgg=vgg)
    GENERATE["TECOGAN_PRESET float32"] = dict(summaries, **check_generate(
        dev, cfg, state, "[gan train]", card, vgg=vgg()))
    profile_step(dev, cfg, state, "TECOGAN_PRESET", vgg=vgg())
    return step


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
# Steps of phase 8c (FRVSR_PRESET in bfloat16 through train(), captured) and
# of phase 11b (TECOGAN_PRESET).
BF16_TRAIN_STEPS, BF16_GAN_STEPS = 25, 10
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
        with entries_called() as entries:
            _, metrics = trainer.train_step(state, batch)
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
            f"step, library entries {entries}, launches {runs[-1]['launches']}, "
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


def bf16_train(dev, cfg, out_dir: str, steps: int, label: str, **train_kw) -> dict:
    """``train()`` of ``cfg`` (bfloat16) for ``steps`` steps, captured (the
    default), as a user's run: nothing synchronises inside. Each step's
    launches are read on the host (a replay adds its capture's): exactly a
    step's, twice that at the first (its warm-up and one replay); only the
    bfloat16 library entries run; the state stays float32. Returns the
    state, one steady step's launches, train()'s output, the entries and
    the summaries' launches."""
    import io

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd
    from tecogan_tpu_torch.train.loop import train
    from tecogan_tpu_torch.train.trainer import named_state_tensors

    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), entries_called() as entries, \
            watched_summaries(kernels) as (calls, writes), \
            counted_train_steps(kernels) as (launches, trainers):
        state = train(cfg, out_dir, dev, max_steps=steps, test_while_train=False, **train_kw)
        if len(trainers) != 1 or not trainers[0].capture or trainers[0].recaptures:
            raise RuntimeError(f"{label}: {len(trainers)} trainers, capture "
                               f"{[t.capture for t in trainers]}")
        del trainers[:]
    text = printed.getvalue()
    if state.step != steps or len(launches) != steps:
        raise RuntimeError(f"{label}: {state.step} steps, {len(launches)} step calls")
    check_step_launches(launches, (0,), step_launch_want(cfg), label)
    # The summaries' generate calls run the generator with no gradient to
    # record: its transposed convs take the epilogue's bfloat16 entry.
    want_entries = BF16_ENTRIES | {"tt_bias_relu_crop_bf16"}
    if set(entries) != want_entries:
        raise RuntimeError(f"{label}: library entries {entries}, want only {want_entries}")
    if "compute dtype bfloat16, float32 master weights" not in text:
        raise RuntimeError(f"{label}: train() did not name the dtype: {text[-2000:]}")
    ints = {"device_step", "counter_with_d", "counter_wo_d", "d_opt.count"}
    for name, t in named_state_tensors(state):
        if t.dtype != (torch.int32 if name in ints else torch.float32):
            raise RuntimeError(f"{label}: state tensor {name} is {t.dtype}")
    if not all(math.isfinite(float(v)) for v in state.ema_losses.values()):
        raise RuntimeError(f"{label}: loss EMAs {state.ema_losses}")
    summaries = check_summaries(label, cfg, {os.path.join(out_dir, "log"): [steps]}, calls,
                                writes)
    return dict(state=state, launches=launches[-1], text=text, entries=entries,
                summaries=summaries)


def run_bf16_training(dev, card: str, tmp: str):
    """Phase 8c: FRVSR_PRESET in bfloat16 through ``train()`` on phase 8's
    scenes, captured (:func:`bf16_train`); 3 captured steps against 3 eager
    ones, bit-equal; the profile's launches, whose chain is the bfloat16
    tensor-core kernel. Returns one step's launches."""
    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.train import Trainer

    cfg = FRVSR_PRESET.replace(compute_dtype="bfloat16",
                               input_video_dir=os.path.join(tmp, "scenes"),
                               max_frm=SCENE_FRAMES - 1, display_freq=10**6,
                               summary_freq=10**6, save_freq=10**6)
    r = bf16_train(dev, cfg, os.path.join(tmp, "bf16_run"), BF16_TRAIN_STEPS, "[bf16 train]")
    state = r["state"]
    fresh = Trainer(cfg, "cpu").init_state(cfg.rand_seed)
    for prefix, m0, m1 in (("generator", fresh.generator, state.generator),
                           ("fnet", fresh.fnet, state.fnet)):
        for (name, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
            if torch.equal(p0, p1.detach().cpu()):
                raise RuntimeError(f"[bf16 train] {prefix}.{name} did not move")
    log(f"[bf16 train] FRVSR_PRESET ({cfg.num_resblock} resblocks, batch {cfg.batch_size}, "
        f"crop {cfg.crop_size}, {cfg.rnn_n} frames) in bfloat16, float32 master weights, "
        f"through train(), captured, {BF16_TRAIN_STEPS} steps: launches a step "
        f"{r['launches']} (the first twice that), library entries {sorted(r['entries'])} "
        f"only; every parameter moved, the state float32; card: {card}")
    check_captured_equals_eager(dev, cfg, "[bf16 train]")
    GENERATE["FRVSR_PRESET bfloat16"] = dict(r["summaries"], **check_generate(
        dev, cfg, state, "[bf16 train]", card))
    profile_step(dev, cfg, state, "FRVSR_PRESET bfloat16")
    return r["launches"]


def run_bf16_tecogan_training(dev, card: str, tmp: str):
    """Phase 11b: TECOGAN_PRESET in bfloat16 through ``train()`` with random
    VGG19 weights on phase 8's scenes, warm-started from phase 8's float32
    FRVSR checkpoint, captured (:func:`bf16_train`); the gate's counters; a
    replay's profile's launches (the bfloat16 chain kernel). Returns one
    step's launches."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19

    cfg = TECOGAN_PRESET.replace(compute_dtype="bfloat16",
                                 input_video_dir=os.path.join(tmp, "scenes"),
                                 max_frm=SCENE_FRAMES - 1, display_freq=10**6,
                                 summary_freq=10**6, save_freq=10**6)
    ckpt = os.path.join(tmp, "run", "checkpoints")
    r = bf16_train(dev, cfg, os.path.join(tmp, "bf16_tecogan"), BF16_GAN_STEPS,
                   "[bf16 gan train]", vgg=random_vgg19(cfg.rand_seed), pre_trained_dir=ckpt)
    state = r["state"]
    if f"Warm-started weights from {ckpt}" not in r["text"]:
        raise RuntimeError("[bf16 gan train] no warm start in train()'s output")
    counters = (int(state.counter_with_d), int(state.counter_wo_d))
    if sum(counters) != BF16_GAN_STEPS or int(state.d_opt.count) != counters[0]:
        raise RuntimeError(f"[bf16 gan train] gate counters {counters}, Adam count "
                           f"{int(state.d_opt.count)}")
    log(f"[bf16 gan train] TECOGAN_PRESET ({cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, crop {cfg.crop_size}, {cfg.unroll_frames} frames ping-pong, VGG19 "
        f"random weights) in bfloat16, warm-started from phase 8's float32 FRVSR checkpoint, "
        f"captured, {BF16_GAN_STEPS} steps: launches a step {r['launches']} (the first twice "
        f"that), library entries {sorted(r['entries'])} only; gate: {counters[0]} steps with "
        f"D, {counters[1]} without; the state float32; card: {card}")
    GENERATE["TECOGAN_PRESET bfloat16"] = dict(r["summaries"], **check_generate(
        dev, cfg, state, "[bf16 gan train]", card, vgg=random_vgg19(cfg.rand_seed)))
    profile_step(dev, cfg, state, "TECOGAN_PRESET bfloat16",
                 vgg=random_vgg19(cfg.rand_seed), modes=("captured",))
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
    thread reads them. Returns the last tick's frames."""
    streams = list(srv.open_streams)
    last = {}
    for t in range(ticks):
        out = srv.step({sid: frames[sid][(t + k) % len(frames[sid])]
                        for k, sid in enumerate(streams)}, fetch=False)
        for hr in last.values():
            np.asarray(hr)
        last = out
    arrays = {sid: np.asarray(hr) for sid, hr in last.items()}
    torch.cuda.synchronize()
    return arrays


def profile_serving(srv, frames, label: str) -> None:
    """One serve_ticks run under torch.profiler: the profile must show the
    chain (the bfloat16 tensor-core kernel) and K1 launched as often as the
    counters say."""
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.kernels import resblock_chain, upsample4

    before = (upsample4.launches, resblock_chain.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_ticks(srv, frames)
    counted = (upsample4.launches - before[0], resblock_chain.launches - before[1])
    busy, names = device_kernels(prof)
    if busy <= 0:
        raise RuntimeError(f"[profile] serving {label}: torch.profiler recorded no device time")
    if counted != (2 * FRAMES, NUM_RESBLOCK * FRAMES):
        raise RuntimeError(f"[profile] serving {label}: the counters say K1 {counted[0]}, "
                           f"chain {counted[1]}; want {2 * FRAMES}, {NUM_RESBLOCK * FRAMES}")
    profiled_launches(names, counted[1], counted[0], f"serving {label}")


def run_serving(dev, card: str):
    """Phase 12 (b): MultiGeometryServer in bfloat16 at full width, a
    4-slot bucket of 144x180 streams and a bucket of two 120x180 ones,
    FRAMES ticks after prewarm (which captures each bucket's tick),
    counted (the main path of serving), and an eviction that gives the
    evicted bucket's pool back; then VSRServer pools of 1, 4 and 8 slots
    at 144x180, captured and with ``capture=False``, each profiled.
    Returns (launches per bucket tick, the models)."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.kernels import warp_pack
    from tecogan_tpu_torch.serve import MultiGeometryServer, VSRServer

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16")
    rng = np.random.RandomState(13)
    geos = {"cal": (LR_H, LR_W), "walk": SERVE_GEO2}
    clips = {g: (rng.rand(FRAMES, *hw, 3) * 255).astype(np.uint8) for g, hw in geos.items()}
    srv = MultiGeometryServer(cfg, *build_models(6, cfg), slots_per_geometry=SERVE_SLOTS,
                              output="uint8", device=dev)
    srv.prewarm(geos.values())
    streams = {**{f"cal{i}": "cal" for i in range(SERVE_SLOTS)}, "walk0": "walk", "walk1": "walk"}
    for sid, g in streams.items():
        srv.open(sid, *geos[g])
    frames = {sid: np.roll(clips[g], -i, axis=0) for i, (sid, g) in enumerate(streams.items())}
    upsample4.launches = 0
    resblock_chain.launches = 0
    warp_pack.launches = 0
    last = serve_ticks(srv, frames)
    launches = {"upsample4": upsample4.launches, "resblock_chain": resblock_chain.launches,
                "warp_pack": warp_pack.launches}
    bucket_ticks = FRAMES * len(geos)
    need = {"upsample4": 2 * bucket_ticks, "resblock_chain": NUM_RESBLOCK * bucket_ticks,
            "warp_pack": bucket_ticks}
    log(f"[serve] (b) MultiGeometryServer, bfloat16, {NUM_RESBLOCK} resblocks, buckets "
        f"{srv.geometries}: launches over {FRAMES} ticks of {len(streams)} streams in "
        f"{len(geos)} captured buckets {launches}, want {need}; card: {card}")
    if launches != need:
        raise RuntimeError(f"[serve] launched {launches}, want {need}")
    for sid, hr in last.items():
        h, w = geos[streams[sid]]
        if hr.shape != (4 * h, 4 * w, 3) or hr.dtype != np.uint8 or hr.min() == hr.max():
            raise RuntimeError(f"[serve] {sid}: output {hr.shape} {hr.dtype}, "
                               f"range [{hr.min()}, {hr.max()}]")
    check_eviction(srv, geos["walk"], ["walk0", "walk1"])
    models = (srv.generator, srv.fnet)
    for slots in SERVE_POOLS:
        ids = [f"s{i}" for i in range(slots)]
        frames = {sid: np.roll(clips["cal"], -i, axis=0) for i, sid in enumerate(ids)}
        for mode, capture in (("captured", None), ("eager", False)):
            pool = VSRServer(cfg, *models, LR_H, LR_W, max_streams=slots, output="uint8",
                             device=dev, capture=capture)
            pool.prewarm()
            for sid in ids:
                pool.open(sid)
            serve_ticks(pool, frames)  # the first run after prewarm
            profile_serving(pool, frames, f"{slots} slot(s) {mode}")
            del pool
    per_tick = {k: v / bucket_ticks for k, v in launches.items()}
    return per_tick, models


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
    try:
        srv.open("third", *third)
    finally:
        srv.state_budget_mb = saved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool_id)
    log(f"[serve] (b) eviction: opening {third[0]}x{third[1]} evicted the idle "
        f"{geo[0]}x{geo[1]} bucket (its graph pool held {held} bytes), {left} bytes of the "
        f"evicted pool left; buckets {srv.geometries}")
    if geo in srv.geometries or left or held <= 0:
        raise RuntimeError(f"[serve] eviction: buckets {srv.geometries}, {left} bytes of the "
                           f"pool left of {held}")
    srv.close("third")


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
        save_frame_step(export_frame_step(cfg, *models, batch=SERVE_SLOTS, height=LR_H,
                                          width=LR_W, device=dev), path)
    finally:
        torch.backends.cudnn.deterministic = False
    child = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, inputs, outputs],
                           cwd=REPO, capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        raise RuntimeError(f"[serve] the exported step's process failed:\n{child.stderr[-4000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    got = torch.load(outputs)
    equal = [torch.equal(g, w) for g, w in zip(got, want)]
    loaded = [m for m in report["modules"] if m.startswith(("tecogan_tpu_torch.models",
                                                             "tecogan_tpu_torch.serve",
                                                             "tecogan_tpu_torch.recurrent"))]
    log(f"[serve] (c) exported frame step ({SERVE_SLOTS},{LR_H},{LR_W}) bfloat16 uint8: "
        f"a fresh process loaded and ran it with launches upsample4 "
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
    inference`` on its dir; then bfloat16 runs with the native and the
    python PNG codec, their captures and the native library's counters.
    Also decodes a filter-0 and a Paeth frame at 144x180 and at 576x720."""
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
            result = fn(argv)
        return result, printed.getvalue()

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # The budget counts the captured ticks' graph pools, about twice
        # bfloat16's in float32: two 4-slot buckets need more than the
        # default 2048 MB.
        stats, _ = quiet(cli_serve.main, [
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

    # bfloat16 runs with the native and the python PNG codec.
    source_frames = sum(d[1] for d in dirs.values())
    for i, codec in enumerate(("native", "python")):
        captures, counts = CapturedProgram.captures, codec_counts()
        with python_codec() if codec == "python" else contextlib.nullcontext():
            stats, _ = quiet(cli_serve.main, [
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
        log(f"[serve] (d) cli.serve bfloat16, {codec} PNG codec (the native library decoded "
            f"and encoded {native} frames), 3 PNG dirs ({', '.join(f'{n} {d[0][0]}x{d[0][1]} x{d[1]}' for n, d in dirs.items())}; walk Paeth-filtered): "
            f"{stats['frames']} HR PNGs, {stats['ticks']} ticks; {captures} tick graphs "
            f"captured (one a geometry); card: {card}")

    rng = np.random.RandomState(15)
    for h, w in ((LR_H, LR_W), (4 * LR_H, 4 * LR_W)):
        img = (synthetic_clip(1, h, w, seed=50, content="natural")[0] * 255).astype(np.uint8)
        img = np.clip(img.astype(np.int16) + rng.randint(-3, 4, img.shape), 0, 255).astype(np.uint8)
        for kind, writer in (("filter 0", write_png), ("Paeth", write_png_paeth)):
            path = os.path.join(tmp, f"decode_{h}x{w}_{kind[0]}.png")
            writer(path, img)
            if not np.array_equal(read_png(path), img):
                raise RuntimeError(f"[serve] {kind} PNG {h}x{w} decodes wrong")
    log("[serve] PNG decode of a filter-0 and a Paeth frame at 144x180 and 576x720: "
        "equal to the written pixels")


# ---------------------------------------------------------------- native data path

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
    native_loader.load_library()
    log(f"[native] {'built' if fresh else 'found'} {path.relative_to(REPO)} "
        f"from tecogan_tpu_torch/csrc/tecodata.cpp: "
        f"{' '.join(('g++', *native_loader._CXXFLAGS, '...', *native_loader._LDFLAGS))}, the "
        f"port's own PNG codec on zlib (libpng {'present' if found['png.h'] else 'absent'} "
        f"here; the build never uses it); card: {card}")


def check_codec(tmp: str, card: str) -> None:
    """Phase 9b: the native PNG codec against the python one on the card's
    machine: the 41 synthetic 576x720 HR PNGs of phase 9 (filter 0) and 8
    of them rewritten with every row Paeth-filtered decode bit-equal
    (``decode_frames_u8`` against ``read_rgb``); ``encode_frames`` then
    ``read_png`` gives the input back."""
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.native_loader import NativeFrameIO
    from tecogan_tpu_torch.data.png import read_png
    from tecogan_tpu_torch.ops import list_png_in_dir

    paths = list_png_in_dir(os.path.join(tmp, "cli_hr"), prefix_skip="\x00")
    io = NativeFrameIO(8)
    try:
        native = io.decode_frames_u8(paths)
        python = read_frames(paths, 8)
        if len(paths) != CLI_FRAMES or not np.array_equal(native, python):
            raise RuntimeError(f"[codec] {len(paths)} filter-0 PNGs: native != read_rgb in "
                               f"{int((native != python).sum())} values")
        paeth = [os.path.join(tmp, "codec", f"paeth_{i}.png") for i in range(8)]
        os.makedirs(os.path.dirname(paeth[0]))
        for path, img in zip(paeth, native):
            write_png_paeth(path, img)
        got = io.decode_frames_u8(paeth)
        want = read_frames(paeth, 8)
        if not (np.array_equal(got, want) and np.array_equal(got, native[:8])):
            raise RuntimeError("[codec] Paeth PNGs: native != read_rgb")
        encoded = [os.path.join(tmp, "codec", f"enc_{i}.png") for i in range(8)]
        io.encode_frames(encoded, native[:8])
    finally:
        io.close()
    back = np.stack([read_png(p) for p in encoded])
    if not np.array_equal(back, native[:8]):
        raise RuntimeError("[codec] encode_frames -> read_png does not give the input back")
    h, w = native.shape[1:3]
    log(f"[codec] native decode_frames_u8 == data/png.py read_rgb, bit for bit: {len(paths)} "
        f"{h}x{w} filter-0 PNGs and 8 Paeth-filtered ones; encode_frames -> read_png gives "
        f"the 8 frames back; card: {card}")


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


# Phase 13: the run cases through their CLIs. Case 4 at FRVSR_PRESET's
# widths, case 3 at TECOGAN_PRESET's (warm-started from case 4), case 1 at
# the calendar geometry with 16 blocks; each a subprocess on the card.
CASE_SCENES, CASE_FRAMES = 4, 14
CASE4_STEPS, CASE4_SAVE, CASE3_STEPS, CASE_LR_FRAMES = 10, 5, 5, 12


def run_cases(card: str, tmp: str) -> None:
    """Phase 13: ``data.prepare --synthetic`` and ``cli.run`` cases 4, 3, 1,
    2 and 0 as a user runs them, each a subprocess on the card with rc 0:
    FRVSR_PRESET training (10 steps, saves at 5 and 10,
    each with its four GIFs), TecoGAN_PRESET training warm-started from it
    (the 10 -> 16-block partial restore), random-weight inference on a
    12-frame 144x180 scene, its metrics (read back with
    ``read_frameavg_csv``), and case 0's offline recipe."""
    from tecogan_tpu_torch.cli.run import read_frameavg_csv
    from tecogan_tpu_torch.data.png import write_png
    from tecogan_tpu_torch.data.synthetic import synthetic_clip
    from tecogan_tpu_torch.train.checkpoint import latest_step
    from tecogan_tpu_torch.train.loop import SUMMARY_TAGS

    root = os.path.join(tmp, "cases")
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))

    def child(name, *argv):
        log_path = os.path.join(root, f"{name.replace(' ', '_')}.log")
        with open(log_path, "w") as out:
            rc = subprocess.call([sys.executable, "-m", *argv], cwd=str(REPO), env=env,
                                 stdout=out, stderr=subprocess.STDOUT,
                                 stdin=subprocess.DEVNULL)
        text = open(log_path).read()
        if rc != 0:
            raise RuntimeError(f"[cases] {name}: rc {rc}; its output ends:\n{text[-3000:]}")
        log(f"[cases] {name}: rc 0; card: {card}")
        return text

    data = os.path.join(root, "TrainingDataPath")
    child("data.prepare", "tecogan_tpu_torch.data.prepare", "--synthetic", str(CASE_SCENES),
          "--duration", str(CASE_FRAMES), "--output_dir", data)
    scenes = sorted(d for d in os.listdir(data) if d.startswith("scene_"))
    if scenes != [f"scene_{2000 + i}" for i in range(CASE_SCENES)]:
        raise RuntimeError(f"[cases] data.prepare wrote {scenes}")
    train_flags = ["--max_frm", str(CASE_FRAMES - 1), "--str_dir", "2000",
                   "--end_dir", str(2000 + CASE_SCENES - 2),
                   "--end_dir_val", str(2000 + CASE_SCENES - 1), "--no_test_while_train"]
    child("cli.run 4", "tecogan_tpu_torch.cli.run", "4", "--root", root,
          "--max_iter", str(CASE4_STEPS), "--save_freq", str(CASE4_SAVE), *train_flags)
    frvsr = os.path.join(root, "ex_FRVSRmm-dd-hh")
    if latest_step(os.path.join(frvsr, "checkpoints")) != CASE4_STEPS:
        raise RuntimeError(f"[cases] case 4 left no step-{CASE4_STEPS} checkpoint")
    for step in range(CASE4_SAVE, CASE4_STEPS + 1, CASE4_SAVE):
        for tag in SUMMARY_TAGS:
            if not os.path.isfile(os.path.join(frvsr, "log", f"{tag}_0_step{step}.gif")):
                raise RuntimeError(f"[cases] case 4: no {tag} GIF at step {step}")
    text = child("cli.run 3", "tecogan_tpu_torch.cli.run", "3", "--root", root,
                 "--allow_random_weights", "--max_iter", str(CASE3_STEPS),
                 "--save_freq", str(CASE3_STEPS), *train_flags)
    with open(os.path.join(root, "ex_TecoGANmm-dd-hh", "log", "logfile.txt")) as f:
        teco_log = f.read()
    for want in (f"case 3: FRVSR warm start <- {os.path.join(frvsr, 'checkpoints')}",):
        if want not in text:
            raise RuntimeError(f"[cases] case 3 printed no {want!r}")
    for want in ("warm_start: partial generator restore", "Training TecoGAN on cuda"):
        if want not in teco_log:
            raise RuntimeError(f"[cases] case 3's log has no {want!r}")
    with open(os.path.join(root, "ex_TecoGANmm-dd-hh", "config.json")) as f:
        teco_cfg = json.load(f)
    if (teco_cfg["num_resblock"], teco_cfg["pingpong"]) != (16, True):
        raise RuntimeError(f"[cases] case 3 trained {teco_cfg['num_resblock']} blocks, "
                           f"ping-pong {teco_cfg['pingpong']}")
    line = next(ln for ln in teco_log.splitlines() if "partial generator restore" in ln)
    log(f"[cases] case 3 | {line.strip()}")
    if latest_step(os.path.join(root, "ex_TecoGANmm-dd-hh", "checkpoints")) != CASE3_STEPS:
        raise RuntimeError("[cases] case 3 left no checkpoint")

    # The calendar geometry: 12 HR frames of 576x720 and their 144x180 LR.
    hr = (synthetic_clip(CASE_LR_FRAMES, 4 * LR_H, 4 * LR_W, seed=13, content="natural")
          * 255).astype(np.uint8)
    for sub, frames in (("HR", hr), ("LR", hr[:, ::4, ::4])):
        d = os.path.join(root, sub, "calendar")
        os.makedirs(d)
        for i, frame in enumerate(frames):
            write_png(os.path.join(d, f"col_high_{i:04d}.png"), np.ascontiguousarray(frame))
    child("cli.run 1", "tecogan_tpu_torch.cli.run", "1", "--root", root)
    outputs = sorted(os.listdir(os.path.join(root, "results", "calendar")))
    if outputs != [f"output_{i:04d}.png" for i in range(CASE_LR_FRAMES)]:
        raise RuntimeError(f"[cases] case 1 wrote {outputs[:3]}... ({len(outputs)})")
    child("cli.run 2", "tecogan_tpu_torch.cli.run", "2", "--root", root)
    avg = read_frameavg_csv(os.path.join(root, "results", "metric_log", "metrics.csv"))
    if set(avg) != {"FrameAvg_PSNR", "FrameAvg_SSIM", "FrameAvg_tOF"} or \
            not all(math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[cases] case 2's metrics.csv: {avg}")
    text = child("cli.run 0", "tecogan_tpu_torch.cli.run", "0", "--root", root)
    if "Network downloads disabled" not in text or "np.savez('model/TecoGAN.npz'" not in text:
        raise RuntimeError(f"[cases] case 0 printed {text[-1000:]}")
    log(f"[cases] data.prepare --synthetic {CASE_SCENES} (288x352, {CASE_FRAMES} frames), "
        f"case 4 FRVSR_PRESET {CASE4_STEPS} steps (saves and GIFs at "
        f"{list(range(CASE4_SAVE, CASE4_STEPS + 1, CASE4_SAVE))}), case 3 TECOGAN_PRESET "
        f"{CASE3_STEPS} steps warm-started from case 4, case 1 on {CASE_LR_FRAMES} frames "
        f"{LR_H}x{LR_W} -> {4 * LR_H}x{4 * LR_W} (16 blocks, random weights), case 2 "
        f"{', '.join(f'{k} {v:.4f}' for k, v in sorted(avg.items()))} (random weights), case 0: "
        f"all rc 0; card: {card}")


# Video-file I/O (phase 14): the clip, its frame rates and the mean
# |error| each written file may have against its source: the bound
# tests/test_torch_video_io.py::test_chip_smoke_video_bound holds (the JAX
# writer's error on the same clip, measured with OpenCV on the CPU, + 0.5).
VIDEO_FRAMES, VIDEO_SEED = 30, 41
VIDEO_FILES = (("avi", 24.0), ("mp4", 24.0), ("mkv", 29.97))
VIDEO_ERR_BOUND = {"avi": 6.32, "mp4": 6.78, "mkv": 6.78}
VIDEO_GEO2 = (120, 180)


def video_clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded procedural uint8 clip (the port's natural synthetic content)."""
    from tecogan_tpu_torch.data.synthetic import synthetic_clip

    return (synthetic_clip(frames, h, w, seed=seed, content="natural") * 255).astype(np.uint8)


def run_video(dev, card: str, tmp: str) -> dict:
    """Phase 14: the port's video I/O on the card's host and through the
    CLIs; returns the launch counts of the ``--input_video`` CLI run."""
    import io

    from tecogan_tpu_torch.cli import main as cli_main
    from tecogan_tpu_torch.cli import serve as cli_serve
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data import video_native
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.png import read_png, write_png
    from tecogan_tpu_torch.data.prepare import extract_scene
    from tecogan_tpu_torch.data.video_io import VideoFrameWriter, read_video_frames
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.ops.resize import resize_area
    from tecogan_tpu_torch.weights import params_to_npz, to_jax_params

    root = os.path.join(tmp, "video")
    os.makedirs(root)
    # (a) The library, from the checkout's sources.
    lib_path = video_native.build_library()
    video_native.load_library()
    log(f"[video] libtecovideo built and loaded -> {lib_path.relative_to(REPO)} (g++ "
        f"{' '.join(video_native._CXXFLAGS)}, one process per source, linked "
        f"{' '.join(video_native._LDFLAGS)})")

    # (b) Write and read back each container.
    clip = video_clip(VIDEO_FRAMES, LR_H, LR_W, VIDEO_SEED)
    paths = {}
    for ext, fps in VIDEO_FILES:
        path = paths[ext] = os.path.join(root, f"clip.{ext}")
        w = VideoFrameWriter(path, fps=fps)
        w.submit(clip[:13], 0)
        w.submit(clip[13:], 13)
        if w.close() != VIDEO_FRAMES:
            raise RuntimeError(f"[video] {ext}: the writer wrote {w.count} frames")
        back, got_fps = read_video_frames(path)
        err = float(np.abs(back.astype(np.float64) - clip).mean())
        codec = video_native.NativeVideoReader(path)
        log(f"[video] {ext} ({codec.codec} in {codec.container}, {got_fps} fps, "
            f"{os.path.getsize(path)} B): {back.shape[0]} frames {back.shape[1:]} read back, "
            f"mean |error| {err:.3f} (bound {VIDEO_ERR_BOUND[ext]}); card: {card}")
        codec.close()
        if back.shape != clip.shape or got_fps != fps or not err <= VIDEO_ERR_BOUND[ext]:
            raise RuntimeError(f"[video] {ext}: {back.shape} at {got_fps} fps, error {err}")

    # (c) The inference CLI on the .mp4 and on a PNG directory of its decode.
    decoded, _ = read_video_frames(paths["mp4"])
    png_dir = os.path.join(root, "clip_png")
    os.makedirs(png_dir)
    for i, f in enumerate(decoded):
        write_png(os.path.join(png_dir, f"{i:04d}.png"), f)
    npz = os.path.join(root, "params.npz")
    cfg = TecoConfig(num_resblock=NUM_RESBLOCK)
    gen_tree, fnet_tree = to_jax_params(*build_models(6, cfg))
    params_to_npz(npz, generator=gen_tree, fnet=fnet_tree)

    def cli(name, *extra):
        printed = io.StringIO()
        upsample4.launches = 0
        resblock_chain.launches = 0
        with contextlib.redirect_stdout(printed):
            stats = cli_main.main(["--mode", "inference", "--output_dir",
                                   os.path.join(root, name), "--params_npz", npz, *extra])
        stats["launches"] = {"upsample4": upsample4.launches,
                             "resblock_chain": resblock_chain.launches}
        return stats

    torch.backends.cudnn.deterministic = True
    try:
        from_video = cli("from_video", "--input_video", paths["mp4"])
        from_png = cli("from_png", "--input_dir_LR", png_dir)
    finally:
        torch.backends.cudnn.deterministic = False
    names = [f"output_{i:04d}.png" for i in range(VIDEO_FRAMES)]
    got = read_frames([os.path.join(root, "from_video", n) for n in names])
    want = read_frames([os.path.join(root, "from_png", n) for n in names])
    if got.shape != (VIDEO_FRAMES, 4 * LR_H, 4 * LR_W, 3) or not np.array_equal(got, want):
        raise RuntimeError(f"[video] --input_video and the PNG route differ: {got.shape}, "
                           f"{int((got != want).sum())} values")
    if got.min() == got.max():
        raise RuntimeError("[video] the CLI's output is constant")
    launches = from_video["launches"]
    if launches != from_png["launches"] or not all(launches.values()):
        raise RuntimeError(f"[video] launches {launches} (video) vs {from_png['launches']} "
                           "(PNG)")
    log(f"[video] cli.main --input_video clip.mp4 ({VIDEO_FRAMES} frames {LR_H}x{LR_W}, "
        f"{NUM_RESBLOCK} blocks, {cfg.compute_dtype}, chunk {cfg.infer_chunk}) bit-equal to "
        f"the PNG route on the port's decode: {VIDEO_FRAMES} HR frames "
        f"{4 * LR_H}x{4 * LR_W}; launches {launches} in both (fps read {from_video['fps']})")
    # --output_video, against the writer on the PNG route's frames.
    hr_video, hr_fps = read_video_frames(
        cli("vout", "--input_video", paths["mp4"], "--output_video", "out.mp4")["dest"])
    cli("pout", "--input_dir_LR", png_dir)
    pngs = read_frames([os.path.join(root, "pout", n) for n in names])
    direct = os.path.join(root, "direct.mp4")
    w = VideoFrameWriter(direct, fps=hr_fps)
    w.submit(pngs, 0)
    w.close()
    direct_frames, _ = read_video_frames(direct)
    if hr_fps != 24.0 or hr_video.shape != pngs.shape or not np.array_equal(hr_video,
                                                                              direct_frames):
        raise RuntimeError(f"[video] --output_video: {hr_video.shape} at {hr_fps} fps, not "
                           "the writer's encoding of the PNG route's frames")
    hr_err = float(np.abs(hr_video.astype(np.float64) - pngs).mean())
    log(f"[video] --output_video out.mp4: {hr_video.shape[0]} frames at {hr_fps} fps, "
        f"bit-equal to the writer on the PNG route's frames, mean |error| {hr_err:.3f} "
        f"against them")

    # (d) cli.serve on two video sources of two geometries, --output_videos.
    second = os.path.join(root, "street.mkv")
    w = VideoFrameWriter(second, fps=29.97)
    w.submit(video_clip(12, *VIDEO_GEO2, VIDEO_SEED + 1), 0)
    w.close()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = cli_serve.main(["--input_dirs", f"{paths['mp4']},{second}", "--output_dir",
                                os.path.join(root, "served"), "--params_npz", npz,
                                "--output_videos", "--max_streams", "2"])
    want_written = {"clip": VIDEO_FRAMES, "street": 12}
    if stats["written"] != want_written:
        raise RuntimeError(f"[video] cli.serve wrote {stats['written']}")
    for name, n, geo, fps in (("clip", VIDEO_FRAMES, (LR_H, LR_W), 24.0),
                              ("street", 12, VIDEO_GEO2, 29.97)):
        hr, hr_fps = read_video_frames(os.path.join(root, "served", f"{name}.mp4"))
        if hr.shape != (n, 4 * geo[0], 4 * geo[1], 3) or hr_fps != fps:
            raise RuntimeError(f"[video] cli.serve {name}.mp4: {hr.shape} at {hr_fps} fps")
    log(f"[video] cli.serve on clip.mp4 ({LR_H}x{LR_W}, 24 fps) and street.mkv "
        f"({VIDEO_GEO2[0]}x{VIDEO_GEO2[1]}, 29.97 fps) with --output_videos: wrote "
        f"{stats['written']}, each .mp4 at its source's fps; card: {card}")

    # (e) extract_scene from frame 5 of the .avi and the .mp4.
    for ext in ("avi", "mp4"):
        frames, _ = read_video_frames(paths[ext])
        out = os.path.join(root, f"scene_{ext}")
        n = extract_scene(paths[ext], 5, out, duration=10)
        two = extract_scene(paths[ext], 5, out + "_test", duration=10, test_only=True)
        for i in range(n):
            got = read_png(os.path.join(out, f"col_high_{i:04d}.png"))
            if not np.array_equal(got, resize_area(frames[5 + i], 0.5)):
                raise RuntimeError(f"[video] extract_scene {ext} frame {5 + i} differs")
        if (n, two) != (10, 2):
            raise RuntimeError(f"[video] extract_scene {ext} wrote {n} and {two} frames")
    log(f"[video] extract_scene from frame 5 of clip.avi and clip.mp4: 10 PNGs of "
        f"{LR_H // 2}x{LR_W // 2} each (2 with test_only), equal to the decoded frames "
        "through resize_area")
    return launches


# H.264 and VP9 input on the card's NVDEC (phase 15): the 144x180 H.264
# clip of the CLI run, the frames of the decode checks at 144x180 and 720p,
# and the NV12 kernel's timed surfaces (display size, coded size, pitch).
NVDEC_CLI_FRAMES, NVDEC_DECODE_FRAMES, NVDEC_720P_FRAMES = 30, 30, 8
NV12_TIMED = (((144, 180), (144, 192), 256), ((720, 1280), (720, 1280), 1536))
# The bytes a pixel of the NV12 conversion moves: 1.5 read, 3 written.
NV12_BYTES_PER_PX = 4.5


def nvdec_streams():
    """``tests/nvdec_streams.py`` loaded by path (it imports numpy alone):
    the hand-written H.264 streams, their muxers and numpy model, the VP9
    fixture's record and ``ModelNvdec``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("nvdec_streams",
                                                  REPO / "tests" / "nvdec_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def model_in_place_of_nvdec(model):
    """``model`` (``tests/nvdec_streams.py:ModelNvdec``) in place of the
    NVDEC binding for the readers opened inside; taken only where NVDEC
    refused with ``NvdecUnavailable``."""
    from tecogan_tpu_torch.data import video_nvdec

    saved = video_nvdec.load_library
    video_nvdec.load_library = lambda: model
    try:
        yield
    finally:
        video_nvdec.load_library = saved


def check_nvdec_format(dev, tn, h264: dict, paths: dict, refused: bool) -> list:
    """Phase 15 (a): every H.264 stream (MP4 and MKV) and the VP9 fixture
    through the port's NVDEC reader. NVDEC's parser must report each
    sequence header's coded size and display area (H.264: the VUI's range
    and matrix too, where it has them). Where NVDEC creates no decoder
    (``refused``), the first decode must then raise ``NvdecUnavailable``;
    with NVDEC it must decode every frame. Returns what it saw."""
    from tecogan_tpu_torch.data.video_nvdec import NvdecUnavailable, NvdecVideoReader

    vp9 = tn.vp9_expected()["shape"]
    cases = [(f"{name}.{container}", path, h264[name]) for (name, container), path in
             paths.items()] + [("VP9 fixture", str(tn.VP9_FIXTURE), None)]
    seen = []
    for label, path, st in cases:
        reader = NvdecVideoReader(path, dev)
        try:
            try:
                n = reader.decode(1 << 20).shape[0]
            except NvdecUnavailable:
                if not refused:
                    raise
                n = None
            if refused and n is not None:
                raise RuntimeError(f"[nvdec] {label} decoded where NVDEC refused a decoder")
            if not refused and n != (st.count if st else vp9[0]):
                raise RuntimeError(f"[nvdec] {label}: {n} frames decoded")
            fmt = reader.stream_format()
        finally:
            reader.close()
        if fmt is None:
            raise RuntimeError(f"[nvdec] {label}: the parser reported no sequence header")
        if st is None:
            want = {"display": (0, 0, vp9[2], vp9[1])}
        else:
            want = {"coded": (16 * st.mbw, 16 * st.mbh), "display": (0, 0, st.w, st.h)}
            if "full_range" in st.p:
                want["matrix"], want["full_range"] = st.colour()
        if any(fmt[k] != v for k, v in want.items()):
            raise RuntimeError(f"[nvdec] {label}: the parser reports {fmt}, want {want}")
        seen.append(f"{label} {fmt['display'][2]}x{fmt['display'][3]} in "
                    f"{fmt['coded'][0]}x{fmt['coded'][1]} (range {int(fmt['full_range'])}, "
                    f"matrix {fmt['matrix']})")
    return seen


def check_nv12_kernel(dev, card: str) -> dict:
    """Phase 15 (c): the NV12 kernel against its plain version on random
    surfaces (pitch > width, odd offsets, both ranges, BT.601 and BT.709),
    then timed at the serving / CLI size and at 720p beside its bound."""
    from tecogan_tpu_torch.kernels import nv12_to_rgb, nv12_to_rgb_plain, yuv_coefficients

    gen = torch.Generator().manual_seed(15)
    cases = (((41, 57), (48, 64), 80, (3, 5), 2, False), ((45, 67), (52, 72), 96, (1, 7), 1, True),
             ((144, 180), (144, 192), 256, (0, 0), 2, False),
             ((720, 1280), (720, 1280), 1536, (0, 0), 1, True),
             ((100, 80), (112, 80), 128, (0, 0), 6, True))
    err = 0
    for (h, w), (ch, cw), pitch, (left, top), matrix, full in cases:
        surface = torch.randint(0, 256, (ch + ch // 2, pitch), dtype=torch.uint8, generator=gen)
        coeffs = yuv_coefficients(matrix, full)
        want = nv12_to_rgb_plain(surface, ch, left, top, w, h, coeffs)
        got = nv12_to_rgb(surface.to(dev), ch, left, top, w, h, coeffs)
        torch.cuda.synchronize()
        err = max(err, int((got.cpu().int() - want.int()).abs().max()))
    if err:
        raise RuntimeError(f"[nvdec] the NV12 kernel differs from its plain version by {err}")
    timed = []
    for (h, w), (ch, cw), pitch in NV12_TIMED:
        surface = torch.randint(0, 256, (ch + ch // 2, pitch), dtype=torch.uint8,
                                generator=gen).to(dev)
        coeffs = yuv_coefficients()
        (ms, lo, hi), (plain_ms, plo, phi) = time_fns(
            [lambda: nv12_to_rgb(surface, ch, 0, 0, w, h, coeffs),
             lambda: nv12_to_rgb_plain(surface, ch, 0, 0, w, h, coeffs)])
        bound_ms = NV12_BYTES_PER_PX * h * w / HBM_BYTES_PER_S * 1e3
        bound_by = "bytes"
        text = (f"({NV12_BYTES_PER_PX * h * w / 1e6:.3f} MB / {HBM_BYTES_PER_S / 1e12:.2f} "
                "TB/s; about 15 integer "
                "operations a pixel)")
        log(f"[nvdec] NV12 kernel {h}x{w} (coded {ch}x{cw}, pitch {pitch}): {ms:.4f} ms "
            f"[{lo:.4f}-{hi:.4f}], plain {plain_ms:.4f} ms [{plo:.4f}-{phi:.4f}], library None "
            f"(no PyTorch call converts NV12), bound {bound_ms:.5f} ms {text}, share of bound "
            f"{bound_ms / ms:.1%}; card: {card}")
        timed.append({"label": f"{h}x{w}", "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
    log(f"[nvdec] NV12 kernel bit-equal to its plain version on {len(cases)} surfaces (pitch > "
        "width, odd offsets, limited and full range, BT.601 and BT.709): max |error| 0")
    return {"max_abs_err": float(err), "timed": timed}


def run_nvdec(dev, card: str, tmp: str) -> dict:
    """Phase 15: H.264 and VP9 input on the card's NVDEC through the port's
    entry points; returns the launch counts of the ``--input_video`` CLI
    run and the NV12 kernel's record."""
    import io

    from tecogan_tpu_torch.cli import main as cli_main
    from tecogan_tpu_torch.cli import serve as cli_serve
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data import video_nvdec
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.png import read_png, write_png
    from tecogan_tpu_torch.data.prepare import extract_scene
    from tecogan_tpu_torch.data.video_io import read_video_frames
    from tecogan_tpu_torch.kernels import nv12_to_rgb, resblock_chain, upsample4
    from tecogan_tpu_torch.ops.resize import resize_area
    from tecogan_tpu_torch.weights import params_to_npz, to_jax_params

    tn = nvdec_streams()
    root = os.path.join(tmp, "nvdec")
    os.makedirs(root)
    # (a) The binding, from the checkout's source, and NVDEC's capabilities.
    lib = video_nvdec.load_library()
    log(f"[nvdec] NVDEC binding built and loaded -> "
        f"{video_nvdec.library_path().relative_to(REPO)} (g++ "
        f"{' '.join(video_nvdec._CXXFLAGS)}); CUDA driver {lib.tvn_driver_version()}")
    refused = None  # NvdecUnavailable's message; any other failure raises
    for codec in ("h264", "vp9"):
        try:
            caps = video_nvdec.decoder_caps(codec, dev)
        except video_nvdec.NvdecUnavailable as exc:
            refused = str(exc)
            break
        log(f"[nvdec] cuvidGetDecoderCaps {codec} 8-bit 4:2:0: {caps}")
        if not caps["supported"]:
            raise RuntimeError(f"[nvdec] this card's NVDEC does not decode {codec} 8-bit 4:2:0")
    h264 = {name: tn.H264Stream(name) for name in tn.STREAMS}
    clip = tn.H264Stream("crop", frames=NVDEC_CLI_FRAMES)
    geo2 = tn.H264Stream("crop", h=VIDEO_GEO2[0], w=VIDEO_GEO2[1], frames=12)
    paths = {(n, c): st.write(os.path.join(root, f"{n}.{c}")) for n, st in h264.items()
             for c in ("mp4", "mkv")}
    seen = check_nvdec_format(dev, tn, h264, paths, refused is not None)
    log("[nvdec] NVDEC's parser through the port's reader reports the expected format of "
        + "; ".join(seen) + (f"; then every reader raised NvdecUnavailable: {refused}"
                             if refused else "; every frame decoded"))
    stand_in = None
    if refused:
        stand_in = tn.ModelNvdec([*h264.values(), clip, geo2])
        log("[nvdec] NVDEC DECODE NOT VERIFIED on this card: (b)-(f) below run the port's "
            "demuxer, readers, CLIs and NV12 kernel over ModelNvdec in NVDEC's place, which "
            "decodes nothing (it hands over the streams' numpy model); VP9 not decoded")
    mode = "stand-in" if stand_in else "NVDEC"
    with model_in_place_of_nvdec(stand_in) if stand_in else contextlib.nullcontext():
        # (b) Every stream, decoded bit-equal to the frames OpenCV gives.
        for (name, container), path in paths.items():
            got, fps = read_video_frames(path)
            want = h264[name].expected_rgb()
            if got.shape != want.shape or not np.array_equal(got, want) or fps != tn.FPS:
                raise RuntimeError(f"[nvdec] {name}.{container}: {got.shape} at {fps} fps "
                                   f"differs from the expected {want.shape}")
        log(f"[nvdec] ({mode}) H.264 streams {', '.join(h264)} in MP4 and MKV: every frame "
            "bit-equal to the model's (OpenCV's) frames"
            + (" (the model's own pictures through the NV12 kernel: not a decode)"
               if stand_in else ""))
        if stand_in is None:  # NVDEC's decode at two sizes, and VP9, which has no model
            for size, h, w, n in ((f"{LR_H}x{LR_W}", LR_H, LR_W, NVDEC_DECODE_FRAMES),
                                  ("720x1280", 720, 1280, NVDEC_720P_FRAMES)):
                st = tn.H264Stream("crop", h=h, w=w, frames=n)
                got, _ = read_video_frames(st.write(os.path.join(root, f"decode_{size}.mp4")))
                if got.shape[0] != n:
                    raise RuntimeError(f"[nvdec] {size}: {got.shape[0]} frames of {n}")
            want = tn.vp9_expected()
            got, fps = read_video_frames(str(tn.VP9_FIXTURE))
            if tn.frame_sha256(got) != want["frames"] or fps != want["fps"]:
                raise RuntimeError("[nvdec] the VP9 fixture's frames differ from OpenCV's")
            log(f"[nvdec] VP9 fixture ({got.shape[0]} frames {LR_H}x{LR_W}, libvpx with "
                "hidden alt-ref frames): every frame's SHA-256 equal to OpenCV's; card: "
                f"{card}")

        # (d) The inference CLI on the H.264 clip and on PNGs of its decode.
        decoded, _ = read_video_frames(clip.write(os.path.join(root, "clip.mp4")))
        png_dir = os.path.join(root, "clip_png")
        os.makedirs(png_dir)
        for i, f in enumerate(decoded):
            write_png(os.path.join(png_dir, f"{i:04d}.png"), f)
        npz = os.path.join(root, "params.npz")
        cfg = TecoConfig(num_resblock=NUM_RESBLOCK)
        gen_tree, fnet_tree = to_jax_params(*build_models(6, cfg))
        params_to_npz(npz, generator=gen_tree, fnet=fnet_tree)

        def cli(name, *extra):
            upsample4.launches = resblock_chain.launches = nv12_to_rgb.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                stats = cli_main.main(["--mode", "inference", "--output_dir",
                                       os.path.join(root, name), "--params_npz", npz, *extra])
            stats["launches"] = {"upsample4": upsample4.launches,
                                 "resblock_chain": resblock_chain.launches,
                                 "nv12_rgb": nv12_to_rgb.launches}
            return stats

        video_in = os.path.join(root, "clip.mp4")
        torch.backends.cudnn.deterministic = True
        try:
            from_video = cli("from_video", "--input_video", video_in)
            from_png = cli("from_png", "--input_dir_LR", png_dir)
        finally:
            torch.backends.cudnn.deterministic = False
        names = [f"output_{i:04d}.png" for i in range(NVDEC_CLI_FRAMES)]
        got = read_frames([os.path.join(root, "from_video", n) for n in names])
        want = read_frames([os.path.join(root, "from_png", n) for n in names])
        if got.shape != (NVDEC_CLI_FRAMES, 4 * LR_H, 4 * LR_W, 3) or not np.array_equal(got,
                                                                                      want):
            raise RuntimeError(f"[nvdec] --input_video and the PNG route differ: {got.shape}")
        launches = from_video["launches"]
        video_path_launches = {k: v for k, v in launches.items() if k != "nv12_rgb"}
        png_launches = {k: v for k, v in from_png["launches"].items() if k != "nv12_rgb"}
        if video_path_launches != png_launches or not all(video_path_launches.values()) \
                or launches["nv12_rgb"] != NVDEC_CLI_FRAMES or from_png["launches"]["nv12_rgb"]:
            raise RuntimeError(f"[nvdec] launches {launches} (H.264) vs {from_png['launches']} "
                               "(PNG)")
        log(f"[nvdec] ({mode}) cli.main --input_video clip.mp4 (H.264, {NVDEC_CLI_FRAMES} frames "
            f"{LR_H}x{LR_W}, {NUM_RESBLOCK} blocks, {cfg.compute_dtype}) bit-equal to the PNG "
            f"route on the same decoded frames under cuDNN's deterministic algorithms; "
            f"launches {launches} (PNG route: {from_png['launches']}); card: {card}")

        # (e) cli.serve on two geometries: H.264 at 120x180 beside the VP9
        # fixture at 144x180 (the stand-in: beside H.264 at 144x180).
        street = geo2.write(os.path.join(root, "street.mkv"))
        sources = ([clip.write(os.path.join(root, "serve_clip.mp4")), street] if stand_in
                   else [street, str(tn.VP9_FIXTURE)])
        with contextlib.redirect_stdout(io.StringIO()):
            stats = cli_serve.main(["--input_dirs", ",".join(sources), "--output_dir",
                                    os.path.join(root, "served"), "--params_npz", npz,
                                    "--output_videos", "--max_streams", "2"])
        served = {}
        for src in sources:
            frames, fps = read_video_frames(src)
            name = Path(src).stem
            hr, hr_fps = read_video_frames(os.path.join(root, "served", f"{name}.mp4"))
            served[name] = (frames.shape, fps)
            if hr.shape != (frames.shape[0], 4 * frames.shape[1], 4 * frames.shape[2], 3) \
                    or hr_fps != fps:
                raise RuntimeError(f"[nvdec] cli.serve {name}: {hr.shape} at {hr_fps} fps from "
                                   f"{frames.shape} at {fps}")
        if stats["written"] != {k: v[0][0] for k, v in served.items()}:
            raise RuntimeError(f"[nvdec] cli.serve wrote {stats['written']}")
        log(f"[nvdec] ({mode}) cli.serve --output_videos on "
            + ", ".join(f"{n} ({s[1]}x{s[2]}, {s[0]} frames, {f} fps)"
                        for n, (s, f) in served.items())
            + f": wrote {stats['written']}, each .mp4 4x at its source's fps; card: {card}")

        # (f) extract_scene from inside a GOP with B-frames: the exact frames.
        b_frames = h264["b_main"].expected_rgb()
        for container in ("mp4", "mkv"):
            out = os.path.join(root, f"scene_{container}")
            n = extract_scene(paths[("b_main", container)], 5, out, duration=10)
            for i in range(n):
                if not np.array_equal(read_png(os.path.join(out, f"col_high_{i:04d}.png")),
                                      resize_area(b_frames[5 + i], 0.5)):
                    raise RuntimeError(f"[nvdec] extract_scene b_main.{container} frame "
                                       f"{5 + i} differs")
            if n != 10:
                raise RuntimeError(f"[nvdec] extract_scene b_main.{container} wrote {n}")
        log(f"[nvdec] ({mode}) extract_scene from frame 5 of b_main.mp4 and .mkv (decode order "
            "0 3 1 2 6 4 5 8 7 | 9 ...: B-frames, key frames 0 and 9): frames 5-14, the exact "
            "ones in display order")
    kernel = check_nv12_kernel(dev, card)
    return {"launches": launches, "nv12": kernel, "mode": mode, "refused": refused}


ORBAX_FIXTURE = REPO / "tests" / "data" / "jax_orbax_small"
ORBAX_SHA256 = REPO / "tests" / "data" / "jax_orbax_small.sha256.json"
ORBAX_STEPS = 3  # captured TecoGAN steps before the full-width checkpoint


def _flat_leaves(tree, path=()):
    """(path tuple, numpy leaf) of a read checkpoint tree; None dropped,
    bfloat16 tensors as their uint16 bits."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat_leaves(v, path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat_leaves(v, path + (str(i),))]
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        tree = (tree.view(torch.uint16) if tree.dtype == torch.bfloat16 else tree).numpy()
    return [(path, np.ascontiguousarray(tree))]


def run_orbax(dev, card: str, tmp: str) -> dict:
    """Phase 16: the JAX package's orbax checkpoints without JAX. (a) The
    committed JAX-written fixture (OCDBT, zstd nodes and chunks, inline and
    indirect values, the ``ocdbt.process_0`` sub-store) read by the port:
    every leaf equal to its recorded SHA-256. (b) A TECOGAN_PRESET
    TrainState (16 blocks, 64 channels, full FNet, float32) after a few
    captured steps, written by ``save_jax_checkpoint`` and restored into a
    fresh state bit-equal. (c) ``cli.main --checkpoint`` on that directory and on the
    port's ``state.pt`` of the same weights, over phase 9's PNG dir,
    bfloat16: byte-equal PNGs; K1 and the chain counted in the first run.
    Returns the launches."""
    import hashlib
    import io
    import shutil

    from tecogan_tpu_torch.cli import main as cli_main
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.checkpoint import (
        restore_checkpoint, save_checkpoint, save_jax_checkpoint)
    from tecogan_tpu_torch.train.orbax_io import OcdbtReader, read_jax_checkpoint
    from tecogan_tpu_torch.utils import zstd
    from tecogan_tpu_torch.weights import train_state_to_jax

    # (a) The fixture, against its recorded hashes.
    want = json.loads(ORBAX_SHA256.read_text())
    step_dir = ORBAX_FIXTURE / str(want["step"])
    zstd.load_library()  # g++ builds csrc/tecozstd.cpp on first use
    leaves = _flat_leaves(read_jax_checkpoint(str(step_dir)))
    got = {"/".join(p): hashlib.sha256(a.tobytes()).hexdigest() for p, a in leaves}
    if got != {k: v["sha256"] for k, v in want["leaves"].items()}:
        bad = sorted(k for k in set(got) | set(want["leaves"])
                     if got.get(k) != want["leaves"].get(k, {}).get("sha256"))
        raise RuntimeError(f"[orbax] fixture leaves differ from their SHA-256: {bad}")
    reader = OcdbtReader(str(step_dir / "default"))
    log(f"[orbax] (a) fixture {step_dir.relative_to(REPO)} (JAX-written OCDBT store, "
        f"{len(reader.keys())} keys of which "
        f"{sum(not isinstance(v, bytes) for v in reader._values.values())} indirect): "
        f"{len(leaves)} leaves equal to their SHA-256; card: {card}")

    # (b) A full-width TecoGAN state after captured steps, round trip.
    cfg = TECOGAN_PRESET.replace(batch_size=1, rnn_n=3)
    trainer = Trainer(cfg, dev, vgg=random_vgg19(cfg.rand_seed))
    state = trainer.init_state(cfg.rand_seed)
    rng = np.random.RandomState(16)
    for _ in range(ORBAX_STEPS):
        batch = (rng.rand(1, cfg.rnn_n, cfg.hr_load_size, cfg.hr_load_size, 3)
                 * 255).astype(np.uint8)
        state, _ = trainer.train_step(state, batch)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    if trainer.capture != (dev.type == "cuda") or state.step != ORBAX_STEPS:
        raise RuntimeError(f"[orbax] the steps were not captured ({trainer.capture}) or "
                           f"reached step {state.step}")
    before = train_state_to_jax(state)
    adam = before["gen_opt"][0]
    if int(adam["count"]) != ORBAX_STEPS or not all(
            np.abs(v).max() > 0 for v in adam["mu"][f"resblock_{cfg.num_resblock}_conv_2"].values()):
        raise RuntimeError("[orbax] the Adam moments or count are still fresh")
    jax_dir, port_dir = os.path.join(tmp, "orbax_jax"), os.path.join(tmp, "orbax_port")
    save_jax_checkpoint(jax_dir, state)
    fresh = Trainer(cfg, dev, vgg=random_vgg19(cfg.rand_seed)).init_state(cfg.rand_seed + 1)
    restore_checkpoint(jax_dir, fresh)
    sync()
    after = _flat_leaves(train_state_to_jax(fresh))
    flat_before = dict(_flat_leaves(before))
    if {p for p, _ in after} != set(flat_before) or not all(
            a.dtype == flat_before[p].dtype and np.array_equal(a, flat_before[p])
            for p, a in after) or int(fresh.device_step) != ORBAX_STEPS:
        raise RuntimeError("[orbax] the full-width round trip is not bit-equal")
    n_elems = sum(a.size for a in flat_before.values())
    log(f"[orbax] (b) TECOGAN_PRESET TrainState ({cfg.num_resblock} blocks, "
        f"{cfg.gen_channels} channels, full FNet, float32; {len(flat_before)} leaves, "
        f"{n_elems} elements) after {ORBAX_STEPS} captured steps: save_jax_checkpoint (plain "
        f"zarr layout), restore_checkpoint into a fresh state on the card: every leaf "
        f"bit-equal, Adam moments and counts, D's statistics, EMAs and gate counters "
        f"included; card: {card}")
    save_checkpoint(port_dir, state)
    del trainer, state, fresh
    torch.cuda.empty_cache()

    # (c) The inference CLI from either layout, byte-equal, counted.
    hr_dir = os.path.join(tmp, "cli_hr")
    argv = ["--mode", "inference", "--input_dir_HR", hr_dir, "--device", str(dev),
            "--compute_dtype", "bfloat16", "--infer_chunk", str(CHUNK)]
    outs, prints = [], []
    torch.backends.cudnn.deterministic = True
    try:
        for i, ckpt in enumerate((jax_dir, port_dir)):
            out = os.path.join(tmp, f"orbax_cli{i}")
            printed = io.StringIO()
            if i == 0:
                upsample4.launches = 0
                resblock_chain.launches = 0
            with contextlib.redirect_stdout(printed):
                stats = cli_main.main(argv + ["--output_dir", out, "--checkpoint", ckpt])
            if i == 0:
                launches = {"upsample4": upsample4.launches,
                            "resblock_chain": resblock_chain.launches}
            names = sorted(f for f in os.listdir(out) if f.endswith(".png"))
            outs.append(read_frames([os.path.join(out, n) for n in names]))
            prints.append(printed.getvalue())
            log(f"[orbax] (c) cli.main --checkpoint {os.path.basename(ckpt)} "
                f"({'JAX layout' if i == 0 else 'state.pt'}): {stats['written']} HR PNGs "
                f"{outs[-1].shape[1:3]}")
    finally:
        torch.backends.cudnn.deterministic = False
    if outs[0].shape != (CLI_FRAMES, 4 * LR_H, 4 * LR_W, 3) or not np.array_equal(*outs):
        raise RuntimeError(f"[orbax] the CLI's PNGs from the two layouts differ "
                           f"({outs[0].shape}, {outs[1].shape})")
    if outs[0].min() == outs[0].max():
        raise RuntimeError("[orbax] the CLI's output is constant")
    for text in prints:
        if f"Loaded checkpoint step {ORBAX_STEPS} from" not in text:
            raise RuntimeError(f"[orbax] the CLI did not load step {ORBAX_STEPS}")
    ran = FRAMES + CHUNK
    need = {"upsample4": ran + ran // CHUNK, "resblock_chain": cfg.num_resblock * ran}
    if launches != need:
        raise RuntimeError(f"[orbax] the CLI launched {launches}, want {need}")
    log(f"[orbax] (c) {CLI_FRAMES} PNGs byte-equal between the JAX-layout and the state.pt "
        f"checkpoints (cuDNN deterministic); launches in the JAX-layout run {launches} "
        f"(the run's {FRAMES} frames and the capture's warm-up chunk of {CHUNK}), bfloat16 "
        f"chain and K1 (flow and skip); card: {card}")
    for d in (jax_dir, port_dir, os.path.join(tmp, "orbax_cli0"), os.path.join(tmp, "orbax_cli1")):
        shutil.rmtree(d, ignore_errors=True)
    return {"launches": launches}


# ---------------------------------------------------------------- phase 17
# Parallelism on one card (tecogan_tpu_torch/parallel): the mesh names
# cuda:0 twice, so every sharded path runs at its real shard shapes with the
# real kernels and halo logic; two shards or two stages on one card say
# nothing about scaling. Peer copies and NCCL at world size > 1 need two
# cards.
PAR_FRAMES, PAR_CHUNK, PAR_SHARDS, PAR_SLOTS = 8, 4, 2, 4
# Phase 17 (c): the two ranks' step against one process on their
# concatenated batch (losses, gradients, D's statistics), phase 7's
# tolerance, relative to each tensor's scale.
PAR_STEP_TOL = STEP_GRAD_TOL
# Launches a run, step or tick on each parallel path, by kernel, for the
# kernels line.
PARALLEL = {}


def _launch_counts():
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd

    return {"resblock_chain": resblock_chain.launches, "upsample4": upsample4.launches,
            "upsample4_bwd": upsample4_bwd.launches}


def _zero_counts() -> None:
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4, upsample4_bwd

    resblock_chain.launches = upsample4.launches = upsample4_bwd.launches = 0


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` and cuDNN's deterministic
    algorithms, TF32 off, restored after."""
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
        torch.backends.cudnn.allow_tf32 = flags[2]


def _run_each(srs: dict, frames):
    """A warm-up run of each engine in ``srs`` (a captured one captures
    there), then one more run of each: per engine its output, the launches
    of that run, and the graphs it captured."""
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    rec = {}
    for name, sr in srs.items():
        captures = CapturedProgram.captures
        sr.run(frames)
        rec[name] = dict(sr=sr, captures=CapturedProgram.captures - captures)
    captures = CapturedProgram.captures
    for name, sr in srs.items():
        _zero_counts()
        out, _ = sr.run(frames)
        rec[name].update(out=out, launches=_launch_counts())
    if CapturedProgram.captures != captures:
        raise RuntimeError("[par] a second run captured a graph: the chunk shape's program "
                           "was not kept")
    return rec


def spatial_teacher_forced(dev, cfg, models, frames: np.ndarray, devices) -> int:
    """Each frame's sharded frame step (FNet, the flow upsample, the warp
    and the generator over row shards, ``ShardedStep.frame_step``) from the
    unsharded run's state, against the unsharded frame step: the largest
    uint8 difference over the frames. Unlike two free-running streams,
    whose states drift apart once cuDNN rounds one convolution otherwise
    at the shards' shapes, every frame is held on its own."""
    from tecogan_tpu_torch.parallel.spatial import ShardedState, ShardedStep, gather_rows
    from tecogan_tpu_torch.recurrent.inference import as_output, place_models
    from tecogan_tpu_torch.recurrent.step import frame_step, init_state

    gen, fnet = place_models(*models, dev, cfg.torch_dtype)
    step = ShardedStep(gen, fnet, devices, max_displacement=4.0 * cfg.flow_max_velocity)
    h, w = frames.shape[1:3]
    state, worst = init_state(1, h, w, cfg.torch_dtype, dev), 0
    with torch.inference_mode():
        for frame in frames:
            lr = (torch.from_numpy(frame[None]).to(dev).float() / 255.0).to(cfg.torch_dtype)
            sharded = ShardedState(step.split(state.prev_lr), step.split(state.prev_hr, 4))
            _, hr_s = step.frame_step(sharded, step.split(lr))
            state, hr = frame_step(gen, fnet, state, lr)
            diff = (as_output(gather_rows(hr_s, dev), "uint8").int()
                    - as_output(hr, "uint8").int())
            worst = max(worst, int(diff.abs().max()))
    return worst


def run_spatial(dev, card: str) -> None:
    """Phase 17 (a): ``StreamingSR`` on a 2-shard mesh ``[cuda:0, cuda:0]``
    at LR 144x180, full width, captured (one graph a chunk shape) and
    eager, against each other (bit-equal, the same launches) and
    the unsharded run; the halo warp bit-equal to the unsharded warp at the
    path's HR shape."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.ops.warp import warp_space_to_depth, warp_space_to_depth_halo
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.parallel.spatial import shard_rows
    from tecogan_tpu_torch.recurrent import StreamingSR

    mesh = make_mesh({"space": PAR_SHARDS}, [dev] * PAR_SHARDS)
    gen = torch.Generator().manual_seed(171)
    image = torch.rand((1, 4 * LR_H, 4 * LR_W, 3), generator=gen)
    flow = (torch.rand((1, 4 * LR_H, 4 * LR_W, 2), generator=gen) * 2 - 1) * 96.0
    for dtype in (torch.float32, torch.bfloat16):
        img, fl = image.to(dev, dtype), flow.to(dev, dtype)
        want = warp_space_to_depth(img, fl, 4)
        got = warp_space_to_depth_halo(img, fl, mesh, "space", 4, max_displacement=96.0)
        if not torch.equal(got, want):
            raise RuntimeError(f"[par] the {dtype} halo warp differs from the unsharded warp")
    log(f"[par] (a) halo warp, {PAR_SHARDS} shards of {4 * LR_H // PAR_SHARDS} HR rows on "
        f"{dev} twice, halo 97 rows, |flow| <= 96: float32 and bfloat16 bit-equal to the "
        f"unsharded warp at {4 * LR_H}x{4 * LR_W}")
    frames = (np.random.RandomState(172).rand(PAR_FRAMES, LR_H, LR_W, 3) * 255).astype(np.uint8)
    chunks = -(-PAR_FRAMES // PAR_CHUNK)
    for dtype, output in (("float32", "float32"), ("bfloat16", "uint8")):
        cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype=dtype, infer_chunk=PAR_CHUNK)
        with deterministic():
            srs = {name: StreamingSR(cfg, *build_models(173, cfg), output=output, device=dev,
                                     capture=capture, spatial_mesh=m)
                   for name, capture, m in (("unsharded", False, None),
                                            ("sharded", False, mesh),
                                            ("captured sharded", None, mesh),
                                            ("captured unsharded", None, None))}
            runs = _run_each(srs, frames)
            forced = spatial_teacher_forced(dev, cfg, build_models(173, cfg), frames,
                                            [dev] * PAR_SHARDS)
        a, b = runs["sharded"]["out"], runs["unsharded"]["out"]
        if a.shape != (PAR_FRAMES, 4 * LR_H, 4 * LR_W, 3) or a.shape != b.shape:
            raise RuntimeError(f"[par] (a) {dtype}: shapes {a.shape} {b.shape}")
        if output == "uint8":
            # bfloat16: cuDNN may round a convolution otherwise at the
            # shards' shapes (FNet over a chunk's 4 pairs), and random
            # weights carry that through the recurrence, so the free-running
            # streams are printed; the first frame (zero state) and every
            # frame's step on its own (``forced``) are held to 1 level.
            diff = np.abs(a.astype(np.int16) - b)
            first = int(diff[0].max())
            ok = first <= 1 and forced <= 1
            what = (f"free-running uint8 max |diff| {int(diff.max())} level(s) on "
                    f"{(diff != 0).mean():.2e} of the values (printed, not held), the first "
                    f"frame {first}, each frame's sharded step from the unsharded state "
                    f"{forced}, tol 1 level")
        else:
            err, rel = rel_err(torch.from_numpy(a), torch.from_numpy(b))
            ok = rel <= PATH_TOL and forced <= 1
            what = (f"float max_abs_err={err:.3e} rel={rel:.3e} tol={PATH_TOL:.0e}; each "
                    f"frame's sharded step from the unsharded state within {forced} uint8 "
                    f"level(s), tol 1")
        cap = runs["captured sharded"]
        same = np.array_equal(cap["out"], a)
        step, cap_step = runs["sharded"]["sr"].step, cap["sr"].step
        need = {"resblock_chain": NUM_RESBLOCK * PAR_SHARDS * PAR_FRAMES,
                "upsample4": PAR_SHARDS * (PAR_FRAMES + chunks), "upsample4_bwd": 0}
        got = runs["sharded"]["launches"]
        pool = sum(c.run.pool_bytes() for c in cap["sr"]._chunks.values())
        log(f"[par] (a) spatial streaming {dtype} -> {output}, {PAR_FRAMES} frames "
            f"{LR_H}x{LR_W} -> {4 * LR_H}x{4 * LR_W}, {NUM_RESBLOCK} resblocks, chunk "
            f"{PAR_CHUNK}, {PAR_SHARDS} shards of {shard_rows(LR_H, PAR_SHARDS)} LR rows on {dev} "
            f"twice, halo depth k={step.chain_blocks} blocks a chain call "
            f"({2 * step.chain_blocks}-row halo), halo warps {step.halo_warps}, gathered "
            f"warps {step.gather_warps} in 2 eager runs: sharded vs unsharded "
            f"{what}; launches a run sharded {got} (a frame: chain "
            f"{got['resblock_chain'] / PAR_FRAMES:g}, K1 {got['upsample4'] / PAR_FRAMES:g}), "
            f"unsharded {runs['unsharded']['launches']}; card: {card}")
        log(f"[par] (a) spatial streaming {dtype}, captured sharded ({cap['sr'].route}; "
            f"{cap['captures']} capture(s) in 2 runs): "
            f"{'bit-equal to' if same else 'DIFFERS from'} the eager sharded run, launches a "
            f"run {cap['launches']}; card: {card}")
        if not ok:
            raise RuntimeError(f"[par] (a) {dtype}: sharded differs from unsharded: {what}")
        if got != need or step.halo_warps != 2 * PAR_FRAMES or step.gather_warps:
            raise RuntimeError(f"[par] (a) {dtype}: launches {got}, want {need}; halo warps "
                               f"{step.halo_warps}, gathered {step.gather_warps}")
        # The captured engine traces the warp twice (the capture's warm-up and
        # the capture) for its one chunk shape; a replay adds no trace.
        if (not same or cap["launches"] != need or cap["captures"] != 1 or not pool > 0
                or cap_step.halo_warps != 2 * PAR_CHUNK or cap_step.gather_warps
                or not cap["sr"].route.startswith("captured")):
            raise RuntimeError(f"[par] (a) {dtype}: captured sharded: bit-equal {same}, "
                               f"launches {cap['launches']} (want {need}), captures "
                               f"{cap['captures']} (want 1), pool {pool} bytes, halo warps "
                               f"{cap_step.halo_warps} (want {2 * PAR_CHUNK}), route "
                               f"{cap['sr'].route!r}")
        PARALLEL[f"spatial_{dtype}_run"] = got
        PARALLEL[f"spatial_{dtype}_captured_run"] = cap["launches"]


def run_pipeline(dev, card: str) -> None:
    """Phase 17 (b): ``PipelinedStreamingSR`` with both stages on
    ``cuda:0`` (two streams), each stage a captured graph, against a
    captured ``StreamingSR``, and both eager: bfloat16 from uint8
    frames, and float32 from float32 frames in chunks of 2 (stage F's
    frames are then its input buffer, which the next chunk's upload
    overwrites once stage R has copied them in)."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import PipelinedStreamingSR
    from tecogan_tpu_torch.recurrent import StreamingSR

    rng = np.random.RandomState(174)
    for dtype, chunk, frames, output in (
            ("bfloat16", PAR_CHUNK,
             (rng.rand(PAR_FRAMES, LR_H, LR_W, 3) * 255).astype(np.uint8), "uint8"),
            ("float32", PAR_CHUNK // 2,
             rng.rand(PAR_FRAMES, LR_H, LR_W, 3).astype(np.float32), "float32")):
        cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype=dtype, infer_chunk=chunk)
        with deterministic():
            srs = {"captured pipeline": PipelinedStreamingSR(
                       cfg, *build_models(175, cfg), output=output, flow_device=dev,
                       recurrent_device=dev),
                   "captured StreamingSR": StreamingSR(cfg, *build_models(175, cfg),
                                                       output=output, device=dev),
                   "eager pipeline": PipelinedStreamingSR(
                       cfg, *build_models(175, cfg), output=output, flow_device=dev,
                       recurrent_device=dev, capture=False),
                   "eager StreamingSR": StreamingSR(cfg, *build_models(175, cfg),
                                                    output=output, device=dev, capture=False)}
            runs = _run_each(srs, frames)
        want = runs["captured StreamingSR"]
        chunks = -(-PAR_FRAMES // chunk)
        need = {"resblock_chain": NUM_RESBLOCK * PAR_FRAMES, "upsample4": PAR_FRAMES + chunks,
                "upsample4_bwd": 0}
        cap = runs["captured pipeline"]
        (stages,) = cap["sr"]._stages.values()
        pools = stages.pool_bytes()
        same = {name: np.array_equal(r["out"], want["out"]) for name, r in runs.items()}
        log(f"[par] (b) pipeline, flow and recurrent stages on {dev} (two streams), {dtype} "
            f"from {frames.dtype} frames -> {output}, {PAR_FRAMES} frames {LR_H}x{LR_W}, chunk "
            f"{chunk}, cuDNN deterministic: bit-equal to the captured StreamingSR: "
            + ", ".join(f"{name} {ok}" for name, ok in same.items())
            + "; launches a run " + ", ".join(f"{name} {r['launches']}"
                                             for name, r in runs.items())
            + f"; captured pipeline ({cap['sr'].route}): {cap['captures']} captures for its "
            f"chunk shape; card: {card}")
        if (not all(same.values()) or any(r["launches"] != need for r in runs.values())
                or cap["captures"] != 2 or not all(p > 0 for p in pools)):
            raise RuntimeError(f"[par] (b) {dtype}: the pipeline differs from StreamingSR: "
                               f"bit-equal {same}, launches want {need}, captures "
                               f"{cap['captures']} (want 2), pools {pools}")
        suffix = "" if dtype == "bfloat16" else "_f32"
        PARALLEL[f"pipeline{suffix}_run"] = runs["eager pipeline"]["launches"]
        PARALLEL[f"pipeline{suffix}_captured_run"] = cap["launches"]


def _dp_configs():
    """Phase 17 (c)'s steps: FRVSR (phase 7's) and TecoGAN (phase 10's
    widths) at a global batch of 2, with random VGG19 weights."""
    from tecogan_tpu_torch.config import FRVSR_PRESET, TECOGAN_PRESET

    return {"frvsr": FRVSR_PRESET.replace(batch_size=2, rnn_n=4),
            "tecogan": TECOGAN_PRESET.replace(batch_size=2, rnn_n=3)}


def _dp_step(trainer, state, batch):
    """One counted step: (metrics, launches)."""
    _zero_counts()
    _, metrics = trainer.train_step(state, batch)
    return {k: float(v) for k, v in metrics.items()}, _launch_counts()


def _dp_state(trainer, state):
    """Gradients and D's running statistics after a step, on the host."""
    out = {}
    for prefix in ("generator", "fnet", "discriminator"):
        module = getattr(state, prefix)
        if module is None:
            continue
        for name, p in module.named_parameters():
            out[f"grad.{prefix}.{name}"] = p.grad.detach().float().cpu()
        if prefix == "discriminator":
            for name, b in module.named_buffers():
                out[f"stats.{name}"] = b.detach().float().cpu()
    return out


def dp_worker(port: str, rank: str, out_path: str) -> None:
    """One rank of phase 17 (c)'s world size 2 over gloo (``chip_smoke.py
    --dp-worker PORT RANK OUT``): each preset's first step, eager, on this
    rank's half of the global batch; its metrics, gradients, D statistics
    and launches saved to OUT."""
    sys.path.insert(0, str(REPO))
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.parallel import DataParallelTrainer, init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, int(rank), backend="gloo")
    dev = torch.device("cuda", 0)
    results = {}
    for preset, cfg in _dp_configs().items():
        trainer = DataParallelTrainer(cfg, dev, vgg=random_vgg19(7) if cfg.gan else None,
                                      capture=False)
        state = trainer.init_state(12)
        fix_flows_mid_cell(state)
        batch = trainer.put_batch(frvsr_batch(cfg, cfg.batch_size, 176))
        metrics, launches = _dp_step(trainer, state, batch)
        results[preset] = dict(metrics=metrics, launches=launches,
                               tensors=_dp_state(trainer, state))
    torch.save(results, out_path)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_data_parallel(dev, card: str, tmp: str) -> None:
    """Phase 17 (c): ``DataParallelTrainer`` at world size 1 over NCCL,
    captured, bit-equal to the plain ``Trainer`` (FRVSR and TecoGAN, two
    steps, every state tensor); then world size 2 over gloo in two
    processes on this card, eager, against one process on the
    concatenated batch."""
    import torch.distributed as dist

    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.parallel import DataParallelTrainer, init_distributed
    from tecogan_tpu_torch.train import Trainer
    from tecogan_tpu_torch.train.trainer import named_state_tensors

    configs = _dp_configs()
    if init_distributed(f"localhost:{_free_port()}", 1, 0, backend="nccl") != 1:
        raise RuntimeError("[par] (c) the NCCL group is not of size 1")
    try:
        for preset, cfg in configs.items():
            batches = [frvsr_batch(cfg, cfg.batch_size, 177 + i) for i in range(2)]
            finals, log_steps = {}, {}
            with deterministic():
                for name, cls in (("Trainer", Trainer), ("DataParallelTrainer", DataParallelTrainer)):
                    trainer = cls(cfg, dev, vgg=random_vgg19(7) if cfg.gan else None)
                    state = trainer.init_state(12)
                    fix_flows_mid_cell(state)
                    steps = [_dp_step(trainer, state, b) for b in batches]
                    finals[name] = ([s[0] for s in steps],
                                    [(n, t.detach().clone()) for n, t in named_state_tensors(state)])
                    log_steps[name] = (trainer.capture, steps)
                    del trainer, state
            (m_a, s_a), (m_b, s_b) = finals["Trainer"], finals["DataParallelTrainer"]
            differ = [n for (n, a), (_, b) in zip(s_a, s_b) if not torch.equal(a, b)]
            captured, steps = log_steps["DataParallelTrainer"]
            log(f"[par] (c) {preset} DataParallelTrainer at world size 1 over NCCL "
                f"({'captured' if captured else 'eager'}), {cfg.num_resblock} resblocks, batch "
                f"{cfg.batch_size}, {cfg.rnn_n} frames, crop {cfg.crop_size}, 2 steps vs the plain "
                f"Trainer under deterministic algorithms: metrics "
                f"{'bit-equal' if m_a == m_b else 'DIFFER'}, {len(s_a) - len(differ)} of "
                f"{len(s_a)} state tensors bit-equal; launches a step {steps[1][1]} (first: "
                f"warm-up, capture, replay {steps[0][1]}); card: {card}")
            if m_a != m_b or differ or not captured:
                raise RuntimeError(f"[par] (c) {preset} world size 1: metrics equal "
                                   f"{m_a == m_b}, differing state {differ[:5]}, captured "
                                   f"{captured}")
            PARALLEL[f"dp_{preset}_world1_step"] = steps[1][1]
    finally:
        dist.destroy_process_group()

    port = str(_free_port())
    paths = [os.path.join(tmp, f"dp_rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker", port,
                               str(r), paths[r]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"[par] (c) gloo rank {r} failed (rc {p.returncode}):\n{out[-3000:]}")
    ranks = [torch.load(path) for path in paths]
    with deterministic():
        for preset, cfg in configs.items():
            trainer = Trainer(cfg, dev, vgg=random_vgg19(7) if cfg.gan else None, capture=False)
            state = trainer.init_state(12)
            fix_flows_mid_cell(state)
            metrics, launches = _dp_step(trainer, state, frvsr_batch(cfg, cfg.batch_size, 176))
            want = _dp_state(trainer, state)
            got = ranks[0][preset]
            if got["metrics"] != ranks[1][preset]["metrics"]:
                raise RuntimeError(f"[par] (c) {preset}: the ranks' metrics differ")
            worst, worst_name = 0.0, ""
            for k, v in want.items():
                scale = max(v.abs().max().item(), 1e-30)
                rel = (got["tensors"][k] - v).abs().max().item() / scale
                if rel > worst:
                    worst, worst_name = rel, k
            loss_worst = max(
                abs(got["metrics"][k] - v) / max(abs(metrics["t_adversarial_loss"]
                                                     if k == "t_balance" else v), 1e-30)
                for k, v in metrics.items() if k != "learning_rate")
            rank_launches = [r[preset]["launches"] for r in ranks]
            log(f"[par] (c) {preset} world size 2 over gloo, two processes on {dev}, eager, "
                f"batch {cfg.batch_size // 2} a rank, against one process on the batch of "
                f"{cfg.batch_size}: the ranks' metrics identical; losses worst rel "
                f"{loss_worst:.3e}, gradients and D statistics worst rel {worst:.3e} "
                f"({worst_name}), tol {PAR_STEP_TOL:.0e}; launches a step a rank "
                f"{rank_launches[0]}, one process {launches}; card: {card}")
            if worst > PAR_STEP_TOL or loss_worst > PAR_STEP_TOL:
                raise RuntimeError(f"[par] (c) {preset}: world size 2 differs from one process")
            if rank_launches[0] != launches or rank_launches[1] != launches:
                raise RuntimeError(f"[par] (c) {preset}: launches {rank_launches} vs {launches}")
            PARALLEL[f"dp_{preset}_world2_step_per_rank"] = rank_launches[0]


def run_slot_pool(dev, card: str) -> None:
    """Phase 17 (d): ``VSRServer`` with a 2-device mesh ``[cuda:0,
    cuda:0]`` and 4 slots, captured: every tick bit-equal to two unsharded
    2-slot pools serving the same streams (each device's batch), and its
    first tick (the zero state) to the unsharded 4-slot pool's. Later
    ticks of the 4-slot pool drift from the 2-slot ones by cuDNN's choice
    of algorithm by batch size (FNet's bfloat16 flows of a batch of 4 and
    2 differ by one ulp, which random weights amplify through the
    recurrence): printed, not held."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16")
    mesh = make_mesh({cfg.dp_axis: 2}, [dev, dev])
    rng = np.random.RandomState(178)
    clips = {f"s{k}": (rng.rand(PAR_FRAMES, LR_H, LR_W, 3) * 255).astype(np.uint8)
             for k in range(PAR_SLOTS)}
    halves = [list(clips)[:PAR_SLOTS // 2], list(clips)[PAR_SLOTS // 2:]]
    outs, launches = {}, {}
    with deterministic():
        for name, m, groups in (("4-slot", None, [list(clips)]), ("mesh", mesh, [list(clips)]),
                                ("2-slot", None, halves)):
            servers = []
            for group in groups:
                srv = VSRServer(cfg, *build_models(179, cfg), LR_H, LR_W,
                                max_streams=len(group), mesh=m, device=dev)
                for sid in group:
                    srv.open(sid)
                srv.prewarm()
                servers.append((srv, group))
            ticks = []
            _zero_counts()
            for t in range(PAR_FRAMES):
                tick = {}
                for srv, group in servers:
                    tick.update(srv.step({sid: clips[sid][t] for sid in group}))
                ticks.append(tick)
            launches[name] = {k: v / PAR_FRAMES for k, v in _launch_counts().items()}
            outs[name] = ticks

    def diff(a, b):
        return [int(np.abs(x[sid].astype(np.int16) - y[sid]).max()) for x, y in zip(a, b)
                for sid in clips]

    per_device, wide = diff(outs["mesh"], outs["2-slot"]), diff(outs["mesh"], outs["4-slot"])
    first = wide[:PAR_SLOTS]
    log(f"[par] (d) VSRServer, {PAR_SLOTS} slots over a 2-device mesh on {dev} twice (2 slots "
        f"a device, each with its weights, state and captured tick), bfloat16, {LR_H}x{LR_W}, "
        f"{PAR_FRAMES} ticks of {PAR_SLOTS} streams, cuDNN deterministic: every tick "
        f"{'bit-equal to' if not any(per_device) else 'DIFFERS from'} two unsharded 2-slot "
        f"pools on the same streams; against the unsharded 4-slot pool the first tick max "
        f"|diff| {max(first)} level(s), the later ticks {max(wide[PAR_SLOTS:])} (cuDNN's "
        f"algorithms by batch size; random weights); launches a tick {launches['mesh']} "
        f"(4-slot {launches['4-slot']}); card: {card}")
    if any(per_device) or max(first) > 1:
        raise RuntimeError(f"[par] (d) the meshed pool differs: per device {max(per_device)}, "
                           f"first tick against 4 slots {max(first)} levels")
    want = {k: 2 * v for k, v in launches["4-slot"].items()}
    if launches["mesh"] != want or launches["2-slot"] != want:
        raise RuntimeError(f"[par] (d) launches a tick {launches['mesh']} and "
                           f"{launches['2-slot']}, want {want}")
    PARALLEL["slot_pool_tick"] = launches["mesh"]


def phase(name: str, fn, *args):
    """Run one phase; its seconds go to ``phase.seconds``."""
    t0 = time.perf_counter()
    result = fn(*args)
    phase.seconds[name] = time.perf_counter() - t0
    return result


phase.seconds = {}
START = time.perf_counter()


def main() -> None:
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 17 (c)
        return dp_worker(*sys.argv[2:5])
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
    _build.build_and_load(verbose=True)
    log(f"[build] kernels built and loaded -> {_build.library_path().relative_to(REPO)}")
    blocks = ctypes.c_int(0)
    _build.check(_build.library().tt_resblock_chain_bf16_blocks_per_sm(
        ctypes.byref(blocks)), "resblock_chain occupancy")
    log(f"[build] bfloat16 chain kernel: {blocks.value} resident CTA(s) per SM (the "
        f"persistent walk launches at most one a SM)")
    size, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().tt_resblock_chain_f32_clusters(
        ctypes.byref(size), ctypes.byref(clusters)), "resblock_chain clusters")
    log(f"[build] float32 chain kernel: clusters of {size.value} CTAs, {clusters.value} "
        f"clusters ({size.value * clusters.value} CTAs) resident at once "
        f"(cudaOccupancyMaxActiveClusters) on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    records = phase("3 kernels", check_kernels, dev)
    epilogue = phase("3c transposed convs' epilogue", check_epilogue, dev)
    warp_packs = phase("3d warp, pack and concat", check_warp_pack, dev)
    if "--kernels-only" in sys.argv[1:]:
        log("[main] --kernels-only: phases 1-3d done; no result line")
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
        train_launches, train_step_launches = phase(
            "8 FRVSR training", run_training, dev, card, tmp)
        bf16_step_launches = phase("8c bf16 FRVSR training", run_bf16_training, dev, card, tmp)
        # Phase 9 runs as a user's CLI does, with the same default flags.
        cli_launches = phase("9 CLI and suite", run_cli, dev, card, tmp,
                             os.path.join(tmp, "run", "checkpoints"))
        phase("9b codec parity", check_codec, tmp, card)
        gan_cpu_f32 = phase("10 TecoGAN step vs CPU", check_gan_step_vs_cpu, dev)  # TF32 off
        phase("10b bf16 TecoGAN step vs CPU", check_bf16_gan_step_vs_cpu, dev, gan_cpu_f32)
        # Phase 11 trains as a user does, with the default flags, on phase
        # 8's scenes and from its checkpoint; 11b in bfloat16 likewise.
        gan_launches = phase("11 TecoGAN training", run_tecogan_training, dev, card, tmp)
        bf16_gan_launches = phase("11b bf16 TecoGAN training", run_bf16_tecogan_training, dev,
                                  card, tmp)
        # Phase 12: serving. (a) and (d)'s comparison switch TF32 off inside.
        phase("12a server vs CPU", check_serving_vs_cpu, dev)
        serve_launches, serve_models = phase("12b serving", run_serving, dev, card)
        phase("12c export", check_export, dev, tmp, serve_models)
        phase("12d cli.serve", run_serve_cli, dev, card, tmp)
        phase("12e state budget", check_budget, dev, card, serve_models)
        phase("13 run cases", run_cases, card, tmp)
        video_launches = phase("14 video I/O", run_video, dev, card, tmp)
        nvdec = phase("15 H.264 and VP9 input", run_nvdec, dev, card, tmp)
        orbax = phase("16 orbax checkpoints", run_orbax, dev, card, tmp)
        phase("17a spatial streaming", run_spatial, dev, card)
        phase("17b pipeline", run_pipeline, dev, card)
        phase("17c data parallel", run_data_parallel, dev, card, tmp)
        phase("17d slot pool", run_slot_pool, dev, card)
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
        if key in ("upsample4", "resblock_chain"):
            # The inference CLI's --input_video run (phase 14), float32.
            entry["video_cli_launches"] = video_launches.get(key, 0)
            # The inference CLI from a JAX-layout checkpoint (phase 16 (c)).
            entry["orbax_cli_launches"] = orbax["launches"].get(key, 0)
            # Per generate replay after each save (phases 8, 8c, 11, 11b).
            entry["generate_launches"] = {k: g["launches"][key] for k, g in GENERATE.items()}
        # Phase 17: launches of this kernel's wrapper a run (spatial, 2
        # shards; pipeline), a step (data parallel, a rank) or a tick (the
        # 2-device slot pool) on the parallel paths.
        entry["parallel_launches"] = {p: n[key] for p, n in PARALLEL.items()}
        if key == "resblock_chain":
            entry["also_replaces"] = ["tecogan_tpu/kernels/resblocks.py:305",
                                      "tecogan_tpu/kernels/resblocks.py:466"]
        kernels.append(entry)
    # The NV12 kernel (phase 15): its launches in the --input_video CLI run
    # of the H.264 clip, its times at the clip's 144x180 surface.
    nv12_case = nvdec["nv12"]["timed"][0]
    kernels.append({
        "name": "nv12_rgb", "route": "cuda", "source": "tecogan_tpu_torch/csrc/nv12_rgb.cu",
        "replaces": "tecogan_tpu/data/video_io.py:61",
        "replaces_note": "no TPU kernel: cv2.VideoCapture.read's host conversion (swscale), "
                         "for the frames the card's NVDEC decodes",
        "launches": nvdec["launches"]["nv12_rgb"],
        "max_abs_err": nvdec["nv12"]["max_abs_err"], "ms": nv12_case["ms"],
        "plain_ms": nv12_case["plain_ms"], "bound_ms": nv12_case["bound_ms"],
        "bound_by": nv12_case["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call converts NV12 to RGB",
        "path": f"video input ({nvdec['mode']})", "dtype": "uint8",
        "nvdec_decode_verified": nvdec["refused"] is None,
        "decoder": ("NVDEC" if nvdec["refused"] is None else
                    "tests/nvdec_streams.py:ModelNvdec (decodes nothing) in place of NVDEC, "
                    "which refused: " + nvdec["refused"]),
        "cases": nvdec["nv12"]["timed"]})
    # The transposed convs' epilogue (phase 3c): its launches in phase 6's
    # streaming run (2 a frame), its times summed over each path's cases.
    def epilogue_sums(path):
        own = [r for r in epilogue if path in r["paths"]]
        return {k: sum(r[k] for r in own) for k in ("ms", "plain_ms", "two_pass_ms", "bound_ms")}

    kernels.append({
        "name": "bias_relu_crop", "route": "cuda",
        "source": "tecogan_tpu_torch/csrc/bias_relu_crop.cu", "replaces": None,
        "replaces_note": "no TPU kernel (XLA fuses the bias and ReLU into the transposed "
                         "conv): ATen's add_ of a cuDNN transposed conv's bias and F.relu of "
                         "its SAME crop",
        "launches": stream_launches.get("bias_relu_crop", 0), "max_abs_err": 0.0,
        **epilogue_sums("streaming"), "bound_by": "bytes", "library_ms": None,
        "library_note": "two_pass_ms: the add_ and F.relu it replaces",
        "path": "streaming", "dtype": "bfloat16",
        "by_cell": {p: epilogue_sums(p) for p in ("stream_2160p", "serve_1080p_live")},
        "cases": epilogue})
    # The recurrent step's input in one pass (phase 3d): its launches in
    # phase 6's streaming run (1 a frame) and a serving bucket tick (1).
    kernels.append({
        "name": "warp_pack", "route": "cuda", "source": "tecogan_tpu_torch/csrc/warp_pack.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel (XLA fuses the JAX package's gather, lerp, pack and "
                         "concat): ATen's warp_space_to_depth and torch.cat",
        "launches": stream_launches.get("warp_pack", 0),
        "serving_launches": serve_launches.get("warp_pack", 0), "max_abs_err": 0.0,
        **{k: sum(r[k] for r in warp_packs if "streaming" in r["paths"])
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "library_note": "plain_ms: the ATen route it replaces",
        "path": "streaming", "dtype": "bfloat16", "cases": warp_packs})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
