#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero):

1. versions, the card's name and power limit; no CUDA -> exit non-zero;
2. build the CUDA kernels from ``tecogan_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card (K1, K2 the
   upsample's adjoint, the chain), at the streaming and training paths'
   shapes and a ragged one, float32 (TF32 off) and bfloat16, with the
   error beside its tolerance and CUDA-event times (median and range of 5
   alternating windows); the bfloat16 chain also, one block at three
   shapes, against its own rounding points in float32 (8e-3);
4. autograd: the upsample (both filters) and the chain on the card against
   the same functions on the CPU, gradients of every input, float32;
5. the whole streaming path at full width (16 resblocks, 64 channels) on
   the GPU against the same seeded weights on the CPU (plain versions),
   float32, 6 frames of 64x96;
6. the streaming path at size: 46 uint8 frames of 144x180 -> 41 of
   576x720, bfloat16, chunks of 23, with the kernels' launch counts and
   frames/s; then a ``torch.profiler`` split of one run (chain / K1 /
   cuDNN / glue, device idle share), which must show the chain in the
   tensor-core kernel;
7. one FRVSR training step at full width (10 resblocks, real FNet),
   batch 2, 4 frames, crop 32, float32, GPU against CPU: losses and the
   gradient of every parameter;
8. the training path at size through ``train.loop.train``: FRVSR_PRESET
   (batch 4, crop 32, 10 frames, 10 resblocks) on synthetic PNG scenes,
   40 steps, then a resume to 45, with the kernels' launch counts,
   ms/step, frames/s and peak memory; then a ``torch.profiler`` split of
   one step. This phase runs with PyTorch's default precision flags (cuDNN
   in TF32), as the training CLI does; the comparisons before it with TF32
   off;
9. the inference CLI and the metrics suite at the main path's width: 41
   synthetic 576x720 HR PNGs -> ``cli.main --mode inference
   --input_dir_HR`` (blur and 4x subsample on the card, 5 warm-up frames
   prepended, bfloat16, 16 resblocks, chunks of 23) -> 41 HR PNGs, with
   the kernels' launch counts, byte-equal to ``StreamingSR.run`` on the
   same LR frames (both under cuDNN's deterministic algorithms; a second,
   timed CLI run keeps the default flags); the blur on the card against the CPU; a ``--checkpoint``
   run on phase 8's checkpoint (10 blocks: the depth NOTE); ``cli.metrics``
   on the 41 outputs against their HR frames (tOF by the torch Farneback
   on the card); and ``evaluate_folders`` with a seeded random LPIPS on the
   card against the CPU on 8 frames. Prints the split of the CLI's wall
   time and the suite's seconds per frame.

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

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
import torch
import torch.nn.functional as F

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
#   K2 sums up to 64 (bilinear) or 256 (bicubic) products per element where
#   the plain version runs two float32 matmuls: a few float32 ulps of O(10)
#   values; in bfloat16 both round after the H pass and at the end.
TOL = {("upsample4", torch.float32): 1e-6, ("upsample4", torch.bfloat16): 1e-2,
       ("upsample4_bwd", torch.float32): 1e-5,
       ("upsample4_bwd", torch.bfloat16): 1e-2,
       ("resblock_chain", torch.float32): 1e-4,
       ("resblock_chain", torch.bfloat16): 5e-2,
       ("resblock_chain_oracle", torch.bfloat16): 8e-3}
# Autograd, CUDA vs CPU, float32, max|diff| / max|CPU grad| per input: the
# upsample's gradient is K2 vs its plain version; the chain's is cuDNN vs
# the CPU's convolutions in another summation order, through 3 blocks.
GRAD_TOL = {"upsample4": 1e-5, "resblock_chain": 1e-4}
# One FRVSR step, GPU vs CPU, float32: loss scalars relative; each
# parameter's gradient as max|diff| / max|CPU grad|.
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3
# The training path: FRVSR_PRESET, synthetic "natural" scenes.
TRAIN_STEPS, RESUME_STEPS, SAVE_FREQ = 40, 45, 20
SCENE_FRAMES, SCENE_H, SCENE_W = 14, 240, 320
# Whole path, GPU kernels vs CPU plain versions, float32: the same tolerance
# as the chain (it dominates), relative to the output's scale.
PATH_TOL = 1e-3
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


def time_pair(fn, plain_fn, windows: int = 5, reps: int = 20, warm: int = 10):
    """CUDA-event ms per call of fn and of plain_fn, each as (median, min,
    max) over `windows` windows of `reps` calls, after `warm` calls of each;
    the windows alternate plain, kernel, kernel, plain, ..."""
    for f in (plain_fn, fn):
        for _ in range(warm):
            f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = ([], [])
    for i in range(windows):
        for k in ((1, 0) if i % 2 == 0 else (0, 1)):
            f = (fn, plain_fn)[k]
            start.record()
            for _ in range(reps):
                f()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return tuple((float(np.median(t)), min(t), max(t)) for t in times)


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
    """Phase 3. Returns {kernel: {dtype: [(label, abs_err, kernel_ms,
    plain_ms)]}} for the timed cases (the main path's shapes)."""
    from tecogan_tpu_torch.kernels import (
        resblock_chain, resblock_chain_plain, upsample4, upsample4_bwd,
        upsample4_bwd_plain, upsample4_plain)

    gen = torch.Generator().manual_seed(3)
    results = {"upsample4": {}, "upsample4_bwd": {}, "resblock_chain": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        flow = seeded((CHUNK, LR_H, LR_W, 2), 8.0, gen, dev, dtype)
        lr = torch.rand((1, LR_H, LR_W, 3), generator=gen).to(dev, dtype)
        ragged = torch.rand((2, 37, 53, 3), generator=gen).to(dev, dtype)
        # (kernel, label, kernel fn, plain fn, timed)
        cases = [
            ("upsample4", "bilinear flow x4 (23,144,180,2)",
             lambda: upsample4(flow, "bilinear", 4.0),
             lambda: upsample4_plain(flow, "bilinear", 4.0), True),
            ("upsample4", "bicubic skip (1,144,180,3)",
             lambda: upsample4(lr, "bicubic"),
             lambda: upsample4_plain(lr, "bicubic"), True),
            ("upsample4", "bilinear ragged (2,37,53,3)",
             lambda: upsample4(ragged, "bilinear"),
             lambda: upsample4_plain(ragged, "bilinear"), False),
            ("upsample4", "bicubic ragged (2,37,53,3)",
             lambda: upsample4(ragged, "bicubic"),
             lambda: upsample4_plain(ragged, "bicubic"), False),
        ]
        # K2 at the training path's flow gradient (B*(T-1) = 36 pairs at
        # HR 128x128), the streaming geometry and a ragged shape.
        g_train = seeded((36, 128, 128, 2), 1.0, gen, dev, dtype)
        g_stream = seeded((CHUNK, 4 * LR_H, 4 * LR_W, 2), 1.0, gen, dev, dtype)
        g_ragged = seeded((2, 148, 212, 3), 1.0, gen, dev, dtype)
        cases += [
            ("upsample4_bwd", "bilinear x4 training (36,128,128,2)",
             lambda: upsample4_bwd(g_train, "bilinear", 4.0),
             lambda: upsample4_bwd_plain(g_train, "bilinear", 4.0), True),
            ("upsample4_bwd", "bilinear x4 streaming (23,576,720,2)",
             lambda: upsample4_bwd(g_stream, "bilinear", 4.0),
             lambda: upsample4_bwd_plain(g_stream, "bilinear", 4.0), True),
            ("upsample4_bwd", "bilinear ragged (2,148,212,3)",
             lambda: upsample4_bwd(g_ragged, "bilinear"),
             lambda: upsample4_bwd_plain(g_ragged, "bilinear"), False),
            ("upsample4_bwd", "bicubic ragged (2,148,212,3)",
             lambda: upsample4_bwd(g_ragged, "bicubic"),
             lambda: upsample4_bwd_plain(g_ragged, "bicubic"), False),
        ]
        # Half the glorot-uniform scale: activations stay O(1) over 16
        # random blocks instead of growing ~1.5x per block.
        lim = 0.5 * (6.0 / (2 * 9 * CHANNELS)) ** 0.5
        for h, w, n, timed in ((LR_H, LR_W, NUM_RESBLOCK, True), (37, 53, 3, False)):
            x = torch.relu(seeded((1, h, w, CHANNELS), 1.0, gen, dev, dtype))
            args = (x, seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype),
                    seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype))
            cases.append(("resblock_chain", f"chain N={n} (1,{h},{w},64)",
                          lambda a=args: resblock_chain(*a),
                          lambda a=args: resblock_chain_plain(*a), timed))
        if dtype == torch.bfloat16:
            # One block against its rounding points (chain_oracle_bf16):
            # a dropped tap or a misplaced fragment row shows here.
            for b, h, w in ((1, LR_H, LR_W), (2, 37, 53), (1, 5, 7)):
                x = torch.relu(seeded((b, h, w, CHANNELS), 1.0, gen, dev, dtype))
                args = (x, *(seeded(s, k, gen, dev, dtype) for s, k in (
                    ((1, 3, 3, CHANNELS, CHANNELS), lim), ((1, CHANNELS), 0.1),
                    ((1, 3, 3, CHANNELS, CHANNELS), lim), ((1, CHANNELS), 0.1))))
                cases.append(("resblock_chain_oracle", f"chain N=1 ({b},{h},{w},64) "
                              "vs its rounding points", lambda a=args: resblock_chain(*a),
                              lambda a=args: chain_oracle_bf16(*a), False))
        for kernel, label, fn, plain_fn, timed in cases:
            got = fn()
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_fn())
            tol = TOL[(kernel, dtype)]
            line = f"[kernel] {kernel} {name} {label}: max_abs_err={err:.3e} " \
                   f"rel={rel:.3e} tol={tol:.0e}"
            if timed:
                (ms, lo, hi), (plain_ms, plo, phi) = time_pair(fn, plain_fn)
                line += (f" kernel_ms={ms:.4f} [{lo:.4f}-{hi:.4f}] plain_ms="
                         f"{plain_ms:.4f} [{plo:.4f}-{phi:.4f}] (median [min-max])")
                results[kernel].setdefault(name, []).append((label, err, ms, plain_ms))
            log(line)
            if not rel <= tol:
                raise RuntimeError(f"{kernel} {name} {label}: rel error {rel:.3e} > {tol}")
    return results


def check_autograd(dev) -> None:
    """Phase 4: each autograd Function on the card against the CPU."""
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4

    rng = np.random.RandomState(8)

    def arr(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    c, n = CHANNELS, 3
    cases = [
        ("upsample4", "bilinear alpha=4 (2,37,53,2)",
         lambda x: upsample4(x, "bilinear", 4.0), [arr((2, 37, 53, 2), 2.0)]),
        ("upsample4", "bicubic (2,37,53,3)",
         lambda x: upsample4(x, "bicubic"), [arr((2, 37, 53, 3), 1.0)]),
        ("resblock_chain", f"chain N={n} (2,37,53,{c})", resblock_chain,
         [arr((2, 37, 53, c), 0.5), arr((n, 3, 3, c, c), 0.04), arr((n, c), 0.1),
          arr((n, 3, 3, c, c), 0.04), arr((n, c), 0.1)]),
    ]
    names = ("x", "w1", "b1", "w2", "b2")
    for kernel, label, fn, inputs in cases:
        grads = []
        for device in (dev, torch.device("cpu")):
            xs = [t.to(device, copy=True).requires_grad_() for t in inputs]
            out = fn(*xs)
            if out.grad_fn is None:
                raise RuntimeError(f"[autograd] {label} on {device}: no grad_fn")
            cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                                   .astype(np.float32)).to(device)
            grads.append([g.cpu() for g in torch.autograd.grad(out, xs, cot)])
        for name, g_dev, g_cpu in zip(names, *grads):
            err = (g_dev - g_cpu).abs().max().item()
            rel = err / max(g_cpu.abs().max().item(), 1e-30)
            log(f"[autograd] {kernel} {label} d{name}: grad_fn ok, CUDA vs CPU "
                f"max_abs_err={err:.3e} rel={rel:.3e} tol={GRAD_TOL[kernel]:.0e}")
            if not rel <= GRAD_TOL[kernel]:
                raise RuntimeError(f"[autograd] {label} d{name}: {rel:.3e}")


def frvsr_batch(cfg, batch: int, seed: int) -> np.ndarray:
    """(batch, rnn_n, tar, tar, 3) uint8 HR crops: synthetic "natural" clips."""
    from tecogan_tpu_torch.data.synthetic import synthetic_clip

    tar = cfg.hr_load_size
    clips = [synthetic_clip(cfg.rnn_n, tar, tar, seed=seed + i, content="natural")
             for i in range(batch)]
    return (np.stack(clips) * 255).astype(np.uint8)


def check_step_vs_cpu(dev) -> None:
    """Phase 7: one FRVSR step at full width, GPU against CPU, float32."""
    from tecogan_tpu_torch.config import FRVSR_PRESET
    from tecogan_tpu_torch.train import Trainer

    cfg = FRVSR_PRESET.replace(batch_size=2, rnn_n=4)
    batch = frvsr_batch(cfg, cfg.batch_size, 11)
    runs = []
    for device in (dev, torch.device("cpu")):
        trainer = Trainer(cfg, device)
        state = trainer.init_state(12)
        with torch.no_grad():
            # At the glorot init every flow is within ~1e-5 px of zero, so
            # each warp query sits on a pixel boundary, where the flow's
            # gradient jumps between two cells and a 1-ulp difference moves
            # it. This bias and a 10x smaller output conv hold the HR flows
            # at 1.43..1.53 / -2.52..-2.45 px (LR: a quarter), mid-cell.
            # Measured on this batch: float32 vs float64 gradients then
            # differ by 1.5e-4 of a parameter's largest entry, 6.2e-4 with
            # the output conv as drawn (flows then cross pixel boundaries).
            state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
            state.fnet.output_conv2.weight.mul_(0.1)
        t0 = time.perf_counter()
        _, metrics = trainer.train_step(state, batch)
        losses = {k: float(v) for k, v in metrics.items() if k != "learning_rate"}
        grads = {}
        for prefix, module in (("generator", state.generator), ("fnet", state.fnet)):
            for name, p in module.named_parameters():
                if p.grad is None:
                    raise RuntimeError(f"[step] {device}: {prefix}.{name} got no gradient")
                grads[f"{prefix}.{name}"] = p.grad.detach().cpu()
        log(f"[step] {device}: one step in {time.perf_counter() - t0:.2f} s, "
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
    log(f"[step] GPU vs CPU, float32, {cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, {cfg.rnn_n} frames, crop {cfg.crop_size}: "
        f"losses within {STEP_LOSS_TOL:.0e}; {len(grad_cpu)} parameters, every "
        f"gradient non-zero, worst rel {worst:.3e} ({worst_name}) tol {STEP_GRAD_TOL:.0e}")


def run_training(dev, card: str, tmp: str):
    """Phase 8: FRVSR_PRESET through ``train()`` on synthetic scenes under
    ``tmp``, 40 steps and a resume to 45 (checkpoints in
    ``<tmp>/run/checkpoints``); then the profile of one step. Returns the
    launch counts of the 45 steps."""
    import contextlib
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
    # Time each step between two synchronisations (loader waits, saves
    # and summaries fall outside).
    step_secs = []
    train_step = Trainer.train_step

    def timed_step(self, state, hr_seq):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = train_step(self, state, hr_seq)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - start)
        return result

    printed = io.StringIO()
    Trainer.train_step = timed_step
    try:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            state = train(cfg, out_dir, dev, max_steps=TRAIN_STEPS)
            wall = time.perf_counter() - t0
            first = (state.step, len(step_secs))
            state = train(cfg, out_dir, dev, max_steps=RESUME_STEPS)
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        Trainer.train_step = train_step
    for line in printed.getvalue().splitlines():
        if line.startswith(("step ", "Resumed", "Saved", "Dataset")):
            log(f"[train] | {line}")
    if first != (TRAIN_STEPS, TRAIN_STEPS) or \
            (state.step, len(step_secs)) != (RESUME_STEPS, RESUME_STEPS):
        raise RuntimeError(f"[train] steps {first} then {state.step}, "
                           f"{len(step_secs)} step calls")
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
    peak = torch.cuda.max_memory_allocated() / 2**20
    need = {"upsample4_bwd": RESUME_STEPS,
            "resblock_chain": cfg.num_resblock * cfg.rnn_n * RESUME_STEPS,
            "upsample4": (cfg.rnn_n + 1) * RESUME_STEPS}
    log(f"[train] launches over {RESUME_STEPS} steps {launches}, at least {need}")
    for k, n in need.items():
        if launches[k] < n:
            raise RuntimeError(f"{k} launched {launches[k]} times, want >= {n}")
    steady = sum(step_secs[TRAIN_STEPS - 20:TRAIN_STEPS]) / 20
    frames = cfg.batch_size * cfg.rnn_n
    log(f"[train] FRVSR_PRESET ({cfg.num_resblock} resblocks, batch "
        f"{cfg.batch_size}, crop {cfg.crop_size}, {cfg.rnn_n} frames, float32, "
        f"cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}): "
        f"{TRAIN_STEPS} steps in {wall:.2f} s wall, resumed to {RESUME_STEPS}; "
        f"steady {steady * 1e3:.2f} ms/step over steps 21-40, "
        f"{frames / steady:.1f} frames/s; peak {peak:.0f} MiB; every parameter "
        f"moved; {len(rows)} scalar rows; card: {card}")
    profile_step(dev, cfg, state, steady)
    return launches


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


def device_split(prof):
    """A torch.profiler window's device time by kernel group. Kernel rows
    count each kernel once; an operator's row holds the device time of the
    kernels it launched itself (by_op: where the glue comes from). Returns
    (total us, {group: us}, {group: {kernel: launches}}, by_op)."""
    from torch.autograd import DeviceType

    split = dict.fromkeys([*PROFILE_GROUPS, GLUE], 0.0)
    names = {g: {} for g in split}
    total, by_op = 0.0, []
    for row in prof.key_averages():
        us = device_us(row)
        if us <= 0:
            continue
        if row.device_type != DeviceType.CUDA:
            by_op.append((us, row.count, row.key))
            continue
        total += us
        key = row.key.lower()
        group = next((g for g, needles in PROFILE_GROUPS.items()
                      if any(n.lower() in key for n in needles)), GLUE)
        split[group] += us
        names[group][row.key] = names[group].get(row.key, 0) + row.count
    return total, split, names, sorted(by_op, reverse=True)


def log_split(total: float, split, by_op) -> None:
    for group, us in split.items():
        log(f"[profile]   {group}: {us / 1e3:.3f} ms ({us / total:.1%})")
    for us, count, key in by_op[:8]:
        log(f"[profile]   by op: {us / 1e3:.3f} ms in {count} calls of {key[:80]}")


def profile_step(dev, cfg, state, steady: float) -> None:
    """The device time of one training step by kernel group (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.train import Trainer

    trainer = Trainer(cfg, dev)
    batch = frvsr_batch(cfg, cfg.batch_size, 21)
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    # The same step with no loader thread beside it (train() has stopped
    # its loaders): how much of the step is the host's own dispatch.
    t0 = time.perf_counter()
    for _ in range(10):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    total, split, _, by_op = device_split(prof)
    if total <= 0:
        log("[profile] torch.profiler recorded no device time; see the CUDA-event times")
        return
    replay = sum(device_us(e, total=True) for e in prof.events()
                 if e.name.startswith("autograd::engine::evaluate_function: _ResblockChain"))
    log(f"[profile] one FRVSR_PRESET step: {total / 1e3:.2f} ms of device time "
        f"against {steady * 1e3:.2f} ms/step unprofiled in train() (device idle "
        f"share {max(0.0, 1 - total / 1e3 / (steady * 1e3)):.1%}) and "
        f"{alone * 1e3:.2f} ms/step on one batch with no loader running (idle "
        f"{max(0.0, 1 - total / 1e3 / (alone * 1e3)):.1%})")
    log_split(total, split, by_op)
    log(f"[profile]   of which the chain's backward (plain-chain replay + its "
        f"cuDNN backward, all kinds): {replay / 1e3:.3f} ms ({replay / total:.1%})")


def profile_streaming(sr, frames, secs: float) -> None:
    """One StreamingSR.run under torch.profiler, split by kernel group; the
    bfloat16 chain must have run through the tensor-core kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sr.run(frames, warmup=WARMUP)
        torch.cuda.synchronize()
    total, split, names, by_op = device_split(prof)
    if total <= 0:
        log("[profile] torch.profiler recorded no device time; see the CUDA-event times")
        return
    log(f"[profile] streaming, one StreamingSR.run of {FRAMES} frames: "
        f"{total / 1e3:.2f} ms of device time, {total / 1e3 / FRAMES:.3f} ms/frame, "
        f"against {secs * 1e3:.2f} ms of wall unprofiled ({FRAMES / secs:.2f} "
        f"frames/s processed; device idle share {max(0.0, 1 - total / 1e3 / (secs * 1e3)):.1%})")
    log_split(total, split, by_op)
    chain = names["chain kernel"]
    for key, count in chain.items():
        log(f"[profile]   chain kernel: {count} launches of {key[:100]}")
    mma = sum(n for key, n in chain.items() if "resblock_kernel_mma" in key)
    if mma < NUM_RESBLOCK * FRAMES or any("__nv_bfloat16>" in key for key in chain):
        raise RuntimeError(f"[profile] the chain ran {chain}, want >= "
                           f"{NUM_RESBLOCK * FRAMES} launches of resblock_kernel_mma")


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
    """Phase 6: the streaming path at size; returns launch counts."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import resblock_chain, upsample4
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=NUM_RESBLOCK, compute_dtype="bfloat16",
                     infer_chunk=CHUNK)
    sr = StreamingSR(cfg, *build_models(6, cfg), output="uint8", device=dev)
    rng = np.random.RandomState(7)
    frames = (rng.rand(FRAMES, LR_H, LR_W, 3) * 255).astype(np.uint8)
    sr.run(frames, warmup=WARMUP)  # untimed warm run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    upsample4.launches = 0
    resblock_chain.launches = 0
    hr, secs = sr.run(frames, warmup=WARMUP)
    launches = {"upsample4": upsample4.launches,
                "resblock_chain": resblock_chain.launches}
    want = (FRAMES - WARMUP, 4 * LR_H, 4 * LR_W, 3)
    if hr.shape != want or hr.dtype != np.uint8:
        raise RuntimeError(f"output {hr.shape} {hr.dtype}, want {want} uint8")
    if hr.min() == hr.max():
        raise RuntimeError("output is constant")
    need = {"upsample4": FRAMES + FRAMES // CHUNK,
            "resblock_chain": NUM_RESBLOCK * FRAMES}
    log(f"[main] launches {launches}, at least {need}")
    for k, n in need.items():
        if launches[k] < n:
            raise RuntimeError(f"{k} launched {launches[k]} times, want >= {n}")
    log(f"[main] {FRAMES} frames ({FRAMES - WARMUP} delivered) {LR_H}x{LR_W} -> "
        f"{4 * LR_H}x{4 * LR_W}, bfloat16, {NUM_RESBLOCK} resblocks, chunk "
        f"{CHUNK}: {secs:.3f} s wall, {FRAMES / secs:.2f} frames/s processed, "
        f"{(FRAMES - WARMUP) / secs:.2f} frames/s delivered, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; card: {card}")
    profile_streaming(sr, frames, secs)
    return launches


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
    import contextlib
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
    def cli(out_dir, *extra):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            stats = cli_main.main(["--mode", "inference", "--input_dir_HR", hr_dir,
                                   "--output_dir", out_dir, "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
        return stats, wall, printed.getvalue()

    out_dir = os.path.join(tmp, "cli_out")
    argv = ["--params_npz", npz, "--compute_dtype", "bfloat16", "--infer_chunk", str(CHUNK)]
    torch.backends.cudnn.deterministic = True
    try:
        upsample4.launches = 0
        resblock_chain.launches = 0
        runs = [cli(out_dir, *argv)]
        launches = {"upsample4": upsample4.launches,
                    "resblock_chain": resblock_chain.launches}
        data = load_inference_frames(input_dir_hr=hr_dir, device=dev)
        trees = read_params_npz(npz)
        sr = StreamingSR(cfg, *from_jax_params(trees["generator"], trees["fnet"]),
                         output="uint8", device=dev)
        direct, _ = sr.run(data.inputs, warmup=WARMUP)
    finally:
        torch.backends.cudnn.deterministic = False
    runs.append(cli(os.path.join(tmp, "cli_out2"), *argv))

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
    need = {"upsample4": FRAMES + FRAMES // CHUNK, "resblock_chain": NUM_RESBLOCK * FRAMES}
    log(f"[cli] launches {launches}, at least {need}")
    for k, n in need.items():
        if launches[k] < n:
            raise RuntimeError(f"[cli] {k} launched {launches[k]} times, want >= {n}")
    for i, (stats, wall, printed) in enumerate(runs, 1):
        flags = "cuDNN deterministic" if i == 1 else "default flags"
        log(f"[cli] run {i} ({flags}): {CLI_FRAMES} HR PNGs {4 * LR_H}x{4 * LR_W} -> LR {LR_H}x{LR_W} "
            f"(+{WARMUP} warm-up) -> {stats['written']} HR PNGs, bfloat16, "
            f"{NUM_RESBLOCK} resblocks, chunk {CHUNK}: decode + blur "
            f"{stats['decode_s']:.3f} s, stream {stats['stream_s']:.3f} s "
            f"({stats['frames'] / stats['stream_s']:.2f} frames/s processed), writer "
            f"flush {stats['flush_s']:.3f} s, {stats['threads']} writer threads; end to "
            f"end {wall:.3f} s wall, {stats['written'] / wall:.2f} frames/s PNG dir to "
            f"PNG dir; card: {card}")
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

    results = check_kernels(dev)
    check_autograd(dev)
    check_path_vs_cpu(dev)
    stream_launches = run_main_path(dev, card)
    check_step_vs_cpu(dev)
    # Phase 8 runs as a user's training does, with PyTorch's default flags:
    # cuDNN convolutions in TF32, float32 matmuls in full float32.
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = run_training(dev, card, tmp)
        # Phase 9 runs as a user's CLI does, with the same default flags.
        cli_launches = run_cli(dev, card, tmp, os.path.join(tmp, "run", "checkpoints"))

    # One entry per kernel. ms / plain_ms: the medians of its timed cases
    # (summed) in the dtype of the path it serves; launches: that path's
    # count (bfloat16 serves streaming, float32 training; the chain's two
    # kernels share the wrapper's count, and each path runs one of them).
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
        timed = results[key][dtype]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[path].get(key, 0),
                 "path": path, "max_abs_err": max(e for _, e, _, _ in timed),
                 "ms": sum(ms for _, _, ms, _ in timed),
                 "plain_ms": sum(p for _, _, _, p in timed),
                 "timed": [label for label, *_ in timed], "dtype": dtype}
        if path == "streaming":  # the inference CLI runs the streaming path
            entry["cli_launches"] = cli_launches.get(key, 0)
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
