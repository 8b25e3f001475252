#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tecogan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero):

1. versions, the card's name and power limit; no CUDA -> exit non-zero;
2. build the CUDA kernels from ``tecogan_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   streaming path's shapes and a ragged one, float32 (TF32 off) and
   bfloat16, with the error beside its tolerance and CUDA-event times;
4. the whole streaming path at full width (16 resblocks, 64 channels) on
   the GPU against the same seeded weights on the CPU (plain versions),
   float32, 6 frames of 64x96;
5. the main path at size: 46 uint8 frames of 144x180 -> 41 of 576x720,
   bfloat16, chunks of 23, with the kernels' launch counts and frames/s.

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
LR_H, LR_W = 144, 180          # Vid4 calendar geometry (-> 576x720)
FRAMES, WARMUP, CHUNK = 46, 5, 23
NUM_RESBLOCK, CHANNELS = 16, 64

# Tolerances on max|kernel - plain| / max(1, max|plain|).
#   float32: same math; FMA contraction and summation order differ.
#   bfloat16: the kernels round once per pass/conv, the plain versions after
#   every op, so they may land 1-2 bfloat16 ulps (2^-8 relative) apart per
#   rounding, compounded over 16 blocks in the chain.
TOL = {("upsample4", torch.float32): 1e-6, ("upsample4", torch.bfloat16): 1e-2,
       ("resblock_chain", torch.float32): 1e-4,
       ("resblock_chain", torch.bfloat16): 5e-2}
# Whole path, GPU kernels vs CPU plain versions, float32: the same tolerance
# as the chain (it dominates), relative to the output's scale.
PATH_TOL = 1e-3


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        resblock_chain, resblock_chain_plain, upsample4, upsample4_plain)

    gen = torch.Generator().manual_seed(3)
    results = {"upsample4": {}, "resblock_chain": {}}
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
        for h, w, n, timed in ((LR_H, LR_W, NUM_RESBLOCK, True), (37, 53, 3, False)):
            x = torch.relu(seeded((1, h, w, CHANNELS), 1.0, gen, dev, dtype))
            # Half the glorot-uniform scale: activations stay O(1) over 16
            # random blocks instead of growing ~1.5x per block.
            lim = 0.5 * (6.0 / (2 * 9 * CHANNELS)) ** 0.5
            args = (x, seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype),
                    seeded((n, 3, 3, CHANNELS, CHANNELS), lim, gen, dev, dtype),
                    seeded((n, CHANNELS), 0.1, gen, dev, dtype))
            cases.append(("resblock_chain", f"chain N={n} (1,{h},{w},64)",
                          lambda a=args: resblock_chain(*a),
                          lambda a=args: resblock_chain_plain(*a), timed))
        for kernel, label, fn, plain_fn, timed in cases:
            got = fn()
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_fn())
            tol = TOL[(kernel, dtype)]
            line = f"[kernel] {kernel} {name} {label}: max_abs_err={err:.3e} " \
                   f"rel={rel:.3e} tol={tol:.0e}"
            if timed:
                reps = 20 if kernel == "upsample4" else 5
                plain_ms = cuda_ms(plain_fn, reps)
                ms = cuda_ms(fn, reps)
                plain_ms = (plain_ms + cuda_ms(plain_fn, reps)) / 2
                ms = (ms + cuda_ms(fn, reps)) / 2
                line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                results[kernel].setdefault(name, []).append((label, err, ms, plain_ms))
            log(line)
            if not rel <= tol:
                raise RuntimeError(f"{kernel} {name} {label}: rel error {rel:.3e} > {tol}")
    return results


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
    """Phase 4: full-width streaming, GPU vs CPU, float32."""
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
    """Phase 5: the streaming path at size; returns launch counts."""
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

    results = check_kernels(dev)
    check_path_vs_cpu(dev)
    launches = run_main_path(dev, card)

    kernels = []
    for name, source, replaces, also in (
            ("upsample4", "tecogan_tpu_torch/csrc/upsample4.cu",
             "tecogan_tpu/kernels/upsample4.py:68", []),
            ("resblock_chain", "tecogan_tpu_torch/csrc/resblock_chain.cu",
             "tecogan_tpu/kernels/resblocks.py:87",
             ["tecogan_tpu/kernels/resblocks.py:305",
              "tecogan_tpu/kernels/resblocks.py:466"])):
        timed = results[name]["bfloat16"]  # the main path's dtype
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max(e for _, e, _, _ in timed),
                 "ms": sum(ms for _, _, ms, _ in timed),
                 "plain_ms": sum(p for _, _, _, p in timed),
                 "timed": [label for label, *_ in timed], "dtype": "bfloat16"}
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
