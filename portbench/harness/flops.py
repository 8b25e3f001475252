"""Operations and bytes of the model's work, counted from layer shapes.

The benchmark's own arithmetic: it counts the work the published model
needs, whatever kernel computes it, so a share of a peak or of a roofline
reads the same work for any implementation. A multiply-add is 2 FLOP.
Convolutions are counted (3x3, SAME; a 3x3 stride-2 transposed conv as 9
taps of every input pixel); element-wise work, resizes, warps and losses
are not, and are small beside them.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16 and 495
TFLOP/s TF32 on the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12}

FNET_DOWN = (32, 64, 128)
FNET_UP = (256, 128, 64)
C = 64


def peak_flops(compute_dtype: str) -> float:
    """The tensor cores' peak for a configuration's compute dtype: bfloat16,
    or TF32 for float32 (float32 convolutions and the chain run on the TF32
    tensor cores)."""
    return PEAK_FLOPS["bfloat16" if compute_dtype == "bfloat16" else "tf32"]


def conv_macs(h: int, w: int, cin: int, cout: int) -> int:
    return h * w * 9 * cin * cout


def fnet_macs(h: int, w: int) -> int:
    """FNet on one (h, w) pair: max pools floor, so the decoder works on the
    //8 grid."""
    macs, cin, hh, ww = 0, 6, h, w
    for c in FNET_DOWN:
        macs += conv_macs(hh, ww, cin, c) + conv_macs(hh, ww, c, c)
        cin, hh, ww = c, hh // 2, ww // 2
    for c in FNET_UP:
        macs += conv_macs(hh, ww, cin, c) + conv_macs(hh, ww, c, c)
        cin, hh, ww = c, 2 * hh, 2 * ww
    return macs + conv_macs(hh, ww, cin, 32) + conv_macs(hh, ww, 32, 2)


def chain_macs(h: int, w: int, blocks: int) -> int:
    """The residual blocks on one (h, w) frame: 2 convs 64 -> 64 a block."""
    return blocks * 2 * conv_macs(h, w, C, C)


def generator_macs(h: int, w: int, blocks: int) -> int:
    """The generator on one LR frame of (h, w): input conv 51 -> 64, the
    blocks, two stride-2 transposed convs, the output conv at 4x."""
    return (conv_macs(h, w, 51, C) + chain_macs(h, w, blocks)
            + conv_macs(h, w, C, C) + conv_macs(2 * h, 2 * w, C, C)
            + conv_macs(4 * h, 4 * w, C, 3))


def frame_flops(h: int, w: int, blocks: int) -> int:
    """One streamed or served frame: FNet on its pair and the generator."""
    return 2 * (fnet_macs(h, w) + generator_macs(h, w, blocks))


def train_step_flops(batch: int, frames: int, crop: int, blocks: int) -> int:
    """One FRVSR step: FNet on the batch's frames - 1 pairs and the generator
    on every frame, forward plus twice that for the backward."""
    fwd = batch * ((frames - 1) * fnet_macs(crop, crop)
                   + frames * generator_macs(crop, crop, blocks))
    return 3 * 2 * fwd


def chain_launch_bound(shape: Tuple[int, int, int], itemsize: int, compute_dtype: str
                       ) -> Tuple[float, Dict[str, float]]:
    """The least time of one chain launch (one residual block) on x of
    (B, H, W) pixels of 64 channels: x, both convs' weights and biases read
    once and the output written once, against 2 x 9 x 64 x 64 multiply-adds
    a pixel and conv. Returns (seconds, its terms)."""
    b, h, w = shape
    px = b * h * w
    bytes_ = (2 * px * C + 2 * 9 * C * C + 2 * C) * itemsize
    flops = 2 * 2 * 9 * C * C * px
    mem_s = bytes_ / HBM_BYTES_PER_S
    op_s = flops / peak_flops(compute_dtype)
    return max(mem_s, op_s), {"bytes": bytes_, "flops": flops, "mem_s": mem_s, "op_s": op_s}
