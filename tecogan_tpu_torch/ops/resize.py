"""Integer-factor resizing with TF1-exact semantics (counterpart of
``tecogan_tpu/ops/resize.py``).

- :func:`upscale_bilinear`: legacy TF1 bilinear, ``align_corners=False`` and
  source coordinate ``src = dst / factor`` with no half-pixel offset, edge
  replicated (reference lib/ops.py:126-163 at 4x; FNet's decoder at 2x).
- :func:`bicubic_four`: separable Catmull-Rom (r=0.75) 4x with edge
  replication, i.e. a pad of 1 px top/left and 2 px bottom/right (reference
  lib/ops.py:166-212); the generator's residual skip.

- :func:`stencil_matrix`: the 4x upsample along one axis as a (4n, n)
  matrix; the plain version of its adjoint (``kernels/upsample4.py``) uses it.
- :func:`resize_area`: OpenCV's ``INTER_AREA`` 0.5x of a uint8 frame, bit
  for bit, on the host (the dataset preparation's scene cut, reference
  lib/data/video.py:168-173).

``F.interpolate`` is not used: its half-pixel source grid differs from both.
Each resize is separable: the H pass and then the W pass, each summed in
float32 and rounded to the input dtype. That is also the rounding of the 4x
kernel (``kernels/upsample4.py``), whose plain version these functions are.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

#: Catmull-Rom taps sit at source offsets -1..2; bilinear taps at 0..1.
_BICUBIC_OFFSETS = (-1, 0, 1, 2)
_BILINEAR_OFFSETS = (0, 1)


@functools.lru_cache(maxsize=None)
def _bilinear_phase_weights(factor: int) -> Tuple[Tuple[float, ...], ...]:
    """Output ``f*i + p`` blends source ``i`` and ``i+1`` with weights
    ``(1 - p/f, p/f)``; shape (factor, 2)."""
    return tuple((1.0 - p / factor, p / factor) for p in range(factor))


@functools.lru_cache(maxsize=None)
def _catmull_rom_weights() -> Tuple[Tuple[float, ...], ...]:
    """4-phase Catmull-Rom (r=0.75) weights over taps i-1..i+2; shape (4, 4)
    (reference lib/ops.py:186-188)."""
    r = 0.75
    mat = ((0.0, 1.0, 0.0, 0.0),
           (-r, 0.0, r, 0.0),
           (2 * r, r - 3, 3 - 2 * r, -r),
           (-r, 2 - r, r - 2, r))
    out = []
    for t in (0.0, 0.25, 0.5, 0.75):
        powers = (1.0, t, t * t, t * t * t)
        out.append(tuple(sum(powers[k] * mat[k][j] for k in range(4))
                         for j in range(4)))
    return tuple(out)


def _phase_pass(x: torch.Tensor, axis: int,
                weights: Sequence[Sequence[float]],
                offsets: Sequence[int]) -> torch.Tensor:
    """Output ``f*i + p`` along ``axis`` = sum_t weights[p][t] *
    x[clamp(i + offsets[t])], accumulated in x's dtype in tap order."""
    n = x.shape[axis]
    base = torch.arange(n, device=x.device)
    taps = [x.index_select(axis, (base + off).clamp_(0, n - 1))
            for off in offsets]
    phases = []
    for wp in weights:
        acc = taps[0] * wp[0]
        for tap, wt in zip(taps[1:], wp[1:]):
            acc = acc + tap * wt
        phases.append(acc)
    out = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * len(weights)
    return out.reshape(shape)


def _separable_upsample(x: torch.Tensor, weights, offsets) -> torch.Tensor:
    """(B, H, W, C) -> (B, fH, fW, C): H pass then W pass, each summed in
    float32 and rounded to ``x.dtype``."""
    hi = _phase_pass(x.float(), 1, weights, offsets).to(x.dtype)
    return _phase_pass(hi.float(), 2, weights, offsets).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _stencil_array(n: int, filter_: str) -> np.ndarray:
    """Row 4i+p holds the phase-p weights at the clamped taps around i, the
    edge taps summed. Twin of
    ``tecogan_tpu/kernels/upsample4.py:_stencil_matrix``."""
    if filter_ == "bilinear":
        weights, offsets = _bilinear_phase_weights(4), _BILINEAR_OFFSETS
    else:
        weights, offsets = _catmull_rom_weights(), _BICUBIC_OFFSETS
    s = np.zeros((4 * n, n), np.float32)
    for i in range(n):
        for p in range(4):
            for wt, off in zip(weights[p], offsets):
                s[4 * i + p, min(max(i + off, 0), n - 1)] += wt
    s.flags.writeable = False
    return s


def stencil_matrix(n: int, filter_: str, device=None) -> torch.Tensor:
    """The (4n, n) float32 stencil matrix S of the 4x upsample along an axis
    of n pixels ("bilinear" or "bicubic"): upsampling is ``S @ x`` along the
    axis, its adjoint ``S.T @ g``. Weights and their edge sums are dyadic,
    so exact in float32."""
    return torch.tensor(_stencil_array(n, filter_), device=device)


def upscale_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Legacy TF1 bilinear upscale of (B, H, W, C) by an integer factor."""
    return _separable_upsample(x, _bilinear_phase_weights(factor),
                               _BILINEAR_OFFSETS)


def upscale_four(x: torch.Tensor) -> torch.Tensor:
    """4x bilinear upscale (reference lib/ops.py:126-163)."""
    return upscale_bilinear(x, 4)


def bicubic_four(x: torch.Tensor) -> torch.Tensor:
    """4x Catmull-Rom bicubic upscale of (B, H, W, C)."""
    return _separable_upsample(x, _catmull_rom_weights(), _BICUBIC_OFFSETS)


def resize_area(frame: np.ndarray, scale: float = 0.5) -> np.ndarray:
    """``cv2.resize(frame, None, fx=scale, fy=scale,
    interpolation=cv2.INTER_AREA)`` of a uint8 (H, W) or (H, W, C) frame,
    bit for bit; ``scale`` must be 0.5.

    OpenCV sizes the output ``round(H/2) x round(W/2)``, half to even
    (``saturate_cast<int>``), and keeps the scale 2 it was given, so odd
    sizes also take its 2x2 fast path (``resizeAreaFast``): a full 2x2
    block is ``(a + b + c + d + 2) >> 2``; a block cut by the right or
    bottom edge (an odd width rounded up) is the float32 mean of the pixels
    it has, rounded half to even; an odd size rounded down drops its last
    row or column. Checked against OpenCV 5.0's ``cv2``."""
    if scale != 0.5:
        raise ValueError(f"resize_area supports scale 0.5 only, got {scale}")
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim not in (2, 3):
        raise ValueError(f"resize_area takes uint8 (H, W[, C]) frames, got "
                         f"{frame.dtype} {frame.shape}")
    h, w = frame.shape[:2]
    oh, ow = round(h * scale), round(w * scale)  # Python rounds half to even
    if oh == 0 or ow == 0:
        raise ValueError(f"resize_area: a {h}x{w} frame has no 0.5x size")
    h, w = min(h, 2 * oh), min(w, 2 * ow)  # a size rounded down drops the last pixel
    src = np.zeros((2 * oh, 2 * ow) + frame.shape[2:], np.int32)
    src[:h, :w] = frame[:h, :w]
    count = np.zeros((2 * oh, 2 * ow), np.int32)
    count[:h, :w] = 1
    total = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]
    n = count[0::2, 0::2] + count[0::2, 1::2] + count[1::2, 0::2] + count[1::2, 1::2]
    if frame.ndim == 3:
        n = n[..., None]
    mean = np.rint(total.astype(np.float32) / n.astype(np.float32))
    return np.where(n == 4, (total + 2) >> 2, mean).astype(np.uint8)
