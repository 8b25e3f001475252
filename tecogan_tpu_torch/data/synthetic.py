"""Procedural synthetic video for tests and smoke training (counterpart of
``tecogan_tpu/data/synthetic.py:27-216``; the JAX package's module cannot be
imported here, since ``tecogan_tpu/data/__init__.py`` pulls in JAX).

:func:`synthetic_clip` is the same numpy code, so a seed gives the same
frames bit for bit; :func:`write_synthetic_scenes` writes them with the
port's PNG codec (``data/png.py``) instead of OpenCV. The JAX package's
procedural 3D scene classes are not ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import os

import numpy as np

from tecogan_tpu_torch.data.png import write_png


def synthetic_clip(
    num_frames: int,
    height: int,
    width: int,
    seed: int = 0,
    content: str = "grating",
) -> np.ndarray:
    """A deterministic moving-texture clip, (T, H, W, 3) float32 in [0, 1].

    Two content regimes, selected by ``content``:

    - ``"grating"`` (default, the op-stress fixture): two drifting 2D
      sinusoid gratings at different scales and velocities plus a moving
      bright square. Frequencies reach 0.4 cycles/px — far above the 0.125
      quarter-band that survives the x4 Gaussian decimation (reference
      ops.py:347-367) — so most detail is *unrecoverable*: ideal for
      stressing warp/metric ops, measured unusable for demonstrating that
      training beats bicubic (round-5 train->eval: trained 17.37 dB vs
      bicubic 17.53 dB on this content).
    - ``"natural"`` (the training/eval fixture): band-limited textured
      background panning at sub-pixel velocity plus sharp-edged moving
      occluders (gradient-filled rectangles and a disk). Spectrally this
      matches the reference's real training data (half-res Vimeo video,
      dataPrepare.py:90-99 + INTER_AREA 0.5x, which is naturally
      band-limited), so 4x SR is learnable: a trained model can and should
      clearly beat the bicubic baseline here.
    """
    if content == "natural":
        return _natural_clip(num_frames, height, width, seed)
    if content != "grating":
        raise ValueError(
            f"content must be 'grating' or 'natural', got {content!r}")
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    yy = yy.astype(np.float64)
    xx = xx.astype(np.float64)

    f1 = rng.uniform(0.05, 0.15, size=2)
    f2 = rng.uniform(0.15, 0.4, size=2)
    v1 = rng.uniform(-1.5, 1.5, size=2)
    v2 = rng.uniform(-2.5, 2.5, size=2)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    sq = rng.uniform(0.2, 0.6, size=2)  # square start (fractional)
    sqv = rng.uniform(-2.0, 2.0, size=2)
    sq_size = max(4, int(0.15 * min(height, width)))

    frames = np.zeros((num_frames, height, width, 3), np.float32)
    for t in range(num_frames):
        g1 = 0.5 + 0.5 * np.sin(
            2 * np.pi * (f1[0] * (yy - v1[0] * t) + f1[1] * (xx - v1[1] * t))
            + phase[0]
        )
        g2 = 0.5 + 0.5 * np.sin(
            2 * np.pi * (f2[0] * (yy - v2[0] * t) + f2[1] * (xx - v2[1] * t))
            + phase[1]
        )
        base = np.stack(
            [
                0.6 * g1 + 0.4 * g2,
                0.5 * g1 + 0.5 * g2 * np.cos(phase[2]) ** 2,
                0.4 * g1 + 0.6 * g2,
            ],
            axis=-1,
        )
        cy = int((sq[0] * height + sqv[0] * t) % (height - sq_size))
        cx = int((sq[1] * width + sqv[1] * t) % (width - sq_size))
        base[cy : cy + sq_size, cx : cx + sq_size] = [0.9, 0.8, 0.2]
        frames[t] = np.clip(base, 0.0, 1.0)
    return frames


def _natural_clip(
    num_frames: int,
    height: int,
    width: int,
    seed: int = 0,
) -> np.ndarray:
    """Band-limited naturalistic clip: see :func:`synthetic_clip` (the
    ``content="natural"`` regime).

    Composition: a large noise canvas sampled through a sub-pixel panning
    window, plus two gradient-filled rectangles and one flat disk moving
    sinusoidally. The canvas mixes three octaves:

    - two Gaussian-smoothed layers (sigma 8 / 2.5 px) — the smooth base;
    - an FFT-annulus band-pass layer confined to 0.05-0.115 cycles/px —
      BELOW the 0.125 quarter-band (so it survives the x4 decimation and
      stays single-frame recoverable) but heavily attenuated by the
      sigma=1.5 anti-alias blur (gain 0.55-0.75). Interpolators like
      ``bicubic_four`` reproduce it at that attenuated amplitude; inverting
      the known blur is a plain linear filter a conv net learns quickly.
      Measured on this band: FFT-interpolation ~28 dB vs ~50 dB for the
      deconvolution oracle — the learnable headroom the round-5 train->eval
      loop demonstrates. Without this octave (two smooth layers only)
      bicubic saturates at ~39 dB and training can only tie it.
    """
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    v = rng.uniform(-1.5, 1.5, size=2)  # background pan, px/frame
    pad = int(np.ceil(np.abs(v).max() * num_frames)) + 2
    ch, cw = height + 2 * pad + 1, width + 2 * pad + 1
    coarse = gaussian_filter(rng.rand(ch, cw, 3).astype(np.float32),
                             (8.0, 8.0, 0.0))
    mid = gaussian_filter(rng.rand(ch, cw, 3).astype(np.float32),
                          (2.5, 2.5, 0.0))
    fy = np.fft.fftfreq(ch)[:, None]
    fx = np.fft.fftfreq(cw)[None, :]
    ann = (np.sqrt(fy ** 2 + fx ** 2) >= 0.05) & \
          (np.sqrt(fy ** 2 + fx ** 2) <= 0.115)
    detail = np.empty((ch, cw, 3), np.float32)
    for c in range(3):
        spec = (rng.randn(ch, cw) + 1j * rng.randn(ch, cw)) * ann
        layer = np.fft.ifft2(spec).real
        detail[:, :, c] = layer / (layer.std() + 1e-12)
    canvas = (coarse - coarse.mean((0, 1))) / (coarse.std((0, 1)) + 1e-6)
    canvas = 0.12 * canvas + 0.06 * (
        (mid - mid.mean((0, 1))) / (mid.std((0, 1)) + 1e-6)) + 0.10 * detail
    canvas = np.clip(0.5 + canvas, 0.02, 0.98)

    # Occluders: sinusoidal orbits around the frame center, always in-frame.
    def orbit(t, amp_y, amp_x, w, phase):
        return (amp_y * np.sin(w * t + phase), amp_x * np.cos(w * t + phase))

    rects = []
    for _ in range(2):
        rh = max(6, int(rng.uniform(0.12, 0.22) * height))
        rw = max(6, int(rng.uniform(0.12, 0.22) * width))
        c0, c1 = rng.uniform(0.1, 0.9, 3), rng.uniform(0.1, 0.9, 3)
        gy = np.linspace(0.0, 1.0, rh, dtype=np.float32)[:, None, None]
        tex = (c0 * (1.0 - gy) + c1 * gy).astype(np.float32)
        tex = np.broadcast_to(tex, (rh, rw, 3))
        rects.append((rh, rw, tex, rng.uniform(0.04, 0.18),
                      rng.uniform(0, 2 * np.pi)))
    disk_r = max(4, int(0.10 * min(height, width)))
    disk_c = rng.uniform(0.15, 0.95, 3).astype(np.float32)
    disk_w, disk_ph = rng.uniform(0.04, 0.18), rng.uniform(0, 2 * np.pi)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")

    frames = np.empty((num_frames, height, width, 3), np.float32)
    for t in range(num_frames):
        oy, ox = pad + v[0] * t, pad + v[1] * t
        iy, ix = int(np.floor(oy)), int(np.floor(ox))
        fy, fx = oy - iy, ox - ix
        c = canvas[iy:iy + height + 1, ix:ix + width + 1]
        frame = ((1 - fy) * (1 - fx) * c[:-1, :-1]
                 + (1 - fy) * fx * c[:-1, 1:]
                 + fy * (1 - fx) * c[1:, :-1]
                 + fy * fx * c[1:, 1:]).copy()
        for k, (rh, rw, tex, w, ph) in enumerate(rects):
            dy, dx = orbit(t, (height - rh) // 2 - 1, (width - rw) // 2 - 1,
                           w, ph + k)
            y0 = int((height - rh) // 2 + dy)
            x0 = int((width - rw) // 2 + dx)
            frame[y0:y0 + rh, x0:x0 + rw] = tex
        dy, dx = orbit(t, height // 2 - disk_r - 1, width // 2 - disk_r - 1,
                       disk_w, disk_ph)
        cy, cx = height // 2 + dy, width // 2 + dx
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= disk_r ** 2
        frame[mask] = disk_c
        frames[t] = np.clip(frame, 0.0, 1.0)
    return frames


def write_synthetic_scenes(
    root: str,
    num_scenes: int,
    num_frames: int,
    height: int,
    width: int,
    start_index: int = 2000,
    prefix: str = "scene",
    seed: int = 0,
    content: str = "natural",
) -> None:
    """Write scene dirs in the reference layout,
    ``<root>/<prefix>_%04d/col_high_%04d.png`` (reference dataloader.py:65-72,
    dataPrepare.py:98-99); scene ``s`` is ``synthetic_clip`` with seed
    ``seed + s``."""
    for s in range(num_scenes):
        d = os.path.join(root, f"{prefix}_{start_index + s:04d}")
        os.makedirs(d, exist_ok=True)
        clip = synthetic_clip(num_frames, height, width, seed=seed + s,
                              content=content)
        for t in range(num_frames):
            write_png(os.path.join(d, f"col_high_{t:04d}.png"),
                      (clip[t] * 255).astype(np.uint8))
