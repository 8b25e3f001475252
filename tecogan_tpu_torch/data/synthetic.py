"""Procedural synthetic video for tests and smoke training (counterpart of
``tecogan_tpu/data/synthetic.py``; the JAX package's module cannot be
imported here, since ``tecogan_tpu/data/__init__.py`` pulls in JAX).

:func:`synthetic_clip` is the same numpy code, so a seed gives the same
frames bit for bit; :func:`write_synthetic_scenes` writes them with the
port's PNG codec (``data/png.py``) instead of OpenCV.

The procedural 3D scene classes (:class:`CheckerPlane`,
:class:`TexturedQuad`, :class:`WireCube`, :class:`SlidingPatch`; the
reference's Chess / Book / Cube / TestSceneRender roles) are the JAX
package's numpy code with the same ``RandomState`` draws, poses and
projections. Their quads are rasterised by :func:`fill_convex_poly`, the
port's copy of OpenCV's ``cv2.fillConvexPoly`` (``shift=0``, ``LINE_8``),
which the JAX package calls: the frames are the JAX package's bit for bit.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# The convex-polygon fill of OpenCV (imgproc drawing.cpp: FillConvexPoly with
# shift=0 and LINE_8), which the procedural scenes draw with.
# ---------------------------------------------------------------------------
XY_SHIFT = 16  # drawing.cpp's fixed-point fraction bits
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the (w, h) image: the clipped end points, or
    None when the segment misses the image. The intersections truncate a
    double toward zero, as the C++ casts do."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's 8-connected ``Line``: the segment clipped to the image, then
    Bresenham's walk from its left end (``LineIterator``, leftToRight)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if vert:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def _div_trunc(a: int, b: int) -> int:
    """C's integer division, rounding toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_convex_poly(img: np.ndarray, pts, color) -> None:
    """Fill the polygon of integer corners ``pts`` ((N, 2) or (N, 1, 2), x
    then y) in ``img`` (H, W, C) with ``color``, in place, as
    ``cv2.fillConvexPoly(img, pts, color)`` does: every edge drawn as an
    8-connected line, then each scanline from the polygon's top to its
    bottom filled between its two edges, followed from the top vertex in
    16.16 fixed point (the C++'s integer arithmetic). The colour is cast to
    the image's dtype. Corners may lie off the image; a polygon of fewer
    than three corners draws only its edges."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    n = len(pts)
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    xmin = xmax = pts[0][0]
    ymin = ymax = pts[0][1]
    imin = 0
    p0 = pts[-1]
    for i, p in enumerate(pts):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line8(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Two edges walk down from the top vertex: one forward through the
    # corners, one backward; each keeps its end row, x and dx (16.16).
    idx, end_y, step = [imin, imin], [ymin, ymin], [1, n - 1]
    x, dx = [-XY_ONE, -XY_ONE], [0, 0]
    half = XY_ONE >> 1
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y < end_y[i]:
                continue
            idx0 = idx[i]
            nxt = (idx0 + step[i]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = pts[nxt][1]
                if ty > y:
                    xs, xe = pts[idx0][0] << XY_SHIFT, pts[nxt][0] << XY_SHIFT
                    end_y[i] = ty
                    dx[i] = _div_trunc((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    x[i] = xs
                    idx[i] = nxt
                    break
                idx0 = nxt
                nxt = (nxt + step[i]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if x[0] > x[1] else (0, 1)
            x1 = (x[left] + half) >> XY_SHIFT
            x2 = (x[right] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        x[0] += dx[0]
        x[1] += dx[1]
        y += 1
        if y > ymax:
            break


# ---------------------------------------------------------------------------
# Procedural 3D scene classes (reference lib/data/video.py:47-165 roles:
# VideoSynthBase / Chess / Book / Cube): the JAX package's minimal pinhole
# renderer over numpy geometry (tecogan_tpu/data/synthetic.py:224-479).
# ---------------------------------------------------------------------------
class ProceduralScene:
    """Base class: a deterministic camera orbit + pinhole projection with
    optional per-frame sensor noise, exposed through the cv2.VideoCapture
    ``read()`` protocol so loaders can consume it like a real source."""

    def __init__(self, height: int = 240, width: int = 320, seed: int = 0,
                 noise: float = 0.0):
        self.h, self.w = height, width
        self.rng = np.random.RandomState(seed)
        self.noise = noise
        self.t = 0
        f = 0.9 * width
        self.K = np.array([[f, 0, width / 2.0],
                           [0, f, height / 2.0],
                           [0, 0, 1.0]])

    # camera pose: slow orbit around the scene origin, slight bob
    def _pose(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        ang = 0.02 * t
        r = 6.0
        eye = np.array([r * np.sin(ang), 1.2 + 0.2 * np.sin(0.05 * t),
                        r * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)          # look at origin
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd])            # world -> camera rows
        tvec = -R @ eye
        return R, tvec

    def _project(self, pts_world: np.ndarray, t: int) -> np.ndarray:
        R, tvec = self._pose(t)
        cam = pts_world @ R.T + tvec
        z = np.maximum(cam[:, 2], 1e-6)
        uv = (cam[:, :2] / z[:, None]) * self.K[0, 0]
        uv[:, 0] += self.K[0, 2]
        uv[:, 1] += self.K[1, 2]
        return uv

    def render(self, t: int) -> np.ndarray:
        """(H, W, 3) float32 [0, 1] frame at time t; override ``_draw``."""
        frame = np.zeros((self.h, self.w, 3), np.float32)
        # sky/ground gradient background
        grad = np.linspace(0.25, 0.6, self.h, dtype=np.float32)[:, None]
        frame[:] = grad[..., None] * np.float32([0.9, 0.95, 1.0])
        self._draw(frame, t)
        if self.noise > 0:
            frame = frame + self.rng.normal(
                0.0, self.noise, frame.shape).astype(np.float32)
        return np.clip(frame, 0.0, 1.0)

    def _draw(self, frame: np.ndarray, t: int) -> None:
        raise NotImplementedError

    # ---- cv2.VideoCapture protocol ------------------------------------
    def read(self) -> Tuple[bool, np.ndarray]:
        frame = self.render(self.t)
        self.t += 1
        return True, (frame * 255).astype(np.uint8)

    def isOpened(self) -> bool:  # noqa: N802 (cv2 spelling)
        return True

    def release(self) -> None:
        pass


def _fill_quad(frame: np.ndarray, uv: np.ndarray, color) -> None:
    """Rasterize a convex quad given 4 projected (x, y) corners."""
    fill_convex_poly(frame, np.round(uv).astype(np.int32), color)


class CheckerPlane(ProceduralScene):
    """The 'Chess' role: a ground-plane checkerboard under camera orbit —
    strong perspective flow with sign changes across the board."""

    def __init__(self, squares: int = 8, **kw):
        super().__init__(**kw)
        self.n = squares

    def _draw(self, frame, t):
        n = self.n
        half = n / 2.0
        for i in range(n):
            for j in range(n):
                corners = np.array([
                    [i - half, 0.0, j - half],
                    [i + 1 - half, 0.0, j - half],
                    [i + 1 - half, 0.0, j + 1 - half],
                    [i - half, 0.0, j + 1 - half],
                ])
                uv = self._project(corners, t)
                c = 0.85 if (i + j) % 2 == 0 else 0.12
                _fill_quad(frame, uv, (c, c * 0.95, c * 0.9))


class TexturedQuad(ProceduralScene):
    """The 'Book' role: an upright textured rectangle (procedural stripes)
    swaying in front of the camera — large coherent surface motion."""

    def __init__(self, stripes: int = 12, **kw):
        super().__init__(**kw)
        self.stripes = stripes
        self.colors = self.rng.rand(stripes, 3) * 0.7 + 0.2

    def _draw(self, frame, t):
        sway = 0.4 * np.sin(0.07 * t)
        for s in range(self.stripes):
            x0 = -1.5 + 3.0 * s / self.stripes + sway
            x1 = -1.5 + 3.0 * (s + 1) / self.stripes + sway
            corners = np.array([
                [x0, 0.2, -0.5], [x1, 0.2, -0.5],
                [x1, 2.2, -0.5], [x0, 2.2, -0.5],
            ])
            uv = self._project(corners, t)
            _fill_quad(frame, uv, tuple(self.colors[s]))


class WireCube(ProceduralScene):
    """The 'Cube' role: a spinning solid cube — self-occlusion and depth
    discontinuities."""

    _FACES = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
              (2, 3, 7, 6), (1, 2, 6, 5), (0, 3, 7, 4)]

    def _draw(self, frame, t):
        a = 0.05 * t
        ca, sa = np.cos(a), np.sin(a)
        rot = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        verts = (np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                           for z in (-1, 1)])[[0, 1, 3, 2, 4, 5, 7, 6]]
                 @ rot.T)
        verts[:, 1] += 1.0
        R, tvec = self._pose(t)
        cam_z = (verts @ R.T + tvec)[:, 2]
        uv = self._project(verts, t)
        order = np.argsort([-cam_z[list(f)].mean() for f in self._FACES])
        for k in order:  # painter's algorithm, far faces first
            f = self._FACES[k]
            shade = 0.35 + 0.08 * k
            _fill_quad(frame, uv[list(f)], (shade, 0.3, 0.9 - 0.07 * k))


class SlidingPatch(ProceduralScene):
    """The 'TestSceneRender' role (reference tst_scene_render.py): a
    foreground patch sliding sinusoidally over a static textured background,
    with the patch's ground-truth rect queryable per frame — fixtures that
    need known motion (flow/warp assertions) read :meth:`current_rect`.

    Motion model matches the reference's: offsets ``amplitude * cos/sin
    (speed * t)`` around the centered rest position, full-amplitude so the
    patch sweeps the frame without leaving it.
    """

    def __init__(self, patch_frac: float = 0.25, speed: float = 0.25, **kw):
        super().__init__(**kw)
        self.speed = speed
        ph = max(4, int(self.h * patch_frac))
        pw = max(4, int(self.w * patch_frac))
        # procedural textures: smooth background, high-contrast patch
        yy, xx = np.meshgrid(np.arange(self.h), np.arange(self.w),
                             indexing="ij")
        self._bg = np.stack([
            0.3 + 0.2 * np.sin(2 * np.pi * xx / self.w * 3),
            0.3 + 0.2 * np.sin(2 * np.pi * yy / self.h * 2),
            0.45 + 0.1 * np.cos(2 * np.pi * (xx + yy) / (self.h + self.w)),
        ], axis=-1).astype(np.float32)
        py, px = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
        self._patch = np.stack([
            ((py // 4 + px // 4) % 2).astype(np.float32) * 0.7 + 0.15,
            0.2 + 0.6 * (px / max(1, pw - 1)).astype(np.float32),
            0.8 - 0.6 * (py / max(1, ph - 1)).astype(np.float32),
        ], axis=-1)
        self._rest = ((self.h - ph) // 2, (self.w - pw) // 2)
        self._ampl = (self._rest[0], self._rest[1])  # keep patch in-frame

    def _offset(self, t: int):
        return (int(self._ampl[0] * np.cos(t * self.speed)),
                int(self._ampl[1] * np.sin(t * self.speed)))

    def current_rect(self, t: Optional[int] = None) -> np.ndarray:
        """(y0, x0, y1, x1) of the patch at time ``t`` (default: the frame
        :meth:`read` would produce next) — the reference's getCurrentRect/
        getRectInTime contract."""
        t = self.t if t is None else t
        dy, dx = self._offset(t)
        ph, pw = self._patch.shape[:2]
        y0, x0 = self._rest[0] + dy, self._rest[1] + dx
        return np.array([y0, x0, y0 + ph, x0 + pw])

    def _draw(self, frame, t):
        frame[:] = self._bg
        y0, x0, y1, x1 = self.current_rect(t)
        frame[y0:y1, x0:x1] = self._patch


def _parse_synth(source: str) -> dict:
    """Parse the reference's ``synth:`` source grammar
    (lib/data/video.py:21-27: ``synth:class=chess:noise=0.1:size=WxH``)."""
    params: dict = {}
    for part in source.split(":")[1:]:
        if not part:
            continue
        k, _, v = part.partition("=")
        if k == "size":
            w, h = v.split("x")
            params["width"], params["height"] = int(w), int(h)
        elif k == "noise":
            params["noise"] = float(v)
        elif k == "class":
            params["class"] = v
        elif k == "seed":
            params["seed"] = int(v)
    return params


_SCENES = {"chess": CheckerPlane, "book": TexturedQuad, "cube": WireCube,
           "patch": SlidingPatch}


def create_capture(source=None, height: int = 240, width: int = 320,
                   seed: int = 0, device=None):
    """A frame source for the reference's create_capture contract
    (lib/data/video.py:176-206): the strings 'chess'/'book'/'cube'/'patch'
    or a ``synth:class=...:noise=...:size=WxH`` spec return the
    corresponding procedural scene; a video file returns a
    :class:`tecogan_tpu_torch.data.video_io.VideoCapture`, whose ``read()``
    gives ``(ok, BGR uint8)`` as ``cv2.VideoCapture`` does for the JAX
    package. A path that does not exist, a camera index or None (the
    default camera) falls back to :class:`CheckerPlane`, where the JAX
    package's ``cv2.VideoCapture`` fails to open (the port has no camera
    capture); a file in a codec the port does not decode raises
    NotImplementedError. ``device`` is where an H.264 or VP9 file decodes
    (None: the card's NVDEC; ``"cpu"`` raises NotImplementedError for
    them, ROADMAP item 12b)."""
    if isinstance(source, str) and source.startswith("synth:"):
        p = _parse_synth(source)
        cls = _SCENES.get(p.pop("class", "chess"), CheckerPlane)
        return cls(height=p.pop("height", height),
                   width=p.pop("width", width),
                   seed=p.pop("seed", seed), **p)
    if isinstance(source, str) and source.lower() in _SCENES:
        return _SCENES[source.lower()](height=height, width=width, seed=seed)
    if isinstance(source, str) and os.path.isfile(source):
        from tecogan_tpu_torch.data.video_io import VideoCapture

        try:
            return VideoCapture(source, device=device)
        except ValueError:  # not a container the port reads: cv2 fails to open
            pass
    return CheckerPlane(height=height, width=width, seed=seed)


def procedural_clip(kind: str, num_frames: int, height: int, width: int,
                    seed: int = 0) -> np.ndarray:
    """(T, H, W, 3) float32 [0, 1] clip from a procedural scene class."""
    cap = create_capture(kind, height=height, width=width, seed=seed)
    out = np.empty((num_frames, height, width, 3), np.float32)
    for t in range(num_frames):
        ok, frame = cap.read()
        if not ok:
            raise RuntimeError(f"{kind}: frame {t} could not be read")
        out[t] = frame.astype(np.float32) / 255.0
    return out
