"""Dense Farneback optical flow in torch: OpenCV's
``calcOpticalFlowFarneback`` (``modules/video/src/optflowgf.cpp``,
``FarnebackOpticalFlow::calc``, the CPU path) for the fixed arguments of
the metrics suite (``tecogan_tpu/eval/suite.py:34-37``): pyr_scale 0.5,
levels 3, winsize 15, iterations 3, poly_n 5, poly_sigma 1.2, flags 0 (box
window). tOF needs it on machines without OpenCV.

At each pyramid level, coarsest first:

1. the uint8 frames as float32, Gaussian pre-smoothed with
   sigma = (1/scale - 1)/2 and ``ksize = max(round(5 sigma) | 1, 3)``
   (``BORDER_REFLECT_101``), then resized (INTER_LINEAR);
2. ``FarnebackPolyExp``: the poly_n = 5 polynomial expansion, a separable
   Gaussian-weighted moment filter with replicated borders, vertical pass
   in float32, horizontal in float64, times the inverse moment constants;
3. ``FarnebackUpdateMatrices``: R1 sampled bilinearly at x + flow, the
   five products of the 2x2 system, damped within 5 pixels of the border;
4. ``iterations`` times ``FarnebackUpdateFlow_Blur``: box sums of the
   matrices (winsize x winsize, replicated borders, float64), the 2x2
   solve with 1e-3 on the determinant, then new matrices from the new
   flow (all but the last time). OpenCV interleaves the matrix update
   with the flow rows in stripes; a stripe is updated only once no later
   row reads it, so doing the two in sequence is the same computation;
5. the flow upsampled (INTER_LINEAR) and doubled for the next level.

The border damping is the one deviation from ``optflowgf.cpp`` as
published: its table reads ``{0.14, 0.14, 0.4472, 0.8943, 0.9974}`` for
the pixels 0..4 from an edge, but OpenCV 5.0.0's build weights pixels 2..4
all by 0.4472. Fitting the five weights to that build's flows gives
these values with a residual of 1.5e-8 px; the published table leaves
0.01 px on average (0.77 px at worst) within 12 pixels of the border.

Every step is elementwise arithmetic and gathers in a fixed order, with no
reduction of the device's choosing, so the CPU and a GPU compute the same
flow. It runs on the frames' device.
"""

from __future__ import annotations

import numpy as np
import torch

from tecogan_tpu_torch.ops.blur import gaussian_kernel, sep_filter_reflect101

PYR_SCALE, LEVELS, WINSIZE, ITERATIONS, POLY_N, POLY_SIGMA = 0.5, 3, 15, 3, 5, 1.2
MIN_SIZE = 32  # a level is used only while both sides stay >= 32 pixels
_BORDER = np.float32([0.14, 0.14, 0.4472, 0.4472, 0.4472])


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` on uint8 RGB (H, W, 3):
    ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    rgb = img.astype(np.int32)
    return ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
             + (1 << 14)) >> 15).astype(np.uint8)


def _poly_constants(n: int, sigma: float):
    """``FarnebackPrepareGaussian``: float32 g, x g, x^2 g on [0, n] and the
    inverse moment constants ig11, ig03, ig33, ig55 (float64)."""
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    g = (g.astype(np.float64) / np.sum(g.astype(np.float64))).astype(np.float32)
    xg = (x.astype(np.float32) * g).astype(np.float32)
    xxg = ((x * x).astype(np.float32) * g).astype(np.float32)
    G = np.zeros((6, 6))
    for yi in range(2 * n + 1):
        for xi in range(2 * n + 1):
            gy, gx = g[yi], g[xi]
            xf, yf = np.float32(x[xi]), np.float32(x[yi])
            G[0, 0] += float(gy * gx)
            G[1, 1] += float(gy * gx * xf * xf)
            G[3, 3] += float(gy * gx * xf * xf * xf * xf)
            G[5, 5] += float(gy * gx * xf * xf * yf * yf)
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return ([float(v) for v in g[n:]], [float(v) for v in xg[n:]],
            [float(v) for v in xxg[n:]], (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]))


_G, _XG, _XXG, (_IG11, _IG03, _IG33, _IG55) = _poly_constants(POLY_N, POLY_SIGMA)


def _shift(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """x shifted by k along dim with replicated borders: out[i] = x[clamp(i + k)]."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).add_(k).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def poly_exp(img: torch.Tensor) -> torch.Tensor:
    """``FarnebackPolyExp``: float32 (H, W) -> (H, W, 5) float32."""
    g, xg, xxg = _G, _XG, _XXG
    # Vertical pass, float32.
    r0 = img * g[0]
    r1 = torch.zeros_like(img)
    r2 = torch.zeros_like(img)
    for k in range(1, POLY_N + 1):
        s0, s1 = _shift(img, 0, -k), _shift(img, 0, k)
        p = s0 + s1
        r0 = r0 + p * g[k]
        r1 = r1 + (s1 - s0) * xg[k]
        r2 = r2 + p * xxg[k]
    # Horizontal pass: sums in float64 of the float32 terms as C forms them.
    b1 = (r0 * g[0]).double()
    b3 = (r1 * g[0]).double()
    b5 = (r2 * g[0]).double()
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, POLY_N + 1):
        a0, c0 = _shift(r0, 1, k), _shift(r0, 1, -k)
        a1, c1 = _shift(r1, 1, k), _shift(r1, 1, -k)
        a2, c2 = _shift(r2, 1, k), _shift(r2, 1, -k)
        tg = (a0 + c0).double()
        b1 = b1 + tg * g[k]
        b4 = b4 + tg * xxg[k]
        b2 = b2 + ((a0 - c0) * xg[k]).double()
        b3 = b3 + ((a1 + c1) * g[k]).double()
        b6 = b6 + ((a1 - c1) * xg[k]).double()
        b5 = b5 + ((a2 + c2) * g[k]).double()
    return torch.stack([b3 * _IG11, b2 * _IG11, b1 * _IG03 + b5 * _IG33,
                        b1 * _IG03 + b4 * _IG33, b6 * _IG55], dim=-1).float()


def _border_scale(h: int, w: int, device) -> torch.Tensor:
    """The product of the border weights of ``UpdateMatrices`` (1 inside),
    float32 in C's order: x-left, x-right, y-top, y-bottom."""
    def side(n):
        i = np.arange(n)
        lo = np.where(i < 5, _BORDER[np.minimum(i, 4)], np.float32(1))
        hi = np.where(n - 1 - i < 5, _BORDER[np.minimum(n - 1 - i, 4)], np.float32(1))
        return (torch.from_numpy(lo.astype(np.float32)).to(device),
                torch.from_numpy(hi.astype(np.float32)).to(device))

    xl, xr = side(w)
    yt, yb = side(h)
    return ((xl * xr)[None, :] * yt[:, None]) * yb[:, None]


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                    border: torch.Tensor) -> torch.Tensor:
    """``FarnebackUpdateMatrices`` over the whole frame: (H, W, 5) float32."""
    h, w = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    fx = torch.arange(w, device=flow.device, dtype=torch.float32)[None, :] + dx
    fy = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.long(), y1.long()
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    xc, yc = x1.clamp(0, max(w - 2, 0)), y1.clamp(0, max(h - 2, 0))
    flat = R1.reshape(h * w, 5)
    base = yc * w + xc

    def tap(offset):
        return flat.index_select(0, (base + offset).reshape(-1)).reshape(h, w, 5)

    ax, ay = (1.0 - fx)[..., None], (1.0 - fy)[..., None]
    fx, fy = fx[..., None], fy[..., None]
    a00, a01, a10, a11 = ax * ay, fx * ay, ax * fy, fx * fy
    r = a00 * tap(0) + a01 * tap(1) + a10 * tap(w) + a11 * tap(w + 1)
    r4 = torch.where(inside, (R0[..., 2] + r[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inside, (R0[..., 3] + r[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inside, (R0[..., 4] + r[..., 4]) * 0.25, R0[..., 4] * 0.5)
    r23 = torch.where(inside[..., None], r[..., :2], torch.zeros_like(r[..., :2]))
    r2 = (R0[..., 0] - r23[..., 0]) * 0.5
    r3 = (R0[..., 1] - r23[..., 1]) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    r2, r3, r4, r5, r6 = (t * border for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-1)


def _box_sum(m: torch.Tensor, size: int) -> torch.Tensor:
    """Sum over a size x size window with replicated borders: vertical,
    then horizontal, as ``UpdateFlow_Blur``'s running sums."""
    r = size // 2
    out = m
    for dim in (0, 1):
        acc = _shift(out, dim, -r)
        for k in range(-r + 1, r + 1):
            acc = acc + _shift(out, dim, k)
        out = acc
    return out


def update_flow(M: torch.Tensor, winsize: int = WINSIZE) -> torch.Tensor:
    """``FarnebackUpdateFlow_Blur``'s solve: the flow from the box-summed
    matrices, (H, W, 2) float32."""
    s = _box_sum(M.double(), winsize) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = s.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], dim=-1).float()


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``cv2.resize(x, (w, h), interpolation=INTER_LINEAR)`` on float32
    (H, W) or (H, W, C): half-pixel centres, clamped at the borders,
    horizontal pass then vertical, float32. (OpenCV takes its INTER_AREA
    path for an exact halving; for float32 that is the same sums.)"""
    def axis(n_in, n_out):
        f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
        low, high = s < 0, s >= n_in - 1
        f[low], s[low] = 0, 0
        f[high], s[high] = 0, n_in - 1
        s1 = np.minimum(s + 1, n_in - 1)
        return [torch.from_numpy(a).to(x.device)
                for a in (s, s1, (1 - f).astype(np.float32), f)]

    extra = x.dim() - 2
    s0, s1, a0, a1 = axis(x.shape[1], w)
    shape = (1, -1) + (1,) * extra
    x = x.index_select(1, s0) * a0.view(shape) + x.index_select(1, s1) * a1.view(shape)
    s0, s1, b0, b1 = axis(x.shape[0], h)
    shape = (-1,) + (1,) * (extra + 1)
    return x.index_select(0, s0) * b0.view(shape) + x.index_select(0, s1) * b1.view(shape)


def _num_levels(h: int, w: int) -> int:
    scale = 1.0
    for k in range(LEVELS):
        scale *= PYR_SCALE
        if w * scale < MIN_SIZE or h * scale < MIN_SIZE:
            return k
    return LEVELS


def farneback_flow(prev_grey: torch.Tensor, grey: torch.Tensor) -> torch.Tensor:
    """``cv2.calcOpticalFlowFarneback(prev_grey, grey, None, 0.5, 3, 15, 3,
    5, 1.2, 0)`` on (H, W) uint8 tensors; returns (H, W, 2)
    float32 (dx, dy) on their device."""
    if prev_grey.shape != grey.shape or grey.dim() != 2:
        raise ValueError(f"farneback_flow takes two (H, W) frames of one size, "
                         f"got {tuple(prev_grey.shape)} and {tuple(grey.shape)}")
    h0, w0 = grey.shape
    imgs = (prev_grey.float(), grey.float())
    flow = None
    for k in range(_num_levels(h0, w0), -1, -1):
        scale = PYR_SCALE ** k
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(int(round(sigma * 5)) | 1, 3)  # round half to even, as cvRound
        h, w = int(round(h0 * scale)), int(round(w0 * scale))
        if flow is None:
            flow = torch.zeros((h, w, 2), dtype=torch.float32, device=grey.device)
        else:
            flow = resize_linear(flow, h, w) * (1.0 / PYR_SCALE)
        kernel = gaussian_kernel(ksize, sigma)
        R0, R1 = (poly_exp(resize_linear(sep_filter_reflect101(img, kernel), h, w))
                  for img in imgs)
        border = _border_scale(h, w, grey.device)
        M = update_matrices(R0, R1, flow, border)
        for i in range(ITERATIONS):
            flow = update_flow(M)
            if i < ITERATIONS - 1:
                M = update_matrices(R0, R1, flow, border)
    return flow
