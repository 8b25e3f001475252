"""The port's procedural scenes against the JAX package's on the CPU: every
scene class and a ``synth:`` spec with noise bit-equal, the convex-polygon
fill against ``cv2.fillConvexPoly`` (corners off the image and degenerate
polygons included), ``SlidingPatch.current_rect`` and the ``synth:``
grammar."""

import cv2
import numpy as np
import pytest
import torch

from tecogan_tpu.data import synthetic as jax_synthetic
from tecogan_tpu_torch.data import synthetic

torch.set_num_threads(1)

KINDS = ["chess", "book", "cube", "patch", "CUBE",
         "synth:class=book:noise=0.05:size=64x48:seed=3",
         "synth:class=cube:noise=0.1:size=64x48",
         "synth:size=64x48"]


@pytest.mark.parametrize("kind", KINDS)
def test_procedural_clip_bit_equal(kind):
    """Same draws, poses and projections; quads through the port's fill:
    every pixel equal to the JAX package's (OpenCV's fill)."""
    want = jax_synthetic.procedural_clip(kind, 6, 48, 64, seed=1)
    got = synthetic.procedural_clip(kind, 6, 48, 64, seed=1)
    assert got.dtype == want.dtype == np.float32 and got.shape == (6, 48, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_procedural_clip_larger_frames():
    """The checkerboard at 240x320, where most squares span many rows."""
    np.testing.assert_array_equal(synthetic.procedural_clip("chess", 3, 240, 320, seed=2),
                                  jax_synthetic.procedural_clip("chess", 3, 240, 320, seed=2))


def _polygons(seed, n=150):
    """Seeded polygons: rotated rectangles near and across the image's
    edges, random (possibly non-convex) quads, degenerate ones (repeated
    corners, collinear, a point) and corners far off the image; triangles
    and a pentagon among them."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(5, 40, 2)
        kind = i % 5
        if kind == 0:
            cx, cy = rng.uniform(-10, w + 10), rng.uniform(-10, h + 10)
            a, b = rng.uniform(0, 30, 2)
            th = rng.uniform(0, np.pi)
            c, s = np.cos(th), np.sin(th)
            pts = np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                            for dx, dy in ((-a, -b), (a, -b), (a, b), (-a, b))])
        elif kind == 1:
            pts = rng.uniform(-15, max(h, w) + 15, (4, 2))
        elif kind == 2:
            p = rng.uniform(-5, 30, 2)
            pts = np.array([p, p + rng.randint(-3, 4, 2), p, p + rng.randint(-3, 4, 2)])
        elif kind == 3:
            pts = rng.uniform(-200, 200, (4, 2))
        else:
            pts = rng.uniform(-5, max(h, w) + 5, (rng.choice([1, 2, 3, 5]), 2))
        yield (h, w), np.round(pts).astype(np.int32), tuple(rng.rand(3))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fill_convex_poly_matches_opencv(seed):
    for (h, w), pts, color in _polygons(seed):
        want = np.zeros((h, w, 3), np.float32)
        cv2.fillConvexPoly(want, pts.reshape(-1, 1, 2), color)
        got = np.zeros((h, w, 3), np.float32)
        synthetic.fill_convex_poly(got, pts.reshape(-1, 1, 2), color)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {pts.tolist()}")


def test_fill_convex_poly_uint8():
    """An integer image takes the colour cast to its dtype, as OpenCV's."""
    pts = np.array([[2, 1], [14, 3], [12, 11], [1, 9]], np.int32)
    want = np.zeros((12, 16, 3), np.uint8)
    cv2.fillConvexPoly(want, pts, (200, 17, 90))
    got = np.zeros((12, 16, 3), np.uint8)
    synthetic.fill_convex_poly(got, pts, (200, 17, 90))
    np.testing.assert_array_equal(got, want)


def test_sliding_patch_rect_and_synth_grammar():
    jp = jax_synthetic.SlidingPatch(height=48, width=64, seed=0, speed=0.3)
    pp = synthetic.SlidingPatch(height=48, width=64, seed=0, speed=0.3)
    for t in range(12):
        np.testing.assert_array_equal(pp.current_rect(t), jp.current_rect(t))
    for _ in range(3):
        jp.read()
        pp.read()
    np.testing.assert_array_equal(pp.current_rect(), jp.current_rect())
    for spec in ["synth:", "synth:class=chess:noise=0.1:size=320x240",
                 "synth:size=64x48:seed=7::class=patch", "synth:bogus=1:noise=0"]:
        assert synthetic._parse_synth(spec) == jax_synthetic._parse_synth(spec)
    cap = synthetic.create_capture("synth:class=patch:size=64x48:seed=4")
    assert isinstance(cap, synthetic.SlidingPatch) and (cap.h, cap.w) == (48, 64)
    assert cap.isOpened()


@pytest.mark.parametrize("source", ["clip.mp4", 0, None])
def test_create_capture_real_source_raises(source):
    """A missing path or a camera index falls back to CheckerPlane, as the
    JAX package's does where cv2.VideoCapture fails to open (video files:
    tests/test_torch_video_io.py)."""
    assert isinstance(synthetic.create_capture(source), synthetic.CheckerPlane)
    assert isinstance(jax_synthetic.create_capture(source), jax_synthetic.CheckerPlane)
