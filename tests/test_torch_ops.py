"""Port ops (tecogan_tpu_torch.ops) against the JAX package's on the same
seeded inputs, float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.models.fnet import pad_flow_to as jax_pad_flow_to
from tecogan_tpu.ops import image as jax_image
from tecogan_tpu.ops import resize as jax_resize
from tecogan_tpu.ops.space_to_depth import space_to_depth as jax_space_to_depth
from tecogan_tpu.ops import warp as jax_warp
from tecogan_tpu_torch import ops
from tecogan_tpu_torch.models.fnet import pad_flow_to

torch.set_num_threads(1)

# Resizes: the JAX package sums all taps in one float32 einsum, the port
# per axis with one round to float32 between the passes; values in [0, 1],
# so a few float32 ulps.
RESIZE_ATOL = 2e-6
# The warp repeats the JAX package's coordinate and lerp arithmetic op for op.
WARP_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("factor", [2, 4])
def test_upscale_bilinear_matches_jax(factor, rng):
    x = rng.rand(2, 7, 9, 3).astype(np.float32)
    want = np.asarray(jax_resize.upscale_bilinear(jnp.asarray(x), factor))
    got = ops.upscale_bilinear(_t(x), factor).numpy()
    assert got.shape == (2, 7 * factor, 9 * factor, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_bicubic_four_matches_jax(rng):
    x = rng.rand(2, 6, 7, 3).astype(np.float32)
    want = np.asarray(jax_resize.bicubic_four(jnp.asarray(x)))
    got = ops.bicubic_four(_t(x)).numpy()
    assert got.shape == (2, 24, 28, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_space_to_depth_matches_jax(rng):
    x = rng.rand(2, 8, 12, 3).astype(np.float32)
    packed = ops.space_to_depth(_t(x), 4)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(ops.depth_to_space(packed, 4).numpy(), x)
    with pytest.raises(ValueError):
        ops.space_to_depth(_t(x[:, :7]), 4)


def test_preprocess_deprocess_match_jax(rng):
    x = rng.rand(3, 5).astype(np.float32)
    np.testing.assert_array_equal(ops.preprocess(_t(x)).numpy(),
                                  np.asarray(jax_image.preprocess(jnp.asarray(x))))
    np.testing.assert_array_equal(ops.deprocess(_t(x)).numpy(),
                                  np.asarray(jax_image.deprocess(jnp.asarray(x))))


@pytest.mark.parametrize("size", [(21, 29), (16, 24)])
def test_pad_flow_to_matches_jax(size, rng):
    """21x29 is not a multiple of 8: FNet's flow comes back 16x24 and is
    symmetric-padded by 5 rows and 5 columns (edge sample included)."""
    flow = rng.randn(2, 16, 24, 2).astype(np.float32)
    want = np.asarray(jax_pad_flow_to(jnp.asarray(flow), *size))
    got = pad_flow_to(_t(flow), *size).numpy()
    np.testing.assert_array_equal(got, want)


def _flow_with_outside_queries(rng, b, h, w):
    flow = (rng.randn(b, h, w, 2) * 4.0).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    qy, qx = gy - flow[..., 0], gx - flow[..., 1]
    outside = (qy < 0) | (qy > h - 1) | (qx < 0) | (qx > w - 1)
    assert outside.sum() > 10, "the test must exercise border clamping"
    return flow


def test_dense_image_warp_matches_jax(rng):
    img = rng.rand(2, 9, 11, 3).astype(np.float32)
    flow = _flow_with_outside_queries(rng, 2, 9, 11)
    want = np.asarray(jax_warp.dense_image_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = ops.dense_image_warp(_t(img), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


def test_warp_space_to_depth_matches_jax(rng):
    img = (rng.rand(2, 12, 16, 3).astype(np.float32) * 2 - 1)
    flow = _flow_with_outside_queries(rng, 2, 12, 16)
    want = np.asarray(jax_warp.warp_space_to_depth(
        jnp.asarray(img), jnp.asarray(flow), 4, scale=0.5, shift=0.5))
    got = ops.warp_space_to_depth(_t(img), _t(flow), 4, scale=0.5, shift=0.5)
    assert got.shape == (2, 3, 4, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WARP_ATOL)
