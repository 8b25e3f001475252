"""The reference helpers of ``tecogan_tpu/ops/image.py`` and
``tecogan_tpu/models/layers.py`` that the main paths do not call, against
the port's counterparts on seeded inputs, on the CPU: BT.601 YCbCr,
``load_img`` (the JAX package reads through OpenCV, the port through its
own PNG codec), ``compute_psnr``, ``prelu`` and ``pixel_shuffler``."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.models import layers as jax_layers
from tecogan_tpu.ops import image as jax_image
from tecogan_tpu_torch.models.layers import pixel_shuffler, prelu
from tecogan_tpu_torch.ops.image import compute_psnr, load_img, rgb_to_ycbcr_bt601

torch.set_num_threads(1)

# float32 YCbCr of 0-255 values: a 3-term dot product, each side rounded
# once per op; the results reach 255, whose float32 ulp is 1.5e-5.
YCBCR_ATOL = 1e-4
# PSNR: a float32 mean and log in another order; relative.
PSNR_RTOL = 1e-6
# prelu: XLA may contract alpha * min(x, 0) + max(x, 0) into one FMA.
PRELU_ATOL = 1e-7


def test_rgb_to_ycbcr_bt601_matches_jax():
    """numpy float64 bit-equal to the JAX package's; a float32 tensor
    within float32 rounding of it."""
    img = np.random.RandomState(0).rand(2, 5, 7, 3) * 255
    want = jax_image.rgb_to_ycbcr_bt601(img)
    np.testing.assert_array_equal(rgb_to_ycbcr_bt601(img), want)
    got = rgb_to_ycbcr_bt601(torch.from_numpy(img.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=YCBCR_ATOL)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_load_img_matches_jax(tmp_path, channels):
    """8-bit gray, RGB and RGBA PNGs written by OpenCV: bit-equal to the JAX
    package's ``cv2.imread(path, 3)`` route (gray replicated, alpha
    dropped); a missing file raises in both."""
    rng = np.random.RandomState(channels)
    shape = (9, 11) if channels == 1 else (9, 11, channels)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, rng.randint(0, 256, shape).astype(np.uint8))
    got, want = load_img(path), jax_image.load_img(path)
    assert got.dtype == np.float32 and got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, want)
    missing = os.path.join(str(tmp_path), "none.png")
    for fn in (load_img, jax_image.load_img):
        with pytest.raises(FileNotFoundError):
            fn(missing)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compute_psnr_matches_jax(dtype):
    """float32 PSNR of [0, 1] images (bfloat16 inputs cast first), and inf
    for identical images, as the JAX package's."""
    rng = np.random.RandomState(1)
    ref = torch.from_numpy(rng.rand(2, 16, 12, 3).astype(np.float32)).to(dtype)
    target = (ref.float() + torch.from_numpy(
        rng.randn(2, 16, 12, 3).astype(np.float32) * 0.05)).clamp(0, 1).to(dtype)
    got = compute_psnr(ref, target)
    want = jax_image.compute_psnr(jnp.asarray(ref.float().numpy()),
                                  jnp.asarray(target.float().numpy()))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=PSNR_RTOL)
    assert float(compute_psnr(ref, ref)) == float(jax_image.compute_psnr(
        jnp.asarray(ref.float().numpy()), jnp.asarray(ref.float().numpy()))) == np.inf


def test_prelu_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    alpha = rng.rand(8).astype(np.float32)
    got = prelu(torch.from_numpy(x), torch.from_numpy(alpha))
    want = np.asarray(jax_layers.prelu(jnp.asarray(x), jnp.asarray(alpha)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PRELU_ATOL)


@pytest.mark.parametrize("scale,channels", [(2, 12), (3, 18), (2, 13)],
                         ids=["x2", "x3", "x2-ragged"])
def test_pixel_shuffler_matches_jax(scale, channels):
    """Bit-equal, the reference's channel order; channels beyond a multiple
    of scale^2 are dropped, as the reference's split drops them."""
    x = np.random.RandomState(scale).randn(2, 4, 5, channels).astype(np.float32)
    got = pixel_shuffler(torch.from_numpy(x), scale)
    want = np.asarray(jax_layers.pixel_shuffler(jnp.asarray(x), scale))
    assert got.shape == (2, 4 * scale, 5 * scale, channels // (scale * scale))
    np.testing.assert_array_equal(got.numpy(), want)
