"""The port's TecoConfig and presets against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu import config as jax_config
from tecogan_tpu_torch import config

# Fields the JAX package has and the port leaves out: TPU tuning modes and
# the parameter dtype (the port keeps float32 parameters).
JAX_ONLY = {"inline_flow", "fold_input_s2d", "train_fold_s2d",
            "pallas_flow_upsample", "fused_trunk", "param_dtype"}


@pytest.mark.parametrize("name", ["FRVSR_PRESET", "TECOGAN_PRESET", "MINI_PRESET"])
def test_presets_match_jax(name):
    ours = dataclasses.asdict(getattr(config, name))
    theirs = dataclasses.asdict(getattr(jax_config, name))
    assert set(theirs) - set(ours) == JAX_ONLY
    assert set(ours) <= set(theirs)
    assert ours == {k: theirs[k] for k in ours}


def test_config_json_round_trip_and_validation():
    cfg = config.TECOGAN_PRESET.replace(compute_dtype="bfloat16")
    assert config.TecoConfig.from_json(cfg.to_json()) == cfg
    assert cfg.torch_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        config.TecoConfig(compute_dtype="float16")
    with pytest.raises(ValueError):
        config.TecoConfig(crop_size=20)


def test_top_level_exports_match_jax():
    """``from tecogan_tpu_torch import TecoConfig, ...``: the JAX package's
    top-level names, bound to the port's config module."""
    import tecogan_tpu
    import tecogan_tpu_torch

    assert tecogan_tpu_torch.__all__ == tecogan_tpu.__all__
    for name in tecogan_tpu_torch.__all__:
        assert getattr(tecogan_tpu_torch, name) is getattr(config, name)


@pytest.mark.parametrize("package", ["data", "utils", "ops", "eval", "models", "parallel"])
def test_package_exports_match_jax(package):
    """``tecogan_tpu_torch.data``, ``.utils``, ``.ops``, ``.eval``,
    ``.models`` and ``.parallel`` export the JAX package's names (its ``__init__.py`` files),
    each bound to the port's own object. The ``kernels`` subpackage keeps
    its own names: the JAX package's are TPU tuning."""
    import importlib

    ours = importlib.import_module(f"tecogan_tpu_torch.{package}")
    theirs = importlib.import_module(f"tecogan_tpu.{package}")
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        assert getattr(ours, name).__module__.startswith("tecogan_tpu_torch."), name


# ------------------------------------------ names bound for the JAX exports
def _rng_images(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_upscale_four_and_gaussian_kernel_2d_match_jax():
    from tecogan_tpu import ops as jax_ops
    from tecogan_tpu_torch import ops

    x = _rng_images((2, 5, 7, 3))
    np.testing.assert_allclose(ops.upscale_four(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ops.upscale_four(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    for size, sigma in ((13, 1.5), (5, 0.8), (4, 2.0)):
        want = jax_ops.gaussian_kernel_2d(size, sigma)
        got = ops.gaussian_kernel_2d(size, sigma)
        assert got.dtype == want.dtype and got.shape == (size, size)
        np.testing.assert_array_equal(got, want)


def test_rgb_to_y_and_reference_warp_match_jax():
    from tecogan_tpu import ops as jax_ops
    from tecogan_tpu_torch import ops

    img = _rng_images((4, 6, 3)) * 255
    np.testing.assert_array_equal(ops.rgb_to_y_bt601(img.astype(np.float64)),
                                  jax_ops.rgb_to_y_bt601(img.astype(np.float64)))
    np.testing.assert_allclose(ops.rgb_to_y_bt601(torch.from_numpy(img)).numpy(),
                               np.asarray(jax_ops.rgb_to_y_bt601(jnp.asarray(img))),
                               rtol=1e-6)
    image = _rng_images((2, 9, 11, 3), 1)
    flow = (np.random.RandomState(2).randn(2, 9, 11, 2) * 3).astype(np.float32)
    np.testing.assert_allclose(
        ops.dense_image_warp_reference(torch.from_numpy(image), torch.from_numpy(flow)).numpy(),
        np.asarray(jax_ops.dense_image_warp_reference(jnp.asarray(image), jnp.asarray(flow))),
        rtol=0, atol=1e-6)


def test_alexnet_features_and_lpips_distance_match_jax():
    from tecogan_tpu.eval import lpips as jax_lpips
    from tecogan_tpu_torch import eval as port_eval
    from tecogan_tpu_torch.eval.lpips import random_alexnet_params

    params = random_alexnet_params(3)
    lin = [np.random.RandomState(i).rand(c).astype(np.float32)
           for i, c in enumerate([64, 192, 384, 256, 256])]
    x = _rng_images((2, 64, 64, 3), 4) * 2 - 1
    y = _rng_images((2, 64, 64, 3), 5) * 2 - 1
    got = port_eval.alexnet_features(params, x)
    want = jax_lpips.alexnet_features(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * max(1.0, np.abs(w).max()))
    d = port_eval.lpips_distance(params, lin, x, y)
    d_want = np.asarray(jax_lpips.lpips_distance(params, lin, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(d.numpy(), d_want, rtol=1e-5)


def test_tee_and_vgg19_normalized_features_are_the_ports():
    from tecogan_tpu_torch import eval as port_eval
    from tecogan_tpu_torch import models
    from tecogan_tpu_torch.models.vgg19 import vgg19_normalized_features
    from tecogan_tpu_torch.utils.logging import Tee

    assert port_eval.Tee is Tee
    assert models.vgg19_normalized_features is vgg19_normalized_features
