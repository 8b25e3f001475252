"""The port's TecoConfig and presets against the JAX package's."""

import dataclasses

import pytest
import torch

from tecogan_tpu import config as jax_config
from tecogan_tpu_torch import config

# Fields the JAX package has and the port leaves out: TPU tuning modes, mesh
# axis names, and the parameter dtype (the port keeps float32 parameters).
JAX_ONLY = {"inline_flow", "fold_input_s2d", "train_fold_s2d",
            "pallas_flow_upsample", "fused_trunk", "dp_axis", "sp_axis",
            "param_dtype"}


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


@pytest.mark.parametrize("package", ["data", "utils"])
def test_package_exports_match_jax(package):
    """``tecogan_tpu_torch.data`` and ``.utils`` export the JAX package's
    names (``tecogan_tpu/data/__init__.py``, ``tecogan_tpu/utils/__init__.py``),
    each bound to the port's own object."""
    import importlib

    ours = importlib.import_module(f"tecogan_tpu_torch.{package}")
    theirs = importlib.import_module(f"tecogan_tpu.{package}")
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        assert getattr(ours, name).__module__.startswith("tecogan_tpu_torch."), name
