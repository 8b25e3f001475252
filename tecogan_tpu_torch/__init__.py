"""PyTorch + CUDA port of ``tecogan_tpu``: streaming 4x video
super-resolution on an NVIDIA Hopper GPU.

The module layout mirrors the JAX package's. Public ops and kernels keep
its NHWC layout. The kernels (``kernels/``, sources in ``csrc/``) are built
with ``nvcc`` at first use on a CUDA tensor; on the CPU every kernel
wrapper runs its plain PyTorch version.

This package imports no JAX. Its top level exports the JAX package's: the
configuration and its presets.
"""

from tecogan_tpu_torch.config import FRVSR_PRESET, MINI_PRESET, TECOGAN_PRESET, TecoConfig

__version__ = "0.1.0"

__all__ = [
    "TecoConfig",
    "FRVSR_PRESET",
    "TECOGAN_PRESET",
    "MINI_PRESET",
]
