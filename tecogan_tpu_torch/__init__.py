"""PyTorch + CUDA port of ``tecogan_tpu``: streaming 4x video
super-resolution on an NVIDIA Hopper GPU.

The module layout mirrors the JAX package's. Public ops and kernels keep
its NHWC layout. The kernels (``kernels/``, sources in ``csrc/``) are built
with ``nvcc`` at first use on a CUDA tensor; on the CPU every kernel
wrapper runs its plain PyTorch version.

This package imports no JAX.
"""

__version__ = "0.1.0"
