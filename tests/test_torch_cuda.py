"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without an NVIDIA GPU (the kernels have no CPU mode). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.kernels import (
    resblock_chain,
    resblock_chain_plain,
    upsample4,
    upsample4_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tensor(rng, shape, scale, device):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_upsample4_kernel_matches_plain(cuda_device, filt):
    """float32 at a ragged shape; tolerance: FMA contraction in the kernel,
    a few float32 ulps of values up to ~20."""
    rng = np.random.RandomState(0)
    x = _tensor(rng, (2, 37, 53, 3), 1.0, cuda_device)
    torch.testing.assert_close(upsample4(x, filt, alpha=4.0),
                               upsample4_plain(x, filt, alpha=4.0),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_resblock_chain_kernel_matches_plain(cuda_device):
    """float32 at a ragged shape (partial tiles on both axes), 3 blocks,
    batch 2; tolerance: float32 sums in another order over 6 convs."""
    rng = np.random.RandomState(1)
    c, n = 64, 3
    x = _tensor(rng, (2, 37, 53, c), 0.5, cuda_device)
    w1 = _tensor(rng, (n, 3, 3, c, c), 0.04, cuda_device)
    w2 = _tensor(rng, (n, 3, 3, c, c), 0.04, cuda_device)
    b1 = _tensor(rng, (n, c), 0.1, cuda_device)
    b2 = _tensor(rng, (n, c), 0.1, cuda_device)
    before = x.clone()
    got = resblock_chain(x, w1, b1, w2, b2)
    torch.testing.assert_close(got, resblock_chain_plain(x, w1, b1, w2, b2),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(x, before, rtol=0, atol=0)  # input untouched


@pytest.mark.cuda
def test_resblock_chain_rejects_other_widths(cuda_device):
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    w = torch.zeros(1, 3, 3, 32, 32, device=cuda_device)
    b = torch.zeros(1, 32, device=cuda_device)
    with pytest.raises(ValueError):
        resblock_chain(x, w, b, w, b)
