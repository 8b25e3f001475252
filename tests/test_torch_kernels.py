"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that plain version to the Pallas kernels it replaces, run in interpret mode
(K1 ``_upsample4_pallas``; K3 ``_fused_chain_single``; K4 and K5 through
``resblock_chain_paired_banded``), as ``tests/test_kernels.py`` runs them.
The CUDA kernels themselves are compared with the plain versions on the
card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tecogan_tpu.kernels.resblocks as jax_chain
import tecogan_tpu.kernels.upsample4 as jax_up
from tecogan_tpu_torch.kernels import (
    resblock_chain,
    resblock_chain_plain,
    upsample4,
    upsample4_plain,
)

torch.set_num_threads(1)

# float32 throughout. K1: the Pallas kernel's two float32 matmuls vs the
# port's per-axis tap sums, values in [0, 4]. The chain: float32 convs in
# another summation order, compounded over 3-4 blocks (the JAX package's
# own banded-chain test uses 1e-4).
UPSAMPLE_ATOL = 1e-5
CHAIN_ATOL = 1e-4


def _interpret(module):
    return mock.patch.object(module.pl, "pallas_call",
                             functools.partial(pl.pallas_call, interpret=True))


def _chain_inputs(rng, b, h, w, c, n):
    x = (rng.rand(b, h, w, c) - 0.5).astype(np.float32)
    w1 = (rng.randn(n, 3, 3, c, c) * 0.1).astype(np.float32)
    w2 = (rng.randn(n, 3, 3, c, c) * 0.1).astype(np.float32)
    b1 = (rng.randn(n, c) * 0.1).astype(np.float32)
    b2 = (rng.randn(n, c) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _plain_chain(*arrays):
    return resblock_chain_plain(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_upsample4_plain_matches_pallas_k1(filt, rng):
    x = rng.rand(2, 12, 16, 3).astype(np.float32)
    with _interpret(jax_up):
        want = np.asarray(jax_up._upsample4_pallas(jnp.asarray(x), filt))
        want4 = np.asarray(jax_up._upsample4_pallas(jnp.asarray(4 * x), filt))
    got = upsample4_plain(torch.from_numpy(x), filt).numpy()
    assert got.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=UPSAMPLE_ATOL)
    # alpha folds the flow's x4 scale into the upsample.
    got4 = upsample4_plain(torch.from_numpy(x), filt, alpha=4.0).numpy()
    np.testing.assert_allclose(got4, want4, rtol=0, atol=4 * UPSAMPLE_ATOL)


def test_chain_plain_matches_pallas_k3(rng):
    arrays = _chain_inputs(rng, 1, 16, 12, 8, 3)
    x, w1, b1, w2, b2 = map(jnp.asarray, arrays)
    with _interpret(jax_chain):
        taps = jax_chain._taps(w1, b1, w2, b2)
        want = np.asarray(jax_chain._fused_chain_single(x[0], *taps, tile_rows=4))
    np.testing.assert_allclose(_plain_chain(*arrays)[0], want,
                               rtol=0, atol=CHAIN_ATOL)


@pytest.mark.parametrize("use_v2", [False, True], ids=["k4", "k5"])
def test_chain_plain_matches_pallas_paired(use_v2, rng):
    """K4 (pair-packed) and K5 (pair-packed, shifted copies), row-banded
    with sub-chains of 2 blocks."""
    arrays = _chain_inputs(rng, 1, 40, 12, 8, 4)
    with _interpret(jax_chain):
        want = np.asarray(jax_chain.resblock_chain_paired_banded(
            *map(jnp.asarray, arrays), band_rows=16, chunk=2, use_v2=use_v2))
    np.testing.assert_allclose(_plain_chain(*arrays), want,
                               rtol=0, atol=CHAIN_ATOL)


def test_chain_plain_matches_xla_oracle(rng):
    arrays = _chain_inputs(rng, 2, 9, 13, 8, 2)
    want = np.asarray(jax_chain.resblock_chain_xla(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(_plain_chain(*arrays), want,
                               rtol=0, atol=CHAIN_ATOL)


def test_cpu_tensors_take_the_plain_path(rng, monkeypatch):
    monkeypatch.setattr(upsample4, "launches", 0)
    monkeypatch.setattr(resblock_chain, "launches", 0)
    x = torch.from_numpy(rng.rand(1, 5, 6, 2).astype(np.float32))
    for filt in ("bilinear", "bicubic"):
        torch.testing.assert_close(upsample4(x, filt, alpha=4.0),
                                   upsample4_plain(x, filt, alpha=4.0),
                                   rtol=0, atol=0)
    arrays = [torch.from_numpy(a) for a in _chain_inputs(rng, 1, 7, 5, 64, 2)]
    torch.testing.assert_close(resblock_chain(*arrays),
                               resblock_chain_plain(*arrays), rtol=0, atol=0)
    assert upsample4.launches == 0
    assert resblock_chain.launches == 0


def test_wrappers_reject_other_devices_and_filters():
    x = torch.empty(1, 4, 4, 64, device="meta")
    w = torch.empty(1, 3, 3, 64, 64, device="meta")
    b = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError):
        upsample4(x)
    with pytest.raises(ValueError):
        resblock_chain(x, w, b, w, b)
    with pytest.raises(ValueError):
        upsample4(torch.zeros(1, 4, 4, 2), "nearest")

