"""Port models (FNet, Generator) against the flax modules, with the flax
weights carried across by ``tecogan_tpu_torch.weights``; float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.train.checkpoint import params_to_npz
from tecogan_tpu_torch.weights import (
    detect_num_resblock,
    from_jax_params,
    read_params_npz,
)

torch.set_num_threads(1)

# Generator output in [-1, 1]-ish: float32 convs in another summation order.
GEN_ATOL = 1e-5
# FNet output is tanh * 24: the same float32 drift in the pre-activations,
# scaled by up to 24 where tanh is not saturated.
FNET_ATOL = 24 * 2e-5


def _noisy(tree, rng, scale=0.02):
    """flax init plus seeded noise, so biases are non-zero too."""
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * scale).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    jgen = JaxGenerator(num_resblock=2, channels=16)
    jfnet = JaxFNet()
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))
    fp = jax.jit(jfnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))
    gp, fp = _noisy(gp["params"], rng), _noisy(fp["params"], rng)
    gen, fnet = from_jax_params(gp, fp)
    return jgen, jfnet, gp, fp, gen, fnet


@pytest.mark.parametrize("size", [(32, 32), (20, 28)])
def test_fnet_matches_flax(models, size, rng):
    """20x28 is not a multiple of 8: the maxpools floor, the flow comes back
    16x24."""
    _, jfnet, _, fp, _, fnet = models
    x = rng.rand(2, *size, 6).astype(np.float32)
    want = np.asarray(jax.jit(jfnet.apply)({"params": fp}, jnp.asarray(x)))
    with torch.no_grad():
        got = fnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, size[0] // 8 * 8, size[1] // 8 * 8, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FNET_ATOL)


@pytest.mark.parametrize("size", [(32, 32), (20, 28)])
def test_generator_matches_flax(models, size, rng):
    jgen, _, gp, _, gen, _ = models
    x = rng.rand(2, *size, 51).astype(np.float32)
    want = np.asarray(jax.jit(jgen.apply)({"params": gp}, jnp.asarray(x)))
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4 * size[0], 4 * size[1], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=GEN_ATOL)


def test_params_npz_round_trip(models, tmp_path, rng):
    """A params_to_npz file written by the JAX package loads into modules
    identical to those built from the trees directly."""
    _, _, gp, fp, gen, fnet = models
    path = str(tmp_path / "params.npz")
    params_to_npz(path, generator=gp, fnet=fp)
    trees = read_params_npz(path)
    assert set(trees) == {"generator", "fnet"}
    gen2, fnet2 = from_jax_params(trees["generator"], trees["fnet"])
    for a, b in ((gen, gen2), (fnet, fnet2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    np.testing.assert_array_equal(
        gen2.input_stage_conv.weight.detach().numpy(),
        np.asarray(gp["input_stage_conv"]["kernel"]).transpose(3, 2, 0, 1))
    assert len(gen2.resblocks) == detect_num_resblock(trees["generator"]) == 2


def test_detect_num_resblock_raises_on_zero():
    with pytest.raises(ValueError):
        detect_num_resblock({"input_stage_conv": {}})
    assert detect_num_resblock(
        {f"resblock_{i}_conv_{j}": {} for i in (1, 2, 3) for j in (1, 2)}) == 3
