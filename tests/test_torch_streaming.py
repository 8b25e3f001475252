"""The port's streaming 4x inference against the JAX package's
``StreamingSR`` on a seeded synthetic clip, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.recurrent.inference import StreamingSR as JaxStreamingSR
from tecogan_tpu.recurrent.inference import prepend_warmup as jax_prepend_warmup
from tecogan_tpu.recurrent.step import RecurrentState as JaxRecurrentState
from tecogan_tpu.recurrent.step import frame_step as jax_frame_step
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.recurrent import (
    RecurrentState,
    StreamingSR,
    frame_step,
    prepend_warmup,
)
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

T, H, W = 12, 32, 48
WARMUP, CHUNK = 5, 5          # chunks of 5, 5 and a ragged 2
RESBLOCKS, CHANNELS = 3, 16
# float32 HR frames: float32 convs in another summation order, carried
# through the recurrence; outputs are O(1).
FLOAT_ATOL = 1e-5
# uint8 frames: the port divides by 255 where XLA multiplies by the
# reciprocal (1 ulp), and the float drift above can cross a rounding step:
# at most 1 step, on at most this share of the values.
U8_MAX_FLIPPED = 1e-3


def _clip(seed):
    """A smooth pattern panning by one pixel per frame, with noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W + T), indexing="ij")
    base = np.stack([np.sin(xx / 3.0 + c) * np.cos(yy / 4.0 - c)
                     for c in range(3)], axis=-1)
    frames = np.stack([base[:, t:t + W] for t in range(T)])
    frames = 0.5 + 0.4 * frames + 0.05 * rng.randn(T, H, W, 3)
    return np.clip(frames, 0.0, 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.RandomState(0)
    jgen = JaxGenerator(num_resblock=RESBLOCKS, channels=CHANNELS)
    jfnet = JaxFNet()
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(jfnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    gp, fp = (jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))
    jcfg = JaxConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS,
                     infer_chunk=CHUNK, fold_input_s2d="off")
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS,
                     infer_chunk=CHUNK)

    def make(output):
        jax_sr = JaxStreamingSR(jcfg, gp, fp, output=output)
        sr = StreamingSR(cfg, *from_jax_params(gp, fp), output=output, device="cpu")
        return jax_sr, sr

    return make


def test_streaming_float32_matches_jax(engines):
    jax_sr, sr = engines("float32")
    frames = _clip(1)
    want, _ = jax_sr.run(frames, warmup=WARMUP)
    got, secs = sr.run(frames, warmup=WARMUP)
    assert got.shape == want.shape == (T - WARMUP, 4 * H, 4 * W, 3)
    assert got.dtype == np.float32 and secs > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


def test_streaming_uint8_matches_jax(engines):
    jax_sr, sr = engines("uint8")
    frames = (_clip(2) * 255).astype(np.uint8)
    want, _ = jax_sr.run(frames, warmup=WARMUP)
    got, _ = sr.run(frames, warmup=WARMUP)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= U8_MAX_FLIPPED, (diff != 0).mean()
    assert got.std() > 1.0  # not a saturated or constant image


def test_streaming_on_chunk_delivery(engines):
    """on_chunk gets every post-warm-up frame once, in order."""
    _, sr = engines("uint8")
    frames = (_clip(3) * 255).astype(np.uint8)
    want, _ = sr.run(frames, warmup=WARMUP)
    got = []
    res, _ = sr.run(frames, warmup=WARMUP,
                    on_chunk=lambda hr, start: got.append((start, hr)))
    assert res is None
    assert [s for s, _ in got] == [5, 10]
    np.testing.assert_array_equal(np.concatenate([hr for _, hr in got]), want)


def test_run_streams_matches_jax(engines):
    jax_sr, sr = engines("float32")
    streams = np.stack([_clip(4), _clip(5)])[:, :7]
    want, _ = jax_sr.run_streams(streams, warmup=2)
    got, _ = sr.run_streams(streams, warmup=2)
    assert got.shape == want.shape == (2, 5, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


def test_frame_step_matches_jax(engines, rng):
    """One recurrent step from a non-zero state, through FNet, the flow
    upsample, the warp and the generator."""
    jax_sr, sr = engines("float32")
    prev_lr, lr = _clip(6)[:2]
    prev_hr = rng.rand(1, 4 * H, 4 * W, 3).astype(np.float32)
    _, j_hr = jax_frame_step(
        jax_sr.generator.apply, jax_sr.fnet.apply, jax_sr.gen_params,
        jax_sr.fnet_params,
        JaxRecurrentState(jnp.asarray(prev_lr[None]), jnp.asarray(prev_hr)),
        jnp.asarray(lr[None]))
    state = RecurrentState(torch.from_numpy(prev_lr[None]), torch.from_numpy(prev_hr))
    with torch.no_grad():
        new_state, hr = frame_step(sr.generator, sr.fnet, state,
                                   torch.from_numpy(lr[None]))
    np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_array_equal(new_state.prev_lr.numpy(), lr[None])
    np.testing.assert_array_equal(new_state.prev_hr.numpy(), hr.numpy())


def test_prepend_warmup_matches_jax():
    frames = list(range(9))
    assert prepend_warmup(frames) == jax_prepend_warmup(frames)


def test_entry_points_default_to_the_card():
    """StreamingSR, the servers and the export run on the card unless the
    caller asks for the CPU."""
    import inspect

    from tecogan_tpu_torch.serve import MultiGeometryServer, VSRServer, export_frame_step

    for fn in (StreamingSR, VSRServer, MultiGeometryServer, export_frame_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
