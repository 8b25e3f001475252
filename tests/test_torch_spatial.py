"""The port's spatial sharding (``tecogan_tpu_torch/parallel/spatial.py``
and ``ops/warp.py:warp_space_to_depth_halo``) against its own unsharded
path and the JAX package's ``tecogan_tpu.parallel`` on the conftest's 8
virtual CPU devices. The port's shards are the CPU standing for N devices
(``make_mesh(..., "cpu")``).

Sizes: 2 residual blocks at 16 channels, LR frames of 32-64 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.ops.warp import warp_space_to_depth as jax_warp_s2d
from tecogan_tpu.ops.warp import warp_space_to_depth_halo as jax_warp_s2d_halo
from tecogan_tpu.parallel import make_mesh as jax_make_mesh
from tecogan_tpu.parallel import spatial_streaming_fn as jax_spatial_streaming_fn
from tecogan_tpu.recurrent.inference import StreamingSR as JaxStreamingSR
from tecogan_tpu.recurrent.step import init_state as jax_init_state
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.ops.warp import warp_space_to_depth, warp_space_to_depth_halo
from tecogan_tpu_torch.parallel import make_mesh, spatial_streaming_fn
from tecogan_tpu_torch.parallel.spatial import CHAIN_HALO_BLOCKS, shard_rows
from tecogan_tpu_torch.recurrent import StreamingSR, frame_step, init_state
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

MD = 6.0  # the warp tests' flow bound: halo 7 < shard height 8
RESBLOCKS, CHANNELS = 2, 16
# Against the JAX package: tests/test_parallel.py's tolerance for its own
# sharded path (float32 convolutions in another summation order).
RTOL, ATOL = 1e-4, 1e-5


def _warp_inputs(seed, b, h, w, md=MD):
    rng = np.random.RandomState(seed)
    image = rng.rand(b, h, w, 3).astype(np.float32)
    flow = (rng.rand(b, h, w, 2) * 2 * md - md).astype(np.float32)
    return image, flow


# ------------------------------------------------------------------ halo warp
@pytest.mark.parametrize("shards,shape,flow", [
    (8, (2, 64, 48), "random"), (4, (1, 32, 32), "random"), (2, (1, 64, 16), "random"),
    (8, (1, 64, 48), "up"), (8, (1, 64, 48), "down")],
    ids=["8-random", "4-random", "2-random", "8-clamp-up", "8-clamp-down"])
def test_halo_warp_bit_equal_to_unsharded_and_jax(shards, shape, flow):
    """Bit-equal to the unsharded warp, and at 2 and 4 shards to the JAX
    package's halo warp (its shard_map compiles for seconds, so not at
    every case);
    constant +-MD flows push the edge rows off the frame on both sides (the
    global edge clamp across shard boundaries)."""
    b, h, w = shape
    image, rand_flow = _warp_inputs(shards, b, h, w)
    flow = {"random": rand_flow, "up": np.full((b, h, w, 2), -MD, np.float32),
            "down": np.full((b, h, w, 2), MD, np.float32)}[flow]
    want = warp_space_to_depth(torch.from_numpy(image), torch.from_numpy(flow), 4)
    got = warp_space_to_depth_halo(torch.from_numpy(image), torch.from_numpy(flow),
                                   make_mesh({"space": shards}, "cpu"), "space", 4,
                                   max_displacement=MD)
    assert torch.equal(got, want)
    if shards == 8:
        return
    # Eagerly, as tests/test_spatial_halo.py calls it: under jax.jit XLA
    # contracts the lerp into FMAs, a float32 ulp away.
    jmesh = jax_make_mesh({"space": shards})
    theirs = jax_warp_s2d_halo(jnp.asarray(image), jnp.asarray(flow), jmesh, "space", 4,
                               max_displacement=MD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs))


def test_halo_warp_scale_shift_and_shards():
    """scale/shift as the unsharded warp and JAX's; lists of unequal shards
    (the spatial path's remainder on the last) give the unsharded rows."""
    image, flow = _warp_inputs(1, 1, 32, 32)
    ti, tf = torch.from_numpy(image), torch.from_numpy(flow)
    want = warp_space_to_depth(ti, tf, 4, scale=0.5, shift=0.5)
    got = warp_space_to_depth_halo(ti, tf, make_mesh({"space": 4}, "cpu"), "space", 4,
                                   scale=0.5, shift=0.5, max_displacement=MD)
    assert torch.equal(got, want)
    theirs = jax_warp_s2d(jnp.asarray(image), jnp.asarray(flow), 4, scale=0.5, shift=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs))
    rows = [8, 24]
    parts = warp_space_to_depth_halo([ti[:, :8], ti[:, 8:]], [tf[:, :8], tf[:, 8:]],
                                     None, "space", 4, max_displacement=MD)
    assert [p.shape[1] for p in parts] == [r // 4 for r in rows]
    assert torch.equal(torch.cat(parts, dim=1), warp_space_to_depth(ti, tf, 4))


def test_halo_warp_rejects_small_shards_and_uneven_frames():
    mesh = make_mesh({"space": 8}, "cpu")
    zeros = torch.zeros((1, 64, 48, 3)), torch.zeros((1, 64, 48, 2))
    with pytest.raises(ValueError, match="halo"):
        warp_space_to_depth_halo(*zeros, mesh, "space", 4, max_displacement=16.0)
    with pytest.raises(ValueError, match="divide into 8 shards"):
        warp_space_to_depth_halo(torch.zeros((1, 60, 48, 3)), torch.zeros((1, 60, 48, 2)),
                                 mesh, "space", 4, max_displacement=MD)


# ------------------------------------------------------------ sharded streaming
@pytest.fixture(scope="module")
def weights():
    """JAX initialisations plus seeded noise (non-zero biases), and the
    port's modules from them."""
    rng = np.random.RandomState(0)
    jgen = JaxGenerator(num_resblock=RESBLOCKS, channels=CHANNELS)
    jfnet = JaxFNet()
    gp = jax.jit(jgen.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(jfnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    gp, fp = (jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))
    return jgen, jfnet, gp, fp


@pytest.mark.parametrize("h,w,shards,md", [(32, 16, 4, 96.0), (40, 16, 2, 96.0),
                                           (64, 16, 2, 24.0)],
                         ids=["4-shards", "40-rows", "halo-warp"])
def test_spatial_streaming_matches_unsharded_and_jax(weights, h, w, shards, md):
    """``spatial_streaming_fn`` against the port's unsharded frame step and
    the JAX package's ``spatial_streaming_fn``: 32 rows over 4 shards, 40
    rows over 2 (not a multiple of 8 x 2: the last shard takes 24 rows),
    and 64 rows over 2 with a flow bound whose halo the shards exceed (the
    halo warp; the others gather the frame for the warp)."""
    jgen, jfnet, gp, fp = weights
    frames = np.random.RandomState(h + shards).rand(3, 1, h, w, 3).astype(np.float32)
    gen, fnet = from_jax_params(gp, fp)
    gen.eval(), fnet.eval()
    with torch.inference_mode():
        st, outs = init_state(1, h, w, torch.float32, "cpu"), []
        for lr in torch.from_numpy(frames):
            st, hr = frame_step(gen, fnet, st, lr)
            outs.append(hr)
        plain = torch.stack(outs)
    run = spatial_streaming_fn(gen, fnet, make_mesh({"space": shards}, "cpu"),
                               max_displacement=md)
    state, got = run(init_state(1, h, w, torch.float32, "cpu"), torch.from_numpy(frames))
    assert got.shape == (3, 1, 4 * h, 4 * w, 3) and state.prev_hr.shape == (1, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
    halo = int(md) + 1
    uses_halo = min(shard_rows(h, shards)) * 4 > halo
    assert (run.step.halo_warps, run.step.gather_warps) == ((3, 0) if uses_halo else (0, 3))

    jrun = jax_spatial_streaming_fn(jgen.apply, jfnet.apply, jax_make_mesh({"space": shards}),
                                    max_displacement=md)
    _, want = jrun(gp, fp, jax_init_state(1, h, w), jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("output", ["float32", "uint8"])
def test_streaming_sr_spatial_mesh_matches_jax(weights, output):
    """``StreamingSR(spatial_mesh=...)``, 32 rows over 4 shards, chunks of 4
    with a ragged last one, against the port's unsharded run and the JAX
    package's ``StreamingSR(spatial_mesh=...)``; uint8 within one level."""
    _, _, gp, fp = weights
    h = w = 32
    frames = np.random.RandomState(5).rand(6, h, w, 3).astype(np.float32)
    if output == "uint8":
        frames = (frames * 255).astype(np.uint8)
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS, infer_chunk=4)
    plain, _ = StreamingSR(cfg, *from_jax_params(gp, fp), output=output,
                           device="cpu").run(frames, warmup=1)
    sr = StreamingSR(cfg, *from_jax_params(gp, fp), output=output, device="cpu",
                     spatial_mesh=make_mesh({cfg.sp_axis: 4}, "cpu"))
    got, _ = sr.run(frames, warmup=1)
    jcfg = JaxConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS, infer_chunk=4,
                     fold_input_s2d="off")
    want, _ = JaxStreamingSR(jcfg, gp, fp, output=output,
                             spatial_mesh=jax_make_mesh({jcfg.sp_axis: 4})).run(frames, warmup=1)
    assert got.shape == plain.shape == want.shape == (5, 4 * h, 4 * w, 3)
    if output == "uint8":
        for ref in (plain, want):
            assert np.abs(got.astype(np.int16) - ref).max() <= 1
    else:
        np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    again, _ = sr.run(frames, warmup=1)  # the state is zeroed per run
    assert np.array_equal(again, got)


def test_spatial_geometry_errors(weights):
    """Shards thinner than FNet's 8 rows raise, and so does a capture asked
    for on a mesh the card cannot capture: on the CPU (no CUDA graphs) and
    across distinct cards (ROADMAP item 11c, refused before the models
    move); the halo depth is the documented one."""
    _, _, gp, fp = weights
    gen, fnet = from_jax_params(gp, fp)
    assert shard_rows(40, 2) == [16, 24] and shard_rows(144, 2) == [72, 72]
    with pytest.raises(ValueError, match="at most 3 shards"):
        shard_rows(24, 4)
    run = spatial_streaming_fn(gen, fnet, make_mesh({"space": 4}, "cpu"))
    assert run.step.chain_blocks == min(CHAIN_HALO_BLOCKS, RESBLOCKS)
    with pytest.raises(ValueError, match="8 rows"):
        run(init_state(1, 24, 16, torch.float32, "cpu"), torch.zeros((1, 1, 24, 16, 3)))
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        StreamingSR(cfg, gen, fnet, device="cpu", capture=True,
                    spatial_mesh=make_mesh({cfg.sp_axis: 2}, "cpu"))
    with pytest.raises(ValueError, match="ROADMAP item 11c"):
        StreamingSR(cfg, gen, fnet, capture=True,
                    spatial_mesh=make_mesh({cfg.sp_axis: 2}, ["cuda:0", "cuda:1"]))
