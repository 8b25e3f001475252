"""The port's two-stage pipeline (``tecogan_tpu_torch/parallel/pipeline.py``)
against its own ``StreamingSR`` and the JAX package's
``PipelinedStreamingSR`` on the conftest's virtual CPU devices, and the
inference CLI's ``--pipeline`` and ``--spatial_shards`` against the JAX
CLI's, on the CPU.

Sizes: 2 residual blocks, LR 16x16 (the pipeline) and 32x32 (the CLI).
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import main as jax_cli
from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.parallel import PipelinedStreamingSR as JaxPipelinedStreamingSR
from tecogan_tpu.train.checkpoint import params_to_npz as jax_params_to_npz
from tecogan_tpu_torch.cli.main import main
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.synthetic import synthetic_clip
from tecogan_tpu_torch.parallel import PipelinedStreamingSR
from tecogan_tpu_torch.recurrent import StreamingSR
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

RESBLOCKS = 2
# Against the JAX package (tests/test_pipeline.py's own tolerance between
# its two engines): float32 convolutions in another summation order.
RTOL, ATOL = 1e-5, 1e-5
# uint8 frames: at most one level, on at most 0.1% of the values (the float
# drift above can cross a rounding step; tests/test_torch_cli.py).
U8_MAX_FLIPPED = 1e-3


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=RESBLOCKS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    return tuple(jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))


def _cpu_pipeline(cfg, gp, fp, output):
    return PipelinedStreamingSR(cfg, *from_jax_params(gp, fp), output=output,
                                flow_device="cpu", recurrent_device="cpu")


@pytest.mark.parametrize("output", ["float32", "uint8"])
def test_pipeline_equals_streaming_and_matches_jax(weights, output):
    """8 frames in chunks of 3 (a ragged last chunk): equal to the port's
    ``StreamingSR`` (the same ops in the same order), and to the JAX
    package's pipeline over two of its virtual devices."""
    gp, fp = weights
    cfg = TecoConfig(num_resblock=RESBLOCKS, infer_chunk=3)
    frames = np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)
    want, _ = StreamingSR(cfg, *from_jax_params(gp, fp), output=output,
                          device="cpu").run(frames, warmup=2)
    pipe = _cpu_pipeline(cfg, gp, fp, output)
    got, secs = pipe.run(frames, warmup=2)
    assert got.dtype == want.dtype and got.shape == want.shape == (6, 64, 64, 3) and secs > 0
    np.testing.assert_array_equal(got, want)
    chunks = []
    none, _ = pipe.run(frames, warmup=2, on_chunk=lambda hr, s: chunks.append((s, hr)))
    assert none is None and [s for s, _ in chunks] == [2, 3, 6]
    np.testing.assert_array_equal(np.concatenate([hr for _, hr in chunks]), got)

    jcfg = JaxConfig(num_resblock=RESBLOCKS, infer_chunk=3, fold_input_s2d="off")
    jax_pipe = JaxPipelinedStreamingSR(jcfg, gp, fp, output=output)
    assert jax_pipe.flow_device != jax_pipe.recurrent_device
    theirs, _ = jax_pipe.run(frames, warmup=2)
    if output == "float32":
        np.testing.assert_allclose(got, theirs, rtol=RTOL, atol=ATOL)
    else:
        diff = np.abs(got.astype(np.int16) - theirs)
        assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED


def test_pipeline_needs_two_devices(weights, monkeypatch):
    """No devices named and fewer than two CUDA devices: JAX's error; the
    two stages on the CPU and the card at once: refused."""
    gp, fp = weights
    cfg = TecoConfig(num_resblock=RESBLOCKS)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two devices; have 1"):
        PipelinedStreamingSR(cfg, *from_jax_params(gp, fp))
    with pytest.raises(ValueError, match="output"):
        PipelinedStreamingSR(cfg, *from_jax_params(gp, fp), output="float16",
                             flow_device="cpu", recurrent_device="cpu")


def _clip_dir(root, t=6, h=32, w=32):
    d = os.path.join(root, "lr")
    os.makedirs(d)
    clip = (synthetic_clip(t, h, w, seed=3, content="natural") * 255).astype(np.uint8)
    for i, frame in enumerate(clip):
        cv2.imwrite(os.path.join(d, f"im{i + 1}.png"), frame[:, :, ::-1])
    return d


def _read_dir(d):
    names = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return names, np.stack([cv2.imread(os.path.join(d, f))[..., ::-1] for f in names])


@pytest.mark.parametrize("flags", [["--pipeline"], ["--spatial_shards", "2"]],
                         ids=["pipeline", "spatial"])
def test_cli_parallel_flags_match_jax_cli(tmp_path, weights, capsys, monkeypatch, flags):
    """``--pipeline`` and ``--spatial_shards 2`` with ``--device cpu``: the
    written PNGs against the JAX CLI's with the same flag on its virtual
    devices, within one level."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    gp, fp = weights
    npz = str(tmp_path / "params.npz")
    jax_params_to_npz(npz, generator=gp, fnet=fp)
    lr = _clip_dir(str(tmp_path))
    common = ["--mode", "inference", "--input_dir_LR", lr, "--params_npz", npz,
              "--infer_chunk", "4"] + flags
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax"), "--num_resblock", "2"])
    capsys.readouterr()
    stats = main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "port"),
                           "--queue_thread", "1"])
    assert stats["written"] == 6 and stats["frames"] == 11
    names, got = _read_dir(tmp_path / "port")
    jax_names, want = _read_dir(tmp_path / "jax")
    assert names == jax_names == [f"output_{i:04d}.png" for i in range(6)]
    diff = np.abs(got.astype(np.int16) - want)
    assert got.shape == (6, 128, 128, 3) and got.std() > 1.0
    assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED


def test_cli_parallel_flags_are_exclusive(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["--mode", "inference", "--device", "cpu", "--output_dir", str(tmp_path),
              "--pipeline", "--spatial_shards", "2", "--allow_random_weights",
              "--input_dir_LR", str(tmp_path)])
