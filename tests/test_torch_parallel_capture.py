"""Capture of the parallel streaming paths, on the CPU: the route a
spatially sharded ``StreamingSR`` takes (one captured graph where every
shard sits on one device, eager across devices, ROADMAP item 11c), the
capturing branch of the sharded chunk and of the pipeline's two stages with
the graph stood in for, and the pipeline's static buffers over several
runs against the port's ``StreamingSR`` and the JAX package's
``PipelinedStreamingSR``.

Sizes: 2 residual blocks, LR 16x16 (the pipeline) and 32x16 (2 shards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.parallel import PipelinedStreamingSR as JaxPipelinedStreamingSR
from tecogan_tpu.parallel import make_mesh as jax_make_mesh
from tecogan_tpu.recurrent.inference import StreamingSR as JaxStreamingSR
from tecogan_tpu_torch import parallel as parallel_package
from tecogan_tpu_torch.cli import main as cli_main
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.parallel import PipelinedStreamingSR, make_mesh
from tecogan_tpu_torch.parallel import pipeline as pipeline_module
from tecogan_tpu_torch.parallel.spatial import sharded_capture
from tecogan_tpu_torch.recurrent import StreamingSR
from tecogan_tpu_torch.recurrent import inference as inference_module
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

RESBLOCKS = 2
# Against the JAX package: tests/test_pipeline.py's and
# tests/test_parallel.py's tolerances between its own engines (float32
# convolutions in another summation order).
PIPE_RTOL, PIPE_ATOL = 1e-5, 1e-5
SPATIAL_RTOL, SPATIAL_ATOL = 1e-4, 1e-5

CUDA0, CUDA1, CPU = torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cpu")


# ------------------------------------------------------------ the route
@pytest.mark.parametrize("devices,capture,captured,says", [
    ([CUDA0, CUDA0], None, True, "captured CUDA graphs on cuda:0, 2 row shards"),
    ([CUDA0, CUDA0, CUDA0], True, True, "captured CUDA graphs on cuda:0, 3 row shards"),
    ([CUDA0, CUDA0], False, False, "eager on cuda:0 (capture=False)"),
    ([CUDA0, CUDA1], None, False, "2 distinct devices (cuda:0, cuda:1)"),
    ([CUDA0, CUDA0, CUDA1], False, False, "ROADMAP item 11c"),
    ([CPU, CPU], None, False, "eager on cpu (CUDA graphs exist only on the card)"),
], ids=["one-card", "one-card-true", "one-card-false", "two-cards", "mixed-false", "cpu"])
def test_sharded_capture_decides_from_the_devices(devices, capture, captured, says):
    """Every shard on one device: as ``resolve_capture``; shards on
    distinct devices: eager, saying why (item 11c). Built from
    ``torch.device`` objects alone: nothing touches a card."""
    got, route = sharded_capture(capture, devices)
    assert got is captured
    assert says in route


def test_sharded_capture_refusals():
    """``capture=True`` across cards names item 11c; on the CPU it raises
    as every entry point does."""
    with pytest.raises(ValueError, match="across cards is ROADMAP item 11c"):
        sharded_capture(True, [CUDA0, CUDA1])
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        sharded_capture(True, [CPU, CPU])


class _Placed(Exception):
    """Raised by the stand-in ``make_mesh`` once it has seen the devices."""


@pytest.mark.parametrize("device,flags,mesh_devices,want", [
    ("cuda:0", ["--spatial_shards", "2"], None, None),
    ("cuda:1", ["--pipeline"], None, None),
    ("cpu", ["--spatial_shards", "2"], None, "cpu"),
    ("cuda:0", ["--pipeline"], [CUDA0, CUDA0], [CUDA0, CUDA0]),
], ids=["shards-visible-cards", "pipeline-visible-cards", "cpu", "caller-places"])
def test_cli_mesh_devices(tmp_path, monkeypatch, device, flags, mesh_devices, want):
    """The devices the inference CLI hands ``make_mesh`` for
    ``--spatial_shards`` and ``--pipeline``: the visible cards (None)
    whatever card ``--device`` names, the CPU standing for them with
    ``--device cpu``, or the library caller's ``mesh_devices``. The device
    check and the mesh are stood in for, so nothing touches a card."""
    seen = []

    def make_mesh(axes, devices=None):
        seen.append(devices)
        raise _Placed

    monkeypatch.setattr(cli_main, "resolve_device", torch.device)
    monkeypatch.setattr(parallel_package, "make_mesh", make_mesh)
    with pytest.raises(_Placed):
        cli_main.main(["--mode", "inference", "--device", device, "--output_dir",
                       str(tmp_path), "--allow_random_weights", "--input_dir_LR",
                       str(tmp_path), *flags], mesh_devices=mesh_devices)
    assert seen == [want]


# ------------------------------------------------------------ models
@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=RESBLOCKS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    return tuple(jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))


class _EagerProgram:
    """A stand-in for ``CapturedProgram`` on the CPU: it checks that its
    inputs share one device, as the card's does, really runs the body as
    its warm-up, and runs it again at each call (a replay)."""

    made = []

    def __init__(self, body, inputs, name):
        assert len({t.device for t in inputs}) == 1, name
        self.inputs, self.name = tuple(inputs), name
        body()
        self.body = body
        _EagerProgram.made.append(self)

    def __call__(self):
        return self.body()

    def pool_bytes(self):
        return 0


# ------------------------------------------------------------ sharded chunk
def test_sharded_chunk_capture_branch_equals_eager_and_matches_jax(weights, monkeypatch):
    """``StreamingSR`` on 2 CPU shards with its capturing branch taken and
    the graph stood in for: one program a chunk shape over every shard's LR
    and state buffers, its warm-up leaving nothing behind (the run zeroes
    the state after it); bit-equal to the eager sharded run over two runs
    (chunks of 3, a short last one), and within the JAX package's
    tolerance of its sharded ``StreamingSR``."""
    gp, fp = weights
    monkeypatch.setattr(inference_module, "CapturedProgram", _EagerProgram)
    _EagerProgram.made = []
    cfg = TecoConfig(num_resblock=RESBLOCKS, infer_chunk=3)
    frames = np.random.RandomState(4).rand(7, 32, 16, 3).astype(np.float32)
    mesh = make_mesh({cfg.sp_axis: 2}, "cpu")
    eager = StreamingSR(cfg, *from_jax_params(gp, fp), device="cpu", spatial_mesh=mesh)
    assert eager.capture is False and eager.route.startswith("eager on cpu")
    want, _ = eager.run(frames, warmup=1)
    sr = StreamingSR(cfg, *from_jax_params(gp, fp), device="cpu", spatial_mesh=mesh)
    sr.capture = True
    for _ in range(2):
        got, _ = sr.run(frames, warmup=1)
        np.testing.assert_array_equal(got, want)
    (prog,) = _EagerProgram.made
    (chunk,) = sr._chunks.values()
    assert chunk.run is prog and len(chunk.lrs) == 2
    assert [id(t) for t in prog.inputs] == [id(t) for t in (
        *chunk.lrs, *(t for state in chunk.states for t in state))]
    assert [lr.shape[2] for lr in chunk.lrs] == [16, 16]
    # One warp a frame (the 64-row HR shards gather the frame): the
    # warm-up's chunk and 3 chunks in each of 2 runs.
    assert sr.step.gather_warps == 3 * (1 + 2 * 3)

    jcfg = JaxConfig(num_resblock=RESBLOCKS, infer_chunk=3, fold_input_s2d="off")
    theirs, _ = JaxStreamingSR(jcfg, gp, fp, spatial_mesh=jax_make_mesh(
        {jcfg.sp_axis: 2})).run(frames, warmup=1)
    np.testing.assert_allclose(got, theirs, rtol=SPATIAL_RTOL, atol=SPATIAL_ATOL)


# ------------------------------------------------------------ pipeline
def _pipe(cfg, gp, fp, output="float32"):
    return PipelinedStreamingSR(cfg, *from_jax_params(gp, fp), output=output,
                                flow_device="cpu", recurrent_device="cpu")


def test_pipeline_static_buffers_over_runs_match_streaming_and_jax(weights):
    """The restructured stages, eagerly over one chunk shape's static
    buffers for three runs of 8, 5 and 8 frames in chunks of 3 (short last
    chunks of 2): the buffers are made once and reused, each run starts
    from the zero state, and every run equals ``StreamingSR(capture=False)``;
    the 5-frame run is within the JAX pipeline's tolerance."""
    gp, fp = weights
    cfg = TecoConfig(num_resblock=RESBLOCKS, infer_chunk=3)
    frames = np.random.RandomState(6).rand(8, 16, 16, 3).astype(np.float32)
    ref = StreamingSR(cfg, *from_jax_params(gp, fp), device="cpu", capture=False)
    pipe = _pipe(cfg, gp, fp)
    assert pipe.capture is False and pipe.route == (
        "stage F eager on cpu (CUDA graphs exist only on the card), "
        "stage R eager on cpu (CUDA graphs exist only on the card)")
    pointers = None
    for n in (8, 5, 8):
        got, _ = pipe.run(frames[:n], warmup=1)
        want, _ = ref.run(frames[:n], warmup=1)
        assert got.shape == (n - 1, 64, 64, 3)
        np.testing.assert_array_equal(got, want)
        (st,) = pipe._stages.values()
        now = [t.data_ptr() for t in (st.lr_in, st.prev_last, st.lr, st.flow, *st.state)]
        assert pointers in (None, now)
        pointers = now
        if n == 5:
            jcfg = JaxConfig(num_resblock=RESBLOCKS, infer_chunk=3, fold_input_s2d="off")
            theirs, _ = JaxPipelinedStreamingSR(jcfg, gp, fp).run(frames[:n], warmup=1)
            np.testing.assert_allclose(got, theirs, rtol=PIPE_RTOL, atol=PIPE_ATOL)
    assert pipe.capture_s > 0 and st.pool_bytes() == (0, 0)


def test_pipeline_capture_branch_makes_two_programs_a_chunk_shape(weights, monkeypatch):
    """The pipeline's capturing branch with the graphs stood in for: two
    programs a chunk shape (F over the upload buffer and the last frame
    seen, R over its frames, flows and state), made once across runs and
    anew for another chunk length; uint8 outputs bit-equal to the eager
    pipeline's."""
    gp, fp = weights
    monkeypatch.setattr(pipeline_module, "CapturedProgram", _EagerProgram)
    _EagerProgram.made = []
    cfg = TecoConfig(num_resblock=RESBLOCKS, infer_chunk=3)
    frames = (np.random.RandomState(7).rand(7, 16, 16, 3) * 255).astype(np.uint8)
    eager = _pipe(cfg, gp, fp, "uint8")
    want = {chunk: eager.run(frames, chunk=chunk)[0] for chunk in (3, 4)}
    pipe = _pipe(cfg, gp, fp, "uint8")
    pipe.capture = True
    for chunk in (3, 3, 4):
        got, _ = pipe.run(frames, chunk=chunk)
        np.testing.assert_array_equal(got, want[chunk])
    assert [p.name.split(" (")[0] for p in _EagerProgram.made] == [
        "pipeline stage F", "pipeline stage R"] * 2
    f, r = _EagerProgram.made[:2]
    st = pipe._stages[(3, 16, 16, torch.uint8)]
    assert [id(t) for t in f.inputs] == [id(st.lr_in), id(st.prev_last)]
    assert [id(t) for t in r.inputs] == [id(t) for t in (st.lr, st.flow, *st.state)]
    assert st.run_flow is f and st.run_recurrent is r
