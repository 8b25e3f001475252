"""The inference paths' static buffers and programs on the CPU, where the
chunk and the tick run eagerly over the same buffers the card's captured
CUDA graphs use (``tecogan_tpu_torch/utils/cuda_graphs.py``), and the
launch-count helper that a captured graph's replays go through."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.recurrent.inference import StreamingSR as JaxStreamingSR
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.kernels import LaunchRecord, resblock_chain, upsample4, upsample4_bwd
from tecogan_tpu_torch.kernels import ops
from tecogan_tpu_torch.recurrent import StreamingSR
from tecogan_tpu_torch.serve import MultiGeometryServer, VSRServer
from tecogan_tpu_torch.utils.cuda_graphs import resolve_capture
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

RESBLOCKS, CHANNELS, CHUNK, WARMUP = 2, 16, 3, 2
# float32 HR frames against the JAX package: float32 convs in another
# summation order, carried through the recurrence (as
# tests/test_torch_streaming.py).
FLOAT_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=RESBLOCKS, channels=CHANNELS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    return tuple(jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))


def _clip(seed, t, h, w):
    return np.random.RandomState(seed).rand(t, h, w, 3).astype(np.float32)


def test_streaming_reuses_buffers_per_shape_and_rezeroes_state(weights):
    """One StreamingSR over three runs, 32x48, then 24x40, then 32x48 again
    (ragged last chunks): each equals the JAX StreamingSR on the same
    weights, so the state is zeroed at each run's start and the buffers
    are keyed by shape; the first shape's buffers are reused."""
    jcfg = JaxConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS, infer_chunk=CHUNK,
                     fold_input_s2d="off")
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS, infer_chunk=CHUNK)
    jax_sr = JaxStreamingSR(jcfg, *weights, output="float32")
    sr = StreamingSR(cfg, *from_jax_params(*weights), output="float32", device="cpu")
    assert sr.capture is False
    runs = [_clip(1, 7, 32, 48), _clip(2, 8, 24, 40), _clip(3, 7, 32, 48)]
    buffers = []
    for frames in runs:
        want, _ = jax_sr.run(frames, warmup=WARMUP)
        got, _ = sr.run(frames, warmup=WARMUP)
        assert got.shape == want.shape == (len(frames) - WARMUP, *(4 * np.array(frames.shape[1:3])), 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
        buffers.append(sr._chunk(CHUNK, frames[:, None]).lr)
    assert len(sr._chunks) == 2
    assert buffers[2] is buffers[0] and buffers[1] is not buffers[0]


def test_streaming_uint8_and_float_frames_get_their_own_buffers(weights):
    """The LR dtype is part of a chunk's key: uint8 and float32 frames of one
    geometry each get their own input buffer, and give the same outputs."""
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS, infer_chunk=CHUNK)
    sr = StreamingSR(cfg, *from_jax_params(*weights), output="float32", device="cpu")
    u8 = (_clip(4, 6, 16, 24) * 255).astype(np.uint8)
    a, _ = sr.run(u8)
    b, _ = sr.run(u8.astype(np.float32) / np.float32(255.0))
    assert sorted(str(k[-1]) for k in sr._chunks) == ["torch.float32", "torch.uint8"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("entry", ["StreamingSR", "VSRServer", "MultiGeometryServer"])
def test_capture_true_on_the_cpu_raises(weights, entry):
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS)
    models = from_jax_params(*weights)
    make = {"StreamingSR": lambda: StreamingSR(cfg, *models, device="cpu", capture=True),
            "VSRServer": lambda: VSRServer(cfg, *models, 16, 24, device="cpu", capture=True),
            "MultiGeometryServer": lambda: MultiGeometryServer(cfg, *models, device="cpu",
                                                               capture=True)}[entry]
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        make()


@pytest.mark.parametrize("capture,device,want", [
    (None, "cpu", False), (False, "cpu", False), (None, "cuda", True),
    (False, "cuda", False), (True, "cuda", True)])
def test_resolve_capture(capture, device, want):
    """None captures on the card only; False is eager anywhere."""
    assert resolve_capture(capture, torch.device(device)) is want


def test_server_programs_per_frame_dtype_and_release(weights):
    """A VSRServer keeps one tick program per LR frame dtype; release()
    drops them and the next tick makes a new one, from the same state."""
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS)
    srv = VSRServer(cfg, *from_jax_params(*weights), 16, 24, max_streams=2,
                    output="float32", device="cpu")
    twin = VSRServer(cfg, *from_jax_params(*weights), 16, 24, max_streams=2,
                     output="float32", device="cpu")
    clip = _clip(5, 3, 16, 24)
    for s in (srv, twin):
        s.open("a")
    srv.step({"a": (clip[0] * 255).astype(np.uint8)})
    twin.step({"a": (clip[0] * 255).astype(np.uint8)})
    srv.step({"a": clip[1]})
    assert sorted(map(str, srv._programs)) == ["torch.float32", "torch.uint8"]
    srv.release()
    assert not srv._programs
    got = srv.step({"a": clip[2]})["a"]
    twin.step({"a": clip[1]})
    want = twin.step({"a": clip[2]})["a"]
    np.testing.assert_array_equal(got, want)


def test_eviction_releases_the_bucket(weights, monkeypatch):
    """MultiGeometryServer hands an evicted bucket's graphs and pools back
    (VSRServer.release) before dropping it."""
    released = []
    release = VSRServer.release
    monkeypatch.setattr(VSRServer, "release",
                        lambda self: (released.append((self.height, self.width)),
                                      release(self))[-1])
    cfg = TecoConfig(num_resblock=RESBLOCKS, gen_channels=CHANNELS)
    one = MultiGeometryServer(cfg, *from_jax_params(*weights), slots_per_geometry=1,
                              output="float32", device="cpu")
    one.state_budget_mb = one.bucket_bytes(16, 24) / 2**20 * 1.5
    one.open("a", 16, 24)
    one.step({"a": _clip(6, 1, 16, 24)[0]})
    one.close("a")
    one.open("b", 20, 24)  # the idle 16x24 bucket must go
    assert released == [(16, 24)] and list(one.geometries) == [(20, 24)]


def test_launch_record_counts_this_threads_launches():
    """LaunchRecord snapshots the calling thread's tally: launches counted
    on another thread meanwhile stay out; add() counts the record again,
    add(-1) takes it back."""
    before = (upsample4.launches, resblock_chain.launches)
    with LaunchRecord() as record:
        ops.count(upsample4)
        ops.count(resblock_chain, 16)
        other = threading.Thread(target=ops.count, args=(resblock_chain, 5))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert record.launches == {upsample4: 1, resblock_chain: 16}
    assert (upsample4.launches, resblock_chain.launches) == (before[0] + 1, before[1] + 21)
    record.add()
    record.add()
    assert (upsample4.launches, resblock_chain.launches) == (before[0] + 3, before[1] + 53)
    record.add(-3)
    assert (upsample4.launches, resblock_chain.launches) == (before[0], before[1] + 5)
    with LaunchRecord() as empty:
        pass
    assert empty.launches == {}


def test_launch_counts_survive_concurrent_threads():
    """Replays on several threads at once (buckets ticking beside a
    background capture) lose no launch: 16 threads, a short switch
    interval, each counting 2,000 times."""
    threads_n, reps = 16, 2000
    start = upsample4.launches
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ops.count(upsample4) for _ in range(reps)])
                   for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert upsample4.launches == start + threads_n * reps


def test_capture_record_counts_its_stream_from_any_thread(monkeypatch):
    """A capture's record is keyed by its stream (the current-stream query
    monkeypatched on the CPU): a launch counted on another thread whose
    current stream is the capture's lands in it, as a captured backward's
    K2 does on autograd's device thread; launches on another stream, from
    the capturing thread or another, stay out, as an eager bucket's tick
    beside a background capture; none lands after the capture ends."""
    local = threading.local()
    monkeypatch.setattr(ops, "_stream_key", lambda: getattr(local, "stream", 0))

    def count_on(stream, wrapper, n=1):
        local.stream = stream
        ops.count(wrapper, n)

    def on_thread(*args):
        thread = threading.Thread(target=count_on, args=args)
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive()

    kernels = (upsample4, upsample4_bwd, resblock_chain)
    before = [k.launches for k in kernels]
    with LaunchRecord(stream=7) as record:
        count_on(7, resblock_chain, 10)  # the capturing thread
        on_thread(7, upsample4_bwd)      # the backward's device thread
        on_thread(9, upsample4, 3)       # a bucket ticking on its own stream
        count_on(9, upsample4)
        with pytest.raises(RuntimeError, match="already has a launch record"):
            LaunchRecord(stream=7).__enter__()
    count_on(7, resblock_chain)
    assert record.launches == {resblock_chain: 10, upsample4_bwd: 1}
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 1, 11]
    record.add(-1)  # the capture ran none of them; each replay adds them
    record.add()
    record.add()
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 2, 21]
