"""The port's serving layer against the JAX package's on the CPU: the slot
pool (late joins, idle slots, slot reuse), uint8 I/O, the multi-geometry
server and its state budget, lifecycle errors, fetch=False frames,
prewarm, the frame sources, the exported frame step and ``cli.serve``.

2 resblocks at 64 channels (the JAX weights carried across with
``weights.from_jax_params``), float32, LR 16x16 and 12x20 (FNet's pad
path). The JAX side runs its packed warp + space-to-depth route
(``fold_input_s2d="off"``), the route the port takes.
"""

import itertools
import os
import queue
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import serve as jax_cli_serve
from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.serve import MultiGeometryServer as JaxMultiGeometryServer
from tecogan_tpu.serve import VSRServer as JaxVSRServer
from tecogan_tpu.serve import build_frame_fn as jax_build_frame_fn
from tecogan_tpu.serve.sources import EOS as JAX_EOS
from tecogan_tpu.serve.sources import PENDING as JAX_PENDING
from tecogan_tpu.serve.sources import FrameSource as JaxFrameSource
from tecogan_tpu.recurrent.step import RecurrentState as JaxRecurrentState
from tecogan_tpu.train.checkpoint import params_to_npz as jax_params_to_npz
from tecogan_tpu_torch.cli import serve as cli_serve
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.inference import load_inference_frames, read_rgb
from tecogan_tpu_torch.data.png import write_png
from tecogan_tpu_torch.data.video_io import read_video_frames
from tecogan_tpu_torch.kernels import upsample4_plain
from tecogan_tpu_torch.recurrent.step import RecurrentState, frame_step, init_state
from tecogan_tpu_torch.serve import (
    EOS,
    PENDING,
    FrameSource,
    MultiGeometryServer,
    VSRServer,
    build_frame_fn,
    export_frame_step,
    load_frame_step,
    save_frame_step,
)
from tecogan_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

H, W = 16, 16
ODD = (12, 20)  # not a multiple of FNet's 8: its flow is padded back
RESBLOCKS = 2
# float32 HR frames: float32 convs in another summation order, carried
# through the recurrence (as tests/test_torch_streaming.py).
ATOL = 1e-5
# uint8 frames: the port divides by 255 where XLA multiplies by the
# reciprocal (1 ulp), and the float drift above can cross a rounding step:
# at most 1 level, on at most this share of the values.
U8_MAX_FLIPPED = 1e-3


@pytest.fixture(scope="module")
def weights():
    """The JAX trees (flax init plus seeded noise, so no bias is zero) and
    the port's models with the same weights."""
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=RESBLOCKS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    gp, fp = (jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))
    return gp, fp


def _configs(**over):
    return (JaxConfig(num_resblock=RESBLOCKS, fold_input_s2d="off", **over),
            TecoConfig(num_resblock=RESBLOCKS, **over))


def _models(weights):
    return from_jax_params(*weights)


def _frames(rng, n, h=H, w=W):
    return rng.rand(n, h, w, 3).astype(np.float32)


def _state(srv, slot):
    return tuple(t[slot].clone() for t in srv._state)


def test_server_tick_script_matches_jax(weights, rng):
    """Streams attach late, one sits idle for two ticks, and a slot is
    closed and reused: every output against JAX's server; the idle slot's
    state bit-equal across its idle ticks; the reused slot from zeros."""
    jcfg, cfg = _configs()
    a, b, c = _frames(rng, 5), _frames(rng, 3), _frames(rng, 1)
    script = [("open", "a"), {"a": a[0]}, ("open", "b"), {"a": a[1], "b": b[0]},
              {"a": a[2]}, {"a": a[3]}, {"a": a[4], "b": b[1]},
              ("close", "a"), ("open", "c"), {"b": b[2], "c": c[0]}]
    jsrv = JaxVSRServer(jcfg, *weights, H, W, max_streams=3, output="float32")
    srv = VSRServer(cfg, *_models(weights), H, W, max_streams=3, output="float32",
                    device="cpu")
    idle = []  # b's state (before, after) each tick it sits out
    for tick in script:
        if isinstance(tick, tuple):
            for s in (jsrv, srv):
                getattr(s, tick[0])(tick[1])
            continue
        before = _state(srv, 1) if "b" in srv.open_streams else None
        want, got = jsrv.step(tick), srv.step(tick)
        if before is not None and "b" not in tick:
            idle.append((before, _state(srv, 1)))
        assert sorted(got) == sorted(want) == sorted(tick)
        for sid in tick:
            assert got[sid].shape == (4 * H, 4 * W, 3) and got[sid].dtype == np.float32
            np.testing.assert_allclose(got[sid], want[sid], rtol=0, atol=ATOL)
    assert srv._slot_of == {"b": 1, "c": 0}  # c reused a's slot 0
    assert len(idle) == 2
    for (lr0, hr0), (lr1, hr1) in idle:
        assert torch.equal(lr0, lr1) and torch.equal(hr0, hr1)
    # c restarted from zeros: one frame step of the plain engine from zeros.
    with torch.no_grad():
        _, want_c = frame_step(srv.generator, srv.fnet, init_state(1, H, W, device="cpu"),
                               torch.from_numpy(c[:1]))
    np.testing.assert_allclose(srv._state.prev_hr[0].numpy(), want_c[0].numpy(), atol=ATOL)


def test_idle_slot_state_is_bit_frozen(weights, rng):
    """An idle slot's state is the same bits after ticks of its neighbours,
    and a stream's outputs do not depend on what the other slots hold."""
    _, cfg = _configs()
    frames = _frames(rng, 4)
    srv = VSRServer(cfg, *_models(weights), H, W, max_streams=2, output="float32",
                    device="cpu")
    alone = VSRServer(cfg, *_models(weights), H, W, max_streams=2, output="float32",
                      device="cpu")
    srv.open("a")
    srv.open("b")
    alone.open("a")
    srv.step({"a": frames[0], "b": frames[1]})
    alone.step({"a": frames[0]})
    frozen = _state(srv, 1)
    for f in frames[1:]:
        got = srv.step({"a": f})["a"]
        np.testing.assert_array_equal(got, alone.step({"a": f})["a"])
    after = _state(srv, 1)
    assert torch.equal(frozen[0], after[0]) and torch.equal(frozen[1], after[1])


def test_server_uint8_io_matches_jax(weights, rng):
    """uint8 in, uint8 out (quantised on the device), at the odd geometry."""
    jcfg, cfg = _configs()
    frames = (_frames(rng, 4, *ODD) * 255).astype(np.uint8)
    jsrv = JaxVSRServer(jcfg, *weights, *ODD, max_streams=2, output="uint8")
    srv = VSRServer(cfg, *_models(weights), *ODD, max_streams=2, output="uint8",
                    device="cpu")
    for s in (jsrv, srv):
        s.open("a")
    want = np.stack([jsrv.step({"a": f})["a"] for f in frames])
    got = np.stack([srv.step({"a": f})["a"] for f in frames])
    assert got.shape == want.shape == (4, 4 * ODD[0], 4 * ODD[1], 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED, (diff != 0).mean()
    assert got.std() > 1.0


def test_multi_geometry_matches_jax(weights, rng):
    """Two geometries in one process, a mid-run join and an idle tick,
    against JAX's MultiGeometryServer."""
    jcfg, cfg = _configs()
    a, b = _frames(rng, 4), _frames(rng, 3, *ODD)
    jsrv = JaxMultiGeometryServer(jcfg, *weights, slots_per_geometry=2, output="float32")
    srv = MultiGeometryServer(cfg, *_models(weights), slots_per_geometry=2,
                              output="float32", device="cpu")
    script = [("a", (H, W)), {"a": a[0]}, ("b", ODD), {"a": a[1], "b": b[0]},
              {"a": a[2]}, {"a": a[3], "b": b[1]}, {"b": b[2]}]
    for tick in script:
        if isinstance(tick, tuple):
            assert srv.open(tick[0], *tick[1]) == jsrv.open(tick[0], *tick[1])
            continue
        want, got = jsrv.step(tick), srv.step(tick)
        for sid in tick:
            np.testing.assert_allclose(got[sid], want[sid], rtol=0, atol=ATOL)
    assert srv.geometries == jsrv.geometries == {(H, W): (1, 2), ODD: (1, 2)}
    assert srv.open_streams == jsrv.open_streams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_bytes_and_budget_errors_match_jax(weights, dtype):
    """bucket_bytes gives JAX's numbers; LRU eviction and both budget
    errors happen where JAX's do, with the same text."""
    jcfg, cfg = _configs(compute_dtype=dtype)
    models = _models(weights)
    for output in ("uint8", "float32"):
        jsrv = JaxMultiGeometryServer(jcfg, *weights, slots_per_geometry=3, output=output,
                                      state_budget_mb=None)
        srv = MultiGeometryServer(cfg, *models, slots_per_geometry=3, output=output,
                                  state_budget_mb=None, device="cpu")
        for geo in ((144, 180), (540, 960), ODD, (H, W)):
            assert srv.bucket_bytes(*geo) == jsrv.bucket_bytes(*geo)
    g1, g2, g3 = (H, W), (8, 32), (32, 8)  # equal pixel counts

    def servers(budget):
        return (JaxMultiGeometryServer(jcfg, *weights, slots_per_geometry=1, output="float32",
                                       state_budget_mb=budget),
                MultiGeometryServer(cfg, *models, slots_per_geometry=1, output="float32",
                                    state_budget_mb=budget, device="cpu"))

    def both(pair, method, *args):
        results = []
        for s in pair:
            try:
                results.append(("ok", getattr(s, method)(*args)))
            except RuntimeError as exc:
                results.append(("raised", str(exc)))
        assert results[0] == results[1]
        return results[1]

    per = servers(None)[1].bucket_bytes(*g1)
    pair = servers(2.5 * per / 2**20)
    both(pair, "open", "a", *g1)
    both(pair, "open", "b", *g2)
    assert pair[0].footprint_bytes == pair[1].footprint_bytes == 2 * per
    assert both(pair, "open", "c", *g3)[0] == "raised"  # every bucket busy
    both(pair, "close", "b")
    both(pair, "open", "c", *g3)  # evicts g2, the idle bucket
    assert set(pair[0].geometries) == set(pair[1].geometries) == {g1, g3}
    # LRU order: with two idle buckets, the least recently used one goes.
    pair = servers(2.5 * per / 2**20)
    for s in pair:
        s._bucket(g1)
        s._bucket(g2)
    both(pair, "open", "x", *g1)
    both(pair, "close", "x")  # touches g1: g2 is now the LRU idle bucket
    both(pair, "open", "y", *g3)
    assert set(pair[0].geometries) == set(pair[1].geometries) == {g1, g3}
    # A geometry that cannot fit even alone is refused up front.
    kind, text = both(servers(0.5 * per / 2**20), "open", "z", *g1)
    assert kind == "raised" and "alone needs" in text


def test_budget_counts_graph_pools(weights, monkeypatch):
    """The state budget counts each resident bucket's captured graph pool
    (stubbed here: on the CPU the ticks run eagerly and hold none) and, for
    the bucket being admitted, the largest resident pool scaled by its
    pixels. With pools the JAX formula alone would admit the second
    geometry; counted, it is refused while the first bucket is busy and
    evicts it once it is idle."""
    _, cfg = _configs()
    pools = {}
    monkeypatch.setattr(VSRServer, "graph_pool_bytes",
                        lambda self: pools.get((self.height, self.width), 0))
    srv = MultiGeometryServer(cfg, *_models(weights), slots_per_geometry=1, output="float32",
                              state_budget_mb=None, device="cpu")
    g1, g2 = (H, W), (8, 16)  # g2 has half g1's pixels
    per1, per2 = srv.bucket_bytes(*g1), srv.bucket_bytes(*g2)
    pool = 40 * per1
    srv.state_budget_mb = 0.75 * pool / 2**20  # below one pool, over the formula's sum
    assert per1 + per2 < srv.state_budget_mb * 2**20
    assert srv.pool_estimate(*g2) == 0  # no pool measured yet
    srv.open("a", *g1)
    pools[g1] = pool  # the first tick's capture
    assert srv.footprint_bytes == per1 + pool
    assert srv.pool_estimate(*g2) == pool // 2 and srv.pool_estimate(2 * H, W) == 2 * pool
    with pytest.raises(RuntimeError, match="every remaining bucket has open streams") as info:
        srv.open("b", *g2)
    assert f"~{(per2 + pool // 2) / 2**20:.1f} MB" in str(info.value)
    assert set(srv.geometries) == {g1}
    srv.close("a")
    srv.open("b", *g2)  # evicts the idle g1 bucket and its pool
    assert set(srv.geometries) == {g2} and srv.footprint_bytes == per2
    pools[g2] = pool  # g2 captured: g1's estimate is now twice that pool
    with pytest.raises(RuntimeError, match="alone needs"):
        srv.open("c", *g1)


def test_lifecycle_errors(weights):
    """The exception types of tests/test_serve.py:test_lifecycle_errors,
    and the port's own refusals."""
    _, cfg = _configs()
    srv = VSRServer(cfg, *_models(weights), H, W, max_streams=1, output="float32",
                    device="cpu")
    srv.open("a")
    with pytest.raises(ValueError):
        srv.open("a")
    with pytest.raises(RuntimeError):
        srv.open("b")
    with pytest.raises(KeyError):
        srv.step({"zzz": np.zeros((H, W, 3), np.float32)})
    with pytest.raises(ValueError):
        srv.step({"a": np.zeros((8, 8, 3), np.float32)})
    with pytest.raises(ValueError, match="uint8 or float32"):
        srv.step({"a": np.zeros((H, W, 3), np.float64)})
    srv.close("a")
    srv.open("b")  # slot freed
    assert srv.open_streams == ("b",)
    assert srv.step({}) == {}
    # A slot pool over a mesh: the slots divide over its data axis, which
    # it must have.
    from tecogan_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="divide evenly"):
        VSRServer(cfg, *_models(weights), H, W, max_streams=3,
                  mesh=make_mesh({"data": 2}, "cpu"), device="cpu")
    with pytest.raises(ValueError, match="no 'data'"):
        MultiGeometryServer(cfg, *_models(weights), mesh=make_mesh({"space": 2}, "cpu"),
                            device="cpu")

    multi = MultiGeometryServer(cfg, *_models(weights), slots_per_geometry=1,
                                output="float32", device="cpu")
    assert multi.free_slots(H, W) == 1  # bucket not built yet
    multi.open("a", H, W)
    assert multi.free_slots(H, W) == 0 and multi.free_slots(*ODD) == 1
    multi.open("b", *ODD)
    with pytest.raises(ValueError):
        multi.open("b", H, W)  # ids are global
    with pytest.raises(RuntimeError):
        multi.open("c", H, W)  # (H, W) bucket full
    with pytest.raises(KeyError):
        multi.step({"zzz": np.zeros((H, W, 3), np.float32)})
    multi.close("a")
    multi.open("c", H, W)
    assert sorted(multi.open_streams) == ["b", "c"]


def test_fetch_false_frames_read_after_later_ticks(weights, rng):
    """fetch=False frames equal the fetched arrays when read only after
    every tick ran, and can be read on another thread."""
    _, cfg = _configs()
    frames = _frames(rng, 3)
    s1 = VSRServer(cfg, *_models(weights), H, W, max_streams=2, output="float32",
                   device="cpu")
    s2 = VSRServer(cfg, *_models(weights), H, W, max_streams=2, output="float32",
                   device="cpu")
    s1.open("a")
    s2.open("a")
    fetched = [s1.step({"a": f})["a"] for f in frames]
    deferred = [s2.step({"a": f}, fetch=False)["a"] for f in frames]
    read = queue.Queue()
    t = threading.Thread(target=lambda: read.put([np.asarray(d) for d in deferred]))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    for want, got in zip(fetched, read.get_nowait()):
        np.testing.assert_array_equal(got, want)
    assert np.ascontiguousarray([deferred[0]]).shape == (1, 4 * H, 4 * W, 3)


def test_prewarm_keeps_state_foreground_and_background(weights, rng):
    """prewarm leaves every slot's state bit-unchanged, at any point in a
    server's life, in the foreground and from a background thread while
    another bucket serves."""
    _, cfg = _configs()
    frames = _frames(rng, 4)
    lazy = MultiGeometryServer(cfg, *_models(weights), slots_per_geometry=2,
                               output="float32", device="cpu")
    lazy.open("a", H, W)
    want = np.stack([lazy.step({"a": f})["a"] for f in frames])

    warm = MultiGeometryServer(cfg, *_models(weights), slots_per_geometry=2,
                               output="float32", device="cpu")
    assert warm.prewarm([(H, W)], frame_dtype=np.float32) is None
    bucket = warm._buckets[(H, W)]
    warm.open("a", H, W)
    assert warm._buckets[(H, W)] is bucket  # created by prewarm, not again
    got = [warm.step({"a": frames[0]})["a"], warm.step({"a": frames[1]})["a"]]
    before = _state(bucket, 0)
    bucket.prewarm(np.float32)  # mid-stream, foreground
    after = _state(bucket, 0)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    t = warm.prewarm([ODD], frame_dtype=np.float32, background=True)
    got += [warm.step({"a": f})["a"] for f in frames[2:]]
    t.join(timeout=120)
    assert not t.is_alive() and ODD in warm.geometries
    np.testing.assert_array_equal(np.stack(got), want)
    warm.open("b", *ODD)
    assert warm.step({"b": _frames(rng, 1, *ODD)[0]})["b"].shape == (48, 80, 3)


def _png_dir(path, n, h, w, rng, writer=write_png):
    os.makedirs(path)
    frames = (rng.rand(n, h, w, 3) * 255).astype(np.uint8)
    for i, f in enumerate(frames):
        writer(os.path.join(path, f"{i:04d}.png"), f)
    return frames


def _drain(src, pending=PENDING, eos=EOS, timeout=60):
    got, deadline = [], time.time() + timeout
    while time.time() < deadline:
        f = src.try_next()
        if f is eos:
            return got
        if f is pending:
            time.sleep(0.001)
            continue
        got.append(f)
    raise TimeoutError("source did not finish")


def test_frame_source_order_matches_bulk_load_and_jax(rng, tmp_path):
    """FrameSource emits load_inference_frames' sequence (the reversed
    [5..1] warm-up first), one frame at a time, as JAX's FrameSource does."""
    d = str(tmp_path / "LR")
    _png_dir(d, 9, 10, 12, rng)
    want = load_inference_frames(input_dir_lr=d, as_uint8=True, device="cpu").inputs
    src = FrameSource(d, lookahead=3)
    assert src.geometry(timeout=30) == (10, 12)
    got = np.stack(_drain(src))
    np.testing.assert_array_equal(got, want)
    assert src.warmup == 5 and src.decode_s > 0
    jsrc = JaxFrameSource(d, lookahead=3)
    np.testing.assert_array_equal(np.stack(_drain(jsrc, JAX_PENDING, JAX_EOS)), got)
    floats = np.stack(_drain(FrameSource(d, lookahead=3, as_uint8=False, max_frames=7)))
    np.testing.assert_array_equal(floats, want[:12].astype(np.float32) / 255.0)

    short = str(tmp_path / "short")
    _png_dir(short, 3, 8, 8, rng)
    bad = FrameSource(short, lookahead=3)
    assert bad.geometry(timeout=30) == (8, 8)  # the geometry is known...
    with pytest.raises(ValueError, match="warm-up"):  # ...the feed fails
        _drain(bad)
    live = FrameSource(short, lookahead=3, warmup=False)
    assert len(_drain(live)) == 3


def test_frame_source_lagging_producer_and_deferred_error():
    """try_next does not wait for a lagging producer, a producer's error
    reaches the consumer after the frames before it, and stop() ends a
    producer parked on a full queue."""
    release = threading.Event()
    frames = [np.full((4, 6, 3), i, np.uint8) for i in range(3)]

    def lagging():
        yield frames[0]
        release.wait(30)
        yield from frames[1:]

    src = FrameSource(frames=lagging(), warmup=False, lookahead=2)
    assert src.geometry(timeout=30) == (4, 6)
    assert src.try_next() is frames[0]
    assert all(src.try_next() is PENDING for _ in range(5))
    release.set()
    assert [f[0, 0, 0] for f in _drain(src)] == [1, 2]

    def failing():
        yield frames[0]
        raise OSError("decode failed")

    src = FrameSource(frames=failing(), warmup=False)
    got = []
    with pytest.raises(OSError, match="decode failed"):
        while True:
            f = src.try_next()
            if f is not PENDING:
                got.append(f)
    assert len(got) == 1

    endless = FrameSource(frames=itertools.repeat(frames[0]), warmup=False, lookahead=2)
    endless.geometry(timeout=30)
    endless.stop()
    assert not endless._thread.is_alive()


def test_frame_source_video_file_raises(tmp_path):
    """A file that is no video raises ValueError from geometry(), as the
    JAX FrameSource's does (video sources: tests/test_torch_video_io.py)."""
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\x00" * 64)
    src = FrameSource(str(video))
    with pytest.raises(ValueError, match="not an AVI, MP4 or Matroska"):
        src.geometry(timeout=30)
    jax_src = JaxFrameSource(str(video))
    with pytest.raises(ValueError):
        jax_src.geometry(timeout=30)
    with pytest.raises(ValueError, match="exactly one"):
        FrameSource()


@pytest.mark.parametrize("output,input_dtype", [("float32", torch.float32),
                                                ("uint8", torch.uint8)])
def test_export_round_trip(weights, rng, tmp_path, output, input_dtype):
    """The saved and loaded program against the live frame function (bit-
    equal: the same operators on the same CPU) and JAX's frame function."""
    jcfg, cfg = _configs()
    gen, fnet = _models(weights)
    exported = export_frame_step(cfg, gen, fnet, batch=2, height=H, width=W,
                                 output=output, input_dtype=input_dtype, device="cpu")
    calls = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert calls.count("tecogan_torch.upsample4.default") == 2  # flow and skip
    assert calls.count("tecogan_torch.resblock_chain.default") == 1
    assert calls.count("tecogan_torch.bias_relu_crop.default") == 2  # the transposed convs
    assert calls.count("tecogan_torch.warp_pack.default") == 1  # the warp, pack and concat
    path = str(tmp_path / "step.pt2")
    save_frame_step(exported, path)
    step = load_frame_step(path)

    prev_lr = rng.rand(2, H, W, 3).astype(np.float32)
    prev_hr = rng.rand(2, 4 * H, 4 * W, 3).astype(np.float32)
    lr = rng.rand(2, H, W, 3).astype(np.float32)
    if input_dtype == torch.uint8:
        lr = (lr * 255).astype(np.uint8)
    state = RecurrentState(torch.from_numpy(prev_lr), torch.from_numpy(prev_hr))
    new_state, hr = step(state, torch.from_numpy(lr))
    assert isinstance(new_state, RecurrentState)
    with torch.no_grad():
        ref_state, ref_hr = build_frame_fn(cfg, output)(gen, fnet, state, torch.from_numpy(lr))
    assert hr.dtype == ref_hr.dtype and torch.equal(hr, ref_hr)
    assert torch.equal(new_state.prev_hr, ref_state.prev_hr)
    assert torch.equal(new_state.prev_lr, ref_state.prev_lr)
    with open(path, "rb") as f:
        _, again = load_frame_step(f.read())(tuple(state), torch.from_numpy(lr))
    assert torch.equal(again, hr)

    jax_fn = jax.jit(jax_build_frame_fn(jcfg, JaxGenerator(num_resblock=RESBLOCKS).apply,
                                        JaxFNet().apply, output=output))
    j_state, j_hr = jax_fn(*weights, JaxRecurrentState(jnp.asarray(prev_lr),
                                                      jnp.asarray(prev_hr)), jnp.asarray(lr))
    if output == "float32":
        np.testing.assert_allclose(hr.numpy(), np.asarray(j_hr), rtol=0, atol=ATOL)
    else:
        diff = np.abs(hr.numpy().astype(np.int16) - np.asarray(j_hr).astype(np.int16))
        assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED
    np.testing.assert_allclose(new_state.prev_hr.numpy(), np.asarray(j_state.prev_hr),
                               rtol=0, atol=ATOL)


def test_kernel_operators_trace_with_fake_tensors():
    """The kernels' operators give their outputs' shapes to a fake-tensor
    trace, and run the plain versions on CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x = torch.rand(2, 5, 7, 3)
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        up = torch.ops.tecogan_torch.upsample4(fx, "bicubic", 1.0)
        down = torch.ops.tecogan_torch.upsample4_bwd(up, "bicubic", 1.0)
        chain = torch.ops.tecogan_torch.resblock_chain(
            torch.empty(1, 4, 4, 64), *(torch.empty(s) for s in
                                        ((2, 3, 3, 64, 64), (2, 64), (2, 3, 3, 64, 64), (2, 64))))
    assert up.shape == (2, 20, 28, 3) and down.shape == (2, 5, 7, 3)
    assert chain.shape == (1, 4, 4, 64)
    assert torch.equal(torch.ops.tecogan_torch.upsample4(x, "bicubic", 1.0),
                       upsample4_plain(x, "bicubic"))


def test_cli_serve_matches_jax_cli(weights, rng, tmp_path, capsys, monkeypatch):
    """Two unequal-length PNG dirs of unequal geometry through the port's
    cli.serve on the CPU and the JAX cli.serve, the same params npz: each
    written PNG within 1 u8 level."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    npz = str(tmp_path / "params.npz")
    jax_params_to_npz(npz, generator=weights[0], fnet=weights[1])
    lengths = {"scene_a": 8, "scene_b": 7}
    geos = {"scene_a": (H, W), "scene_b": ODD}
    for name, t in lengths.items():
        _png_dir(str(tmp_path / "LR" / name), t, *geos[name], rng,
                 writer=lambda p, f: cv2.imwrite(p, f[..., ::-1]))
    dirs = ",".join(str(tmp_path / "LR" / n) for n in lengths)
    jax_cli_serve.main(["--input_dirs", dirs, "--output_dir", str(tmp_path / "jax"),
                        "--max_streams", "2", "--params_npz", npz, "--num_resblock", "2"])
    capsys.readouterr()
    stats = cli_serve.main(["--device", "cpu", "--input_dirs", dirs, "--output_dir",
                            str(tmp_path / "port"), "--max_streams", "2", "--params_npz",
                            npz, "--lookahead", "2"])
    out = capsys.readouterr().out
    assert "total time " in out and ", frame number 15" in out
    assert "frames/sec aggregate" in out and "io: decode" in out
    assert stats["written"] == lengths and stats["frames"] == 15
    for name, t in lengths.items():
        names = [f"output_{i:04d}.png" for i in range(t)]
        assert sorted(os.listdir(tmp_path / "port" / name)) == names
        assert sorted(os.listdir(tmp_path / "jax" / name)) == names
        got = np.stack([read_rgb(str(tmp_path / "port" / name / f)) for f in names])
        want = np.stack([read_rgb(str(tmp_path / "jax" / name / f)) for f in names])
        assert got.shape == (t, 4 * geos[name][0], 4 * geos[name][1], 3)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED


def test_cli_serve_export_and_guards(tmp_path, rng, capsys):
    """--export writes a loadable program; --output_videos writes
    <name>.mp4; a missing weight source is refused."""
    path = str(tmp_path / "step.pt2")
    cli_serve.main(["--device", "cpu", "--export", path, "--batch", "1", "--height", "8",
                    "--width", "12", "--num_resblock", "1", "--allow_random_weights"])
    assert "Exported serving step (1x8x12, float32, cpu)" in capsys.readouterr().out
    state = init_state(1, 8, 12, device="cpu")
    _, hr = load_frame_step(path)(state, torch.zeros((1, 8, 12, 3), dtype=torch.uint8))
    assert hr.shape == (1, 32, 48, 3) and hr.dtype == torch.uint8
    d = str(tmp_path / "LR" / "s")
    _png_dir(d, 6, 8, 8, rng)
    base = ["--device", "cpu", "--input_dirs", d, "--output_dir", str(tmp_path / "o")]
    stats = cli_serve.main(base + ["--output_videos", "--allow_random_weights",
                                   "--num_resblock", "1"])
    assert stats["written"] == {"s": 6}
    hr, fps = read_video_frames(str(tmp_path / "o" / "s.mp4"))
    assert hr.shape == (6, 32, 32, 3) and fps == 24.0
    with pytest.raises(SystemExit):
        cli_serve.main(base)  # no weight source
    with pytest.raises(SystemExit):
        cli_serve.main(["--device", "cpu"])  # nothing to serve
