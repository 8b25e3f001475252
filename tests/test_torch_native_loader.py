"""The port's native data-loader core (``tecogan_tpu_torch/csrc/tecodata.cpp``
through ``data/native_loader.py``) on the CPU: its build, its PNG decoder
against the port's python codec (``data/png.py``) and OpenCV, its encoder,
its batches against the port's python executor and the JAX package's
python executor for the same seed, the executor's fallback rule, and the
inference CLI's and the serving sources' frame I/O with and without it.

The JAX package's own native library is never built here: its build lock
is per process and it writes into ``tecogan_tpu/native/``, which
``tests/test_native_loader.py`` builds under other workers.
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.data.loader import BatchLoader as JaxBatchLoader
from tecogan_tpu.data.loader import SceneDataset as JaxSceneDataset
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data import inference, native_loader
from tecogan_tpu_torch.data.inference import FrameWriter, load_inference_frames, read_rgb
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
from tecogan_tpu_torch.data.native_loader import NativeExecutor, NativeFrameIO
from tecogan_tpu_torch.data.png import SIGNATURE, read_png, write_png
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes
from tecogan_tpu_torch.serve.sources import EOS, FrameSource

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """PNG's forward row filter, from the unfiltered bytes."""
    x = line.astype(np.int16)
    a, b, c = np.zeros_like(x), prev.astype(np.int16), np.zeros_like(x)
    a[bpp:], c[bpp:] = x[:-bpp], b[:-bpp]
    if kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = np.zeros_like(x)
    return ((x - pred) & 0xFF).astype(np.uint8)


def _pack(row: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples as the file's bytes (big-endian, bits packed)."""
    flat = row.reshape(-1).astype(np.int64)
    if depth == 16:
        return np.frombuffer(flat.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(-1).astype(np.uint8))


def write_png_raw(path, samples, depth, color, palette=None, interlace=False,
                  filters=lambda y: y % 5):
    """Any PNG the format allows: (H, W, C) samples of ``depth`` bits,
    colour type ``color``, optionally Adam7-interlaced, rows filtered with
    ``filters(row)``; the pixel data split over two IDAT chunks."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else [(0, 0, 1, 1)]:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for y in range(sub.shape[0]):
            line = _pack(sub[y], depth)
            prev = np.zeros_like(line) if prev is None else prev
            kind = filters(y)
            raw += bytes([kind]) + _filter(kind, line, prev, bpp).tobytes()
            prev = line
    data = zlib.compress(bytes(raw), 9)
    half = len(data) // 2
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    plte = b"" if palette is None else _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + plte + _chunk(b"tEXt", b"k\x00v")
                + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
                + _chunk(b"IEND", b""))


def _native_u8(path):
    io = NativeFrameIO(1)
    try:
        return io.decode_frames_u8([path])[0]
    finally:
        io.close()


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


def test_library_builds_from_the_ports_source():
    lib = native_loader.load_library()
    path = native_loader.library_path()
    assert Path(lib._name) == path and path.is_file()
    assert path.parent.parent == REPO / "tecogan_tpu_torch" / "_build"
    assert path.parent.name.startswith("tecodata-")
    assert native_loader._SOURCE == REPO / "tecogan_tpu_torch" / "csrc" / "tecodata.cpp"
    assert native_loader.native_available()
    assert native_loader.load_library() is lib  # built and loaded once
    assert native_loader.build_library() == path  # found, not rebuilt


def _images(rng, h=13, w=21):
    yy, xx = np.mgrid[:h, :w]
    base = (128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
            + rng.randint(-20, 20, (h, w))).clip(0, 255).astype(np.uint8)
    rgb = np.stack([base, base[::-1], base[:, ::-1]], axis=-1)
    return {"gray": base, "rgb": rgb, "rgba": np.concatenate([rgb, (255 - base)[..., None]], -1)}


@pytest.mark.parametrize("rows", ["filter0", "paeth", "every filter", "cv2"])
@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_decode_matches_read_rgb(rng, tmp_path, kind, rows):
    """decode_frames_u8, decode_frames, decode_png and png_dims against the
    port's python codec: gray spread to RGB, alpha dropped, every filter."""
    img = _images(rng, 37, 53)[kind]
    path = str(tmp_path / f"{kind}.png")
    color = {"gray": 0, "rgb": 2, "rgba": 6}[kind]
    if rows == "filter0":
        write_png(path, img)
    elif rows == "cv2":  # libpng's adaptive per-row filters
        cv2.imwrite(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[-1]]])
    else:
        write_png_raw(path, img.reshape(37, 53, -1), 8, color,
                      filters=(lambda y: 4) if rows == "paeth" else (lambda y: y % 5))
    want = read_rgb(path)
    io = NativeFrameIO(2)
    try:
        u8 = io.decode_frames_u8([path, path])
        f32 = io.decode_frames([path])
    finally:
        io.close()
    assert u8.dtype == np.uint8 and u8.shape == (2, 37, 53, 3)
    np.testing.assert_array_equal(u8[0], want)
    np.testing.assert_array_equal(u8[1], want)
    np.testing.assert_array_equal(f32[0], want.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(native_loader.decode_png(path), want.astype(np.float32) / 255.0)
    assert native_loader.png_dims(path) == (37, 53)


FORMATS = [  # (colour type, bit depth, Adam7)
    (0, 1, False), (0, 2, False), (0, 4, False), (0, 16, False), (0, 2, True),
    (3, 1, False), (3, 2, False), (3, 4, True), (3, 8, False),
    (4, 8, False), (4, 16, True), (2, 16, False), (2, 8, True), (6, 16, False), (6, 8, True)]


@pytest.mark.parametrize("color,depth,interlace", FORMATS,
                         ids=[f"c{c}d{d}{'i' if i else ''}" for c, d, i in FORMATS])
def test_decode_other_formats_as_libpng_does(rng, tmp_path, color, depth, interlace):
    """What the JAX package's libpng transforms give, and OpenCV (libpng)
    reads: palettes expanded, 1/2/4-bit gray scaled to 8 bits, 16-bit
    samples cut to their high byte, alpha dropped, Adam7 undone; odd sizes
    so some passes are empty or one pixel wide."""
    h, w = 11, 14
    samples = rng.randint(0, 2 ** depth, (h, w, CHANNELS[color]))
    palette = None
    if color == 3:
        palette = rng.randint(0, 256, (2 ** depth, 3))
        want = palette[samples[..., 0]]
    else:
        gray = samples[..., :1] if color in (0, 4) else samples[..., :3]
        want = (gray >> 8) if depth == 16 else gray * (255 // (2 ** depth - 1))
        want = np.broadcast_to(want, (h, w, 3))
    want = want.astype(np.uint8)
    path = str(tmp_path / "f.png")
    write_png_raw(path, samples, depth, color, palette, interlace)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], want)
    np.testing.assert_array_equal(_native_u8(path), want)


def test_decode_failures_raise(rng, tmp_path):
    """A bad CRC, truncated pixel data, a file that is no PNG, a missing
    file and a frame of another geometry all raise; nothing decodes
    garbage."""
    img = _images(rng)["rgb"]
    good = str(tmp_path / "good.png")
    write_png(good, img)
    data = Path(good).read_bytes()
    cases = {"crc": data[:-20] + bytes([data[-20] ^ 1]) + data[-19:],
             "truncated": data[:len(data) // 2], "not a png": b"not a png at all " * 4}
    io = NativeFrameIO(2)
    try:
        for name, body in cases.items():
            path = tmp_path / f"{name}.png"
            path.write_bytes(body)
            with pytest.raises(IOError):
                io.decode_frames_u8([str(path)])
        with pytest.raises(IOError):
            io.decode_frames_u8([str(tmp_path / "missing.png")])
        other = str(tmp_path / "other.png")
        write_png(other, _images(rng, 9, 9)["rgb"])
        with pytest.raises(IOError, match="geometry"):
            io.decode_frames([good, other])
        with pytest.raises(ValueError):
            io.encode_frames([str(tmp_path / "x.png")], np.zeros((1, 4, 4, 3), np.float32))
    finally:
        io.close()
    with pytest.raises(IOError):
        native_loader.png_dims(str(tmp_path / "not a png.png"))


def test_encode_round_trips_with_sub_rows(rng, tmp_path):
    """encode_frames writes 8-bit RGB PNGs, every row Sub-filtered, that the
    python codec and OpenCV read back exactly; the counters count frames."""
    frames = (synthetic_clip(3, 24, 40, seed=2, content="natural") * 255).astype(np.uint8)
    frames[1] = rng.randint(0, 256, frames[1].shape)
    paths = [str(tmp_path / f"e{i}.png") for i in range(3)]
    before = NativeFrameIO.decoded, NativeFrameIO.encoded
    io = NativeFrameIO(3)
    try:
        io.encode_frames(paths, frames)
        back = io.decode_frames_u8(paths)
    finally:
        io.close()
    assert (NativeFrameIO.decoded - before[0], NativeFrameIO.encoded - before[1]) == (3, 3)
    np.testing.assert_array_equal(back, frames)
    for path, frame in zip(paths, frames):
        np.testing.assert_array_equal(read_png(path), frame)
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], frame)
        data = Path(path).read_bytes()
        assert struct.unpack(">IIBBBBB", data[16:29]) == (40, 24, 8, 2, 0, 0, 0)
        idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(24, 1 + 40 * 3)
        assert (rows[:, 0] == 1).all()


LOADER = dict(crop_size=8, rnn_n=4, batch_size=3, max_frm=7, str_dir=2000, end_dir=2001,
              end_dir_val=2002, queue_thread=2, rand_seed=4)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Three scenes of 8 frames, 60x64 (over the 40-px HR crop plus the
    12-px camera-pan margin of rnn_n 4)."""
    root = str(tmp_path_factory.mktemp("scenes"))
    write_synthetic_scenes(root, 3, 8, 60, 64, start_index=2000)
    return root


@pytest.mark.parametrize("cache_mb", [0, 16])
@pytest.mark.parametrize("as_uint8", [True, False], ids=["uint8", "float32"])
def test_native_batches_match_python_and_jax(scenes, as_uint8, cache_mb):
    """Same seed: the native executor's batches equal the port's python
    executor's and the JAX package's python executor's bit for bit (float32
    [0, 1] and uint8, frame cache on and off)."""
    kw = dict(LOADER, input_video_dir=scenes, train_upload_uint8=as_uint8,
              loader_cache_mb=cache_mb)
    cfg = TecoConfig(**kw)
    with BatchLoader(SceneDataset(cfg), executor="native") as native, \
            BatchLoader(SceneDataset(cfg), executor="python") as python, \
            JaxBatchLoader(JaxSceneDataset(JaxConfig(**kw)), executor="python") as jax:
        assert (native.executor_used, python.executor_used) == ("native", "python")
        assert native.dataset.frame_cache is None
        assert (python.dataset.frame_cache is not None) == (cache_mb > 0)
        before = NativeExecutor.sequences
        for _ in range(4):
            a, b, c = native.next_batch(), python.next_batch(), jax.next_batch()
            assert a.dtype == (np.uint8 if as_uint8 else np.float32)
            assert a.shape == (3, 4, 40, 40, 3)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert NativeExecutor.sequences - before >= 12


def test_native_executor_moving_first_frame(scenes):
    """Camera-pan plans (one frame repeated at per-frame offsets) and flips
    through the C++ pool equal the python executor's crops."""
    ds = SceneDataset(TecoConfig(input_video_dir=scenes, **LOADER))
    plans = [ds.plan_sequence(i % len(ds), np.random.RandomState(s))
             for i, s in zip(range(40), range(100, 140))]
    moving = [p for p in plans if len(set(p.paths)) == 1]
    assert moving and any(p.flip for p in moving)
    for cache_mb in (0, 8):
        ex = NativeExecutor(2, rnn_n=4, tar=40, cache_mb=cache_mb)
        try:
            for as_uint8 in (True, False):
                got = ex.load(plans, as_uint8=as_uint8)
                want = np.stack([ds.load_plan(p, as_uint8) for p in plans])
                np.testing.assert_array_equal(got, want)
        finally:
            ex.close()
    bad = plans[0]._replace(oy=plans[0].oy + 100)  # a crop outside the frame
    ex = NativeExecutor(1, rnn_n=4, tar=40)
    try:
        with pytest.raises(IOError, match="1 sequence"):
            ex.load([plans[1], bad])
        with pytest.raises(ValueError):
            ex.load([plans[1]._replace(paths=plans[1].paths[:3])])
    finally:
        ex.close()


@pytest.mark.parametrize("compiler", ["/nonexistent/c++", "false"], ids=["missing", "failing"])
def test_native_unavailable_raises_or_falls_back(scenes, monkeypatch, capsys, compiler):
    """``$CXX`` names the compiler (a new one builds anew): where it cannot
    build, executor="native" raises, "auto" prints the cause and runs the
    python executor, and the frame I/O falls back to data/png.py."""
    monkeypatch.setenv("CXX", compiler)
    assert native_loader.library_path() != native_loader.library_path("g++")
    assert not native_loader.native_available()
    cfg = TecoConfig(input_video_dir=scenes, **LOADER)
    with pytest.raises(native_loader.UNAVAILABLE_ERRORS):
        BatchLoader(SceneDataset(cfg), executor="native")
    with BatchLoader(SceneDataset(cfg), executor="auto") as auto:
        assert auto.executor_used == "python"
        printed = capsys.readouterr().out
        assert "BatchLoader: native decoder unavailable" in printed
        assert ("FileNotFoundError" if compiler.startswith("/") else "CalledProcessError") \
            in printed
        monkeypatch.delenv("CXX")
        with BatchLoader(SceneDataset(cfg), executor="python") as python:
            np.testing.assert_array_equal(auto.next_batch(), python.next_batch())
    monkeypatch.setenv("CXX", compiler)
    assert inference._native_io() is None
    assert "inference IO: native decoder unavailable" in capsys.readouterr().out
    with pytest.raises(ValueError, match="python|native|auto"):
        BatchLoader(SceneDataset(cfg), executor="cv2")


def test_inference_io_native_matches_python(tmp_path):
    """load_inference_frames on both routes and FrameWriter give the same
    pixels with and without the native codec, and the counters show which
    ran."""
    hr = (synthetic_clip(7, 32, 40, seed=3, content="natural") * 255).astype(np.uint8)
    lr_dir, hr_dir = tmp_path / "lr", tmp_path / "hr"
    lr_dir.mkdir()
    hr_dir.mkdir()
    for i, frame in enumerate(hr):
        write_png(str(hr_dir / f"im{i + 1}.png"), frame)
        write_png_raw(str(lr_dir / f"im{i + 1}.png"), frame[::4, ::4], 8, 2)  # every filter
    routes = [dict(input_dir_lr=str(lr_dir), as_uint8=True),
              dict(input_dir_lr=str(lr_dir), as_uint8=False),
              dict(input_dir_hr=str(hr_dir))]
    for kw in routes:
        before = NativeFrameIO.decoded
        got = load_inference_frames(**kw, device="cpu")
        assert NativeFrameIO.decoded - before == 7
        want = load_inference_frames(**kw, device="cpu", use_native=False)
        assert NativeFrameIO.decoded - before == 7
        assert got.paths_lr == want.paths_lr and got.inputs.dtype == want.inputs.dtype
        np.testing.assert_array_equal(got.inputs, want.inputs)
    written = {}
    for native in (True, False):
        out = tmp_path / f"out_{native}"
        before = NativeFrameIO.encoded
        if native:
            writer = FrameWriter(str(out), warmup=5, num_threads=2)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(inference, "_native_io", lambda num_threads=8: None)
                writer = FrameWriter(str(out), warmup=5, num_threads=2)
        writer.submit(hr[:4], 5)
        writer.submit(hr[4:], 9)
        assert writer.close() == 7 and writer.encode_s > 0
        assert NativeFrameIO.encoded - before == (7 if native else 0)
        written[native] = np.stack([read_png(str(out / f"output_{i:04d}.png")) for i in range(7)])
    np.testing.assert_array_equal(written[True], hr)
    np.testing.assert_array_equal(written[False], hr)


def test_frame_source_native_matches_python(tmp_path, monkeypatch):
    """A serving source decodes its PNG directory in blocks through the
    native pool, in the order (warm-up included) and with the pixels of the
    python codec, and counts its decode seconds."""
    clip = (synthetic_clip(9, 12, 20, seed=5, content="natural") * 255).astype(np.uint8)
    for i, frame in enumerate(clip):
        write_png_raw(str(tmp_path / f"{i:04d}.png"), frame, 8, 2, filters=lambda y: 4)

    def drain(**kw):
        src = FrameSource(str(tmp_path), **kw)
        frames = []
        while True:
            f = src.try_next()
            if f is EOS:
                break
            if isinstance(f, np.ndarray):
                frames.append(f)
        src.stop()
        return np.stack(frames), src.decode_s

    before = NativeFrameIO.decoded
    native, secs = drain(as_uint8=True)
    assert NativeFrameIO.decoded - before == 9 and secs > 0
    native_f32, _ = drain(as_uint8=False, warmup=False)
    monkeypatch.setattr(inference, "_native_io", lambda num_threads=8: None)
    python, _ = drain(as_uint8=True)
    assert NativeFrameIO.decoded - before == 18
    assert native.shape == (14, 12, 20, 3)
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native[5:], clip)
    np.testing.assert_array_equal(native_f32, clip.astype(np.float32) / 255.0)


def test_build_is_atomic_under_concurrent_builds(tmp_path, monkeypatch):
    """Processes that build one library at once each load a whole file:
    four builds of a fresh library path started together."""
    monkeypatch.setattr(native_loader, "_PKG", tmp_path)
    (tmp_path / "csrc").mkdir()
    source = tmp_path / "csrc" / "tecodata.cpp"
    source.write_bytes(native_loader._SOURCE.read_bytes())
    monkeypatch.setattr(native_loader, "_SOURCE", source)
    script = ("import sys, ctypes; from pathlib import Path; "
              "import tecogan_tpu_torch.data.native_loader as nl; "
              f"nl._PKG = Path({str(tmp_path)!r}); nl._SOURCE = Path({str(source)!r}); "
              "lib = ctypes.CDLL(str(nl.build_library())); print(lib.td_png_dims is not None)")
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert all(out.strip() == "True" for out, _ in outs)
    built = list((tmp_path / "_build").glob("tecodata-*/*"))
    assert sorted(p.name for p in built) == ["build.lock", "libtecodata.so"]
