"""The port's video-file I/O (``data/video_io.py`` on ``csrc/tecovideo*.cpp``)
against OpenCV's FFmpeg backend and the JAX package's ``data/video_io.py``
on the CPU: demuxed packets byte for byte, decoded frames, written files,
seeking, ``extract_scene``, ``create_capture``, and ``cli.main`` /
``cli.serve`` with video input and output.

cv2 (OpenCV built with FFmpeg) and PIL are oracles here only.
The decoder reproduces FFmpeg's reconstruction and swscale's YUV -> RGB, so
frames equal cv2's bit for bit on every stream OpenCV writes (the target
was max 3 / mean 0.5 levels). Known deviations, each pinned below: a
4:4:4 JPEG (swscale leaves its unscaled path) within 2 levels, and the
MPEG-4 writer's I-VOP-only stream.
"""

import io
import os

import cv2
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import main as jax_cli
from tecogan_tpu.cli import serve as jax_cli_serve
from tecogan_tpu.data import prepare as jax_prepare
from tecogan_tpu.data import synthetic as jax_synthetic
from tecogan_tpu.data.video_io import VideoFrameWriter as JaxVideoFrameWriter
from tecogan_tpu.data.video_io import read_video_frames as jax_read_video_frames
from tecogan_tpu_torch.cli import serve as cli_serve
from tecogan_tpu_torch.cli.main import main
from tecogan_tpu_torch.data import prepare, synthetic, video_native
from tecogan_tpu_torch.data.inference import load_inference_frames, read_rgb
from tecogan_tpu_torch.data.png import write_png
from tecogan_tpu_torch.data.video_io import (
    VideoFrameWriter,
    VideoReader,
    fps_rational,
    read_video_frames,
)
from tecogan_tpu_torch.serve import FrameSource

torch.set_num_threads(1)

# Each cv2 writer the JAX package (or OpenCV directly, for XVID) uses, by
# extension and fourcc.
PAIRS = [("mp4", "mp4v"), ("m4v", "mp4v"), ("avi", "MJPG"), ("avi", "XVID"),
         ("mkv", "mp4v"), ("mkv", "MJPG")]
DECODE_PAIRS = [p for p in PAIRS if p[0] != "m4v"]  # .m4v is .mp4's container
# The CLIs' PNGs against the JAX CLIs' (as tests/test_torch_cli.py): at most
# one level, on at most 0.1% of pixels.
U8_MAX_FLIPPED = 1e-3


def _clip(t, h, w, kind, seed=0):
    """``t`` RGB frames: moving sinusoids plus mild noise ("smooth", the
    case of video content) or uniform noise."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(t):
        f = np.stack([128 + 100 * np.sin((xx + 3 * i) / 7.0) * np.cos((yy - i) / 5.0),
                      128 + 80 * np.cos((xx - 2 * i) / 9.0),
                      128 + 60 * np.sin((yy + i) / 6.0)], -1)
        out.append(np.clip(f + rng.normal(0, 3, f.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def _cv2_write(path, frames, fourcc, fps):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                         (frames.shape[2], frames.shape[1]))
    assert wr.isOpened(), f"OpenCV cannot write {fourcc}"
    for f in frames:
        wr.write(np.ascontiguousarray(f[:, :, ::-1]))
    wr.release()


def _write_like_jax(path, frames, fourcc, fps):
    """The JAX package's writer where it picks ``fourcc`` for the extension
    (XVID, its .avi fallback, through OpenCV directly)."""
    if fourcc == "XVID" or (path.suffix == ".mkv" and fourcc == "MJPG"):
        _cv2_write(path, frames, fourcc, fps)  # the JAX writer's second choice
        return
    w = JaxVideoFrameWriter(str(path), fps=fps)
    w.submit(frames, 0)
    assert w.close() == len(frames)


def _cv2_packets(path):
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    fps, out = cap.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        out.append(p.tobytes())
    cap.release()
    return fps, out


def _cv2_frames(path):
    cap, out = cv2.VideoCapture(str(path)), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[:, :, ::-1])
    cap.release()
    return np.stack(out)


def test_library_builds_and_a_failed_build_raises(monkeypatch):
    lib = video_native.load_library()
    assert video_native.library_path().exists() and lib.tv_last_error_kind() >= 0
    for cxx, match in (("tecovideo-no-such-compiler", "No such file"), ("false", "exited 1")):
        monkeypatch.setenv("CXX", cxx)
        with pytest.raises(video_native.VideoBuildError, match=match):
            video_native.build_library()


@pytest.mark.parametrize("fps", [10.0, 12.0, 24.0, 29.97])
@pytest.mark.parametrize("ext,fourcc", PAIRS, ids=[f"{e}-{c}" for e, c in PAIRS])
def test_demux_matches_cv2(tmp_path, ext, fourcc, fps):
    """Every packet equals cv2's raw packet byte for byte; counts, fps."""
    path = tmp_path / f"clip.{ext}"
    _write_like_jax(path, _clip(14, 16, 16, "smooth"), fourcc, fps)
    want_fps, want = _cv2_packets(path)
    r = video_native.NativeVideoReader(str(path))
    got = [r.packet(i) for i in range(r.packet_count)]
    assert r.codec == ("mjpeg" if fourcc == "MJPG" else "mpeg4")
    assert r.container == ("mp4" if ext == "m4v" else ext)
    assert (r.width, r.height) == (16, 16)
    assert len(got) == len(want) == 14 and got == want
    assert r.fps == want_fps and abs(r.fps - fps) < 1e-9
    keys = [r.packet_info(i)[2] for i in range(14)]
    if fourcc == "MJPG":
        assert all(keys)
    else:  # key = an I-VOP (lavc adds I-VOPs at scene changes to its GOPs of 12)
        vop_types = [p[p.index(b"\x00\x00\x01\xb6") + 4] >> 6 for p in got]
        assert keys == [t == 0 for t in vop_types] and keys[0] and not all(keys)
    if fourcc == "mp4v":  # the VOL header travels in the esds / CodecPrivate
        assert r.extradata.startswith(b"\x00\x00\x01\xb0") and b"\x00\x00\x01\x20" in r.extradata
    r.close()


@pytest.mark.parametrize("hw", [(16, 16), (36, 52)], ids=["16x16", "36x52"])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("ext,fourcc", DECODE_PAIRS, ids=[f"{e}-{c}" for e, c in DECODE_PAIRS])
def test_decode_matches_jax(tmp_path, ext, fourcc, kind, hw):
    """14 frames (a second I-VOP at frame 12 for MPEG-4): bit-equal to the
    JAX package's read_video_frames, fps equal."""
    path = tmp_path / f"clip.{ext}"
    _write_like_jax(path, _clip(14, *hw, kind), fourcc, 24.0)
    got, fps = read_video_frames(str(path))
    want, want_fps = jax_read_video_frames(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape == (14, *hw, 3)
    np.testing.assert_array_equal(got, want)
    assert fps == want_fps == 24.0
    if kind == "smooth":
        assert got.std() > 10


def test_read_video_frames_options(tmp_path):
    path = tmp_path / "clip.mp4"
    _write_like_jax(path, _clip(14, 16, 16, "smooth"), "mp4v", 12.0)
    full, _ = read_video_frames(str(path))
    for max_frames, as_uint8 in ((3, False), (13, True), (0, True), (-1, False)):
        got, fps = read_video_frames(str(path), max_frames=max_frames, as_uint8=as_uint8)
        want, want_fps = jax_read_video_frames(str(path), max_frames=max_frames,
                                               as_uint8=as_uint8)
        assert got.dtype == want.dtype and got.shape == want.shape and fps == want_fps
        np.testing.assert_array_equal(got, want)
    assert full.shape[0] == 14
    with pytest.raises(FileNotFoundError):
        read_video_frames(str(tmp_path / "nope.mp4"))
    with pytest.raises(FileNotFoundError):
        jax_read_video_frames(str(tmp_path / "nope.mp4"))


def _strip_dht(jpeg):
    out, p = bytearray(jpeg[:2]), 2
    while p < len(jpeg):
        marker = jpeg[p + 1]
        if marker == 0xDA:
            out += jpeg[p:]
            break
        length = (jpeg[p + 2] << 8) | jpeg[p + 3]
        if marker != 0xC4:
            out += jpeg[p:p + 2 + length]
        p += 2 + length
    return bytes(out)


@pytest.mark.parametrize("variant", ["420", "422", "444", "gray", "restart", "no_dht"])
def test_jpeg_variants_match_cv2(tmp_path, variant):
    """Motion JPEG from other encoders (libjpeg through PIL), muxed into an
    AVI by the port's writer: 4:2:0, 4:2:2, gray, restart markers and the
    Annex K tables of a frame without DHT are bit-equal to cv2; 4:4:4,
    which swscale converts on its scaled path, within 2 levels."""
    from PIL import Image

    frames = _clip(3, 36, 52, "smooth", seed=2)
    kw = {"420": dict(subsampling=2), "422": dict(subsampling=1), "444": dict(subsampling=0),
          "gray": {}, "restart": dict(subsampling=2, restart_marker_blocks=2),
          "no_dht": dict(subsampling=2)}[variant]
    path = str(tmp_path / "pil.avi")
    w = video_native.NativeVideoWriter(path, video_native.AVI_MJPEG, 52, 36, 24, 1, 90)
    for f in frames:
        im = Image.fromarray(f).convert("L") if variant == "gray" else Image.fromarray(f)
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=85, **kw)
        data = buf.getvalue()
        if variant == "restart":
            assert b"\xff\xdd" in data
        if variant == "no_dht":
            data = _strip_dht(data)
            assert b"\xff\xc4" not in data
        w.write_packet(data)
    w.close()
    got, _ = read_video_frames(path)
    want = _cv2_frames(path)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == (3, 36, 52, 3)
    assert diff.max() <= (2 if variant == "444" else 0), diff.max()


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("ext", ["avi", "mp4", "m4v", "mkv"])
def test_writer_opens_in_cv2(tmp_path, ext, kind, capsys):
    """The port's files open in cv2 with the right count, shape and fps, cv2
    decodes them to the port's own frames, and they are no farther from
    the source than the JAX writer's on the same frames + 0.5 mean levels."""
    frames = _clip(30, 36, 52, kind, seed=3)
    path, jax_path = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
    w = VideoFrameWriter(str(path), fps=29.97)
    w.submit(frames[:13], 0)
    w.submit(frames[13:], 13)
    assert w.close() == 30
    jw = JaxVideoFrameWriter(str(jax_path), fps=29.97)
    jw.submit(frames, 0)
    jw.close()
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(29.97, abs=1e-9)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 30
    cap.release()
    by_cv2 = _cv2_frames(path)
    got, fps = read_video_frames(str(path))
    assert by_cv2.shape == got.shape == frames.shape and fps == pytest.approx(29.97)
    np.testing.assert_array_equal(got, by_cv2)
    err = np.abs(got.astype(float) - frames).mean()
    jax_err = np.abs(_cv2_frames(jax_path).astype(float) - frames).mean()
    assert err <= jax_err + 0.5, (err, jax_err)
    with capsys.disabled():  # the sizes, for the record (I-VOPs only vs lavc's GOPs)
        print(f"\n[video size] {ext} {kind} 30x36x52: port {os.path.getsize(path)} B "
              f"(mean err {err:.3f}), JAX writer {os.path.getsize(jax_path)} B "
              f"(mean err {jax_err:.3f})")


def test_mkv_mjpeg_writer(tmp_path):
    frames = _clip(5, 16, 24, "smooth")
    path = str(tmp_path / "m.mkv")
    w = video_native.NativeVideoWriter(path, video_native.MKV_MJPEG, 24, 16, 12, 1, 90)
    w.write(frames)
    w.close()
    r = video_native.NativeVideoReader(path)
    assert (r.codec, r.container, r.packet_count, r.fps) == ("mjpeg", "mkv", 5, 12.0)
    r.close()
    np.testing.assert_array_equal(read_video_frames(path)[0], _cv2_frames(path))


def test_writer_contracts(tmp_path):
    """The JAX writer's contracts: order, the warm-up start, extensions."""
    frames = _clip(6, 32, 32, "smooth")
    w = VideoFrameWriter(str(tmp_path / "bad.mp4"), fps=10.0)
    w.submit(frames[:2], 0)
    w.submit(frames[2:4], 5)  # a gap
    with pytest.raises(ValueError, match="out-of-order"):
        w.close()
    w = VideoFrameWriter(str(tmp_path / "o.mp4"), fps=10.0, warmup=5)
    w.submit(frames[:3], 0)  # must start at the warm-up
    with pytest.raises(ValueError, match="out-of-order"):
        w.close()
    w = VideoFrameWriter(str(tmp_path / "sub" / "o.mp4"), fps=10.0, warmup=5)
    w.submit(frames[:3], 5)
    assert w.close() == 3 and read_video_frames(str(tmp_path / "sub" / "o.mp4"))[0].shape[0] == 3
    for cls in (VideoFrameWriter, JaxVideoFrameWriter):
        with pytest.raises(ValueError, match="extension"):
            cls(str(tmp_path / "out.webm"), fps=10.0)
    assert fps_rational(29.97) == (2997, 100) and fps_rational(24.0) == (24, 1)
    assert fps_rational(23.976) == (2997, 125)


@pytest.mark.parametrize("ext,fourcc", [("avi", "MJPG"), ("mp4", "mp4v")])
def test_seek_and_extract_scene_match_jax(tmp_path, ext, fourcc):
    """extract_scene from frame 5 (inside the MPEG-4 GOP) and 14 (the second
    GOP): the same PNG pixels as the JAX package's; seek equals decoding."""
    path = tmp_path / f"clip.{ext}"
    _write_like_jax(path, _clip(20, 36, 52, "smooth", seed=5), fourcc, 24.0)
    full, _ = read_video_frames(str(path))
    with VideoReader(str(path)) as r:
        for start in (5, 14, 0, 19):
            r.seek(start)
            np.testing.assert_array_equal(r.read(), full[start])
    for start, test_only in ((5, False), (14, True)):
        got_dir, want_dir = tmp_path / f"port{start}", tmp_path / f"jax{start}"
        n = prepare.extract_scene(str(path), start, str(got_dir), duration=4,
                                  test_only=test_only)
        assert n == jax_prepare.extract_scene(str(path), start, str(want_dir), duration=4,
                                              test_only=test_only) == (2 if test_only else 4)
        for i in range(n):
            name = f"col_high_{i:04d}.png"
            got, want = read_rgb(str(got_dir / name)), read_rgb(str(want_dir / name))
            assert got.shape == (18, 26, 3)
            np.testing.assert_array_equal(got, want)


def test_create_capture_path_matches_jax(tmp_path):
    path = tmp_path / "clip.mkv"
    _write_like_jax(path, _clip(8, 16, 24, "smooth"), "mp4v", 24.0)
    cap, jcap = synthetic.create_capture(str(path)), jax_synthetic.create_capture(str(path))
    assert cap.isOpened() and jcap.isOpened()
    for _ in range(9):
        (ok, got), (jok, want) = cap.read(), jcap.read()
        assert ok == jok
        if ok:
            np.testing.assert_array_equal(got, want)  # BGR, as cv2 returns
    cap.release()
    jcap.release()
    missing = str(tmp_path / "missing.mp4")
    assert isinstance(synthetic.create_capture(missing), synthetic.CheckerPlane)
    assert isinstance(jax_synthetic.create_capture(missing), jax_synthetic.CheckerPlane)


def _patched(src, dst, old, new):
    data = src.read_bytes()
    assert data.count(old) >= 1
    dst.write_bytes(data.replace(old, new))


def test_unsupported_codec_raises_naming_12b(tmp_path):
    """H.264 / HEVC / AV1 (the containers' codec fields rewritten): every
    entry point raises NotImplementedError naming item 12b, and none falls
    back to a procedural scene or zeros."""
    frames = _clip(6, 16, 16, "smooth")
    avi, mkv, mp4 = tmp_path / "a.avi", tmp_path / "a.mkv", tmp_path / "a.mp4"
    _write_like_jax(avi, frames, "MJPG", 24.0)
    _write_like_jax(mkv, frames, "mp4v", 24.0)
    _write_like_jax(mp4, frames, "mp4v", 24.0)
    cases = {"h264.avi": (avi, b"MJPG", b"H264"), "avc.mkv": (mkv, b"V_MPEG4/ISO/ASP",
                                                               b"V_MPEG4/ISO/AVC"),
             "hevc.mp4": (mp4, b"mp4v", b"hvc1")}
    for name, (src, old, new) in cases.items():
        bad = tmp_path / name
        _patched(src, bad, old, new)
        with pytest.raises(NotImplementedError, match="item 12b"):
            read_video_frames(str(bad))
        with pytest.raises(NotImplementedError, match="item 12b"):
            synthetic.create_capture(str(bad))
        with pytest.raises(NotImplementedError, match="item 12b"):
            prepare.extract_scene(str(bad), 0, str(tmp_path / "x"))
        src_ = FrameSource(str(bad), warmup=False)
        with pytest.raises(NotImplementedError, match="item 12b"):
            src_.geometry(timeout=30)
    assert not (tmp_path / "x").exists()
    with pytest.raises(NotImplementedError, match="item 12b"):
        main(["--mode", "inference", "--device", "cpu", "--input_video",
              str(tmp_path / "h264.avi"), "--output_dir", str(tmp_path / "o"),
              "--allow_random_weights", "--num_resblock", "1"])


def test_truncated_and_foreign_files_raise(tmp_path):
    frames = _clip(6, 16, 16, "smooth")
    for ext, fourcc in (("avi", "MJPG"), ("mp4", "mp4v"), ("mkv", "mp4v")):
        path = tmp_path / f"c.{ext}"
        _write_like_jax(path, frames, fourcc, 24.0)
        cut = tmp_path / f"cut.{ext}"
        data = path.read_bytes()
        cut.write_bytes(data[:len(data) * 2 // 3])
        with pytest.raises(ValueError):
            read_video_frames(str(cut))
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not an AVI, MP4 or Matroska"):
        read_video_frames(str(junk))
    with pytest.raises(FileNotFoundError):  # as cv2.VideoCapture fails to open it
        prepare.extract_scene(str(junk), 0, str(tmp_path / "x"))
    with pytest.raises(FileNotFoundError):
        jax_prepare.extract_scene(str(junk), 0, str(tmp_path / "y"))
    assert isinstance(synthetic.create_capture(str(junk)), synthetic.CheckerPlane)


# An MPEG-4 VOL and VOPs crafted bit by bit, to drive what OpenCV's writers
# never produce: the refused features and vop_coded = 0.
def _bits_to_bytes(bits):
    return np.packbits(np.array(bits, np.uint8)).tobytes()


def _put(bits, value, n):
    bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]


def _stuff(bits):
    _put(bits, 0, 1)
    while len(bits) % 8:
        _put(bits, 1, 1)


def _vol(interlaced=0, sprite=0, quarter=0, partitioned=0, resync_disable=1):
    b = []
    for code in (0xB0, 0x00, 0x20):
        _put(b, 0x000001, 24)
        _put(b, code, 8)
        if code == 0xB0:
            _put(b, 1, 8)
    for value, n in ((0, 1), (1, 8), (1, 1), (2, 4), (1, 3), (1, 4), (0, 1), (0, 2), (1, 1),
                     (24, 16), (1, 1), (0, 1), (1, 1), (16, 13), (1, 1), (16, 13), (1, 1),
                     (interlaced, 1), (1, 1), (sprite, 2), (0, 1), (0, 1), (quarter, 1),
                     (1, 1), (resync_disable, 1), (partitioned, 1)):
        _put(b, value, n)
    if partitioned:
        _put(b, 0, 1)
    _put(b, 0, 3)  # newpred, reduced resolution, scalability
    _stuff(b)
    return _bits_to_bytes(b)


def _vop(kind, coded=1):
    b = []
    _put(b, 0x1B6, 32)
    for value, n in ((kind, 2), (0, 1), (1, 1), (0, 5), (1, 1), (coded, 1)):
        _put(b, value, n)
    if coded:
        _put(b, 0, 1)  # rounding
        _put(b, 0, 3)
        _put(b, 5, 5)
        _put(b, 1, 3)
    _stuff(b)
    return _bits_to_bytes(b)


def test_mpeg4_refused_features_and_vop_not_coded(tmp_path):
    frames = _clip(6, 16, 16, "smooth")
    src = str(tmp_path / "i.mkv")
    w = video_native.NativeVideoWriter(src, video_native.MKV_MPEG4, 16, 16, 24, 1, 3)
    w.write(frames)
    w.close()
    r = video_native.NativeVideoReader(src)
    packets, headers = [r.packet(i) for i in range(6)], r.extradata
    r.close()
    assert packets[0].startswith(headers)  # the VOL also in-band, before the first VOP
    # A not-coded P-VOP shows no frame, as FFmpeg skips it.
    path = str(tmp_path / "nc.mkv")
    w = video_native.NativeVideoWriter(path, video_native.MKV_MPEG4, 16, 16, 24, 1, 3)
    for i, p in enumerate(packets):
        w.write_packet(p)
        if i == 2:
            w.write_packet(_vop(1, coded=0), key=False)
    w.close()
    got = read_video_frames(path)[0]
    np.testing.assert_array_equal(got, _cv2_frames(path))
    np.testing.assert_array_equal(got, read_video_frames(src)[0])
    vop = packets[0][len(headers):]
    cases = {"interlace": _vol(interlaced=1) + vop, "GMC/sprites": _vol(sprite=1) + vop,
             "quarter-pel": _vol(quarter=1) + vop,
             "data partitioning": _vol(partitioned=1) + vop,
             "resync markers": _vol(resync_disable=0) + vop}
    for feature, first in list(cases.items()) + [("B-VOPs", None)]:
        path = str(tmp_path / "u.mkv")
        w = video_native.NativeVideoWriter(path, video_native.MKV_MPEG4, 16, 16, 24, 1, 3)
        if first is None:
            w.write_packet(packets[0])
            w.write_packet(_vop(2), key=False)
        else:
            w.write_packet(first)
        w.close()
        with pytest.raises(NotImplementedError, match=feature):
            read_video_frames(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """2-block random generator and FNet weights in the npz interchange."""
    from tecogan_tpu_torch.config import MINI_PRESET
    from tecogan_tpu_torch.models import FNet, Generator
    from tecogan_tpu_torch.models.layers import glorot_init_
    from tecogan_tpu_torch.weights import to_jax_params
    from tecogan_tpu.train.checkpoint import params_to_npz

    g = torch.Generator().manual_seed(0)
    gen = glorot_init_(Generator(2, MINI_PRESET.gen_channels), g)
    fnet = glorot_init_(FNet(MINI_PRESET.fnet_channels, MINI_PRESET.fnet_up_channels,
                             MINI_PRESET.flow_max_velocity), g)
    gp, fp = to_jax_params(gen, fnet)
    path = str(tmp_path_factory.mktemp("weights") / "params.npz")
    params_to_npz(path, generator=gp, fnet=fp)
    return path


def _jax_writer_error(frames, path):
    """The mean error of the JAX writer (OpenCV) on ``frames``: the bound a
    lossy video of them is held to (+ 0.5 levels)."""
    jw = JaxVideoFrameWriter(str(path), fps=24.0)
    jw.submit(frames, 0)
    jw.close()
    return np.abs(_cv2_frames(path).astype(float) - frames).mean()


def _read_pngs(d, n):
    return np.stack([read_rgb(os.path.join(d, f"output_{i:04d}.png")) for i in range(n)])


def test_cli_video_matches_jax_cli(tmp_path, npz, capsys, monkeypatch):
    """--input_video: the port's CLI on the CPU against the JAX CLI on the
    same MJPEG clip and 2-block MINI_PRESET-width weights (PNG route, within
    1 level); the same frames from a PNG directory of the port's decode;
    --output_video at the source's fps or --output_video_fps, decoded by
    the port, within the writer's bound of the PNGs."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    clip = tmp_path / "clip.avi"
    _write_like_jax(clip, _clip(10, 16, 20, "smooth", seed=6), "MJPG", 12.0)
    jax_cli.main(["--mode", "inference", "--input_video", str(clip), "--output_dir",
                  str(tmp_path / "jax"), "--params_npz", npz, "--num_resblock", "2"])
    capsys.readouterr()
    base = ["--mode", "inference", "--device", "cpu", "--params_npz", npz,
            "--queue_thread", "1"]
    stats = main(base + ["--input_video", str(clip), "--output_dir", str(tmp_path / "port")])
    assert stats["written"] == 10 and stats["frames"] == 15 and stats["fps"] == 12.0
    got, want = _read_pngs(tmp_path / "port", 10), _read_pngs(tmp_path / "jax", 10)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == (10, 64, 80, 3) and got.std() > 1.0
    assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED
    # The PNG route on the port's own decode: the same pixels in, the same out.
    lr = tmp_path / "lr"
    lr.mkdir()
    for i, f in enumerate(read_video_frames(str(clip))[0]):
        write_png(str(lr / f"{i:04d}.png"), f)
    main(base + ["--input_dir_LR", str(lr), "--output_dir", str(tmp_path / "png")])
    np.testing.assert_array_equal(_read_pngs(tmp_path / "png", 10), got)
    data = load_inference_frames(input_video=str(clip), as_uint8=True, device="cpu")
    assert data.paths_lr[5] == f"{clip}#0" and data.fps == 12.0
    for ext, extra, fps in (("mp4", [], 12.0), ("avi", ["--output_video_fps", "30"], 30.0)):
        stats = main(base + ["--input_video", str(clip), "--output_dir", str(tmp_path / "v"),
                             "--output_pre", "scene", "--output_video", f"hr.{ext}"] + extra)
        path = tmp_path / "v" / "scene" / f"hr.{ext}"
        assert stats["dest"] == str(path) and stats["written"] == 10
        hr, hr_fps = read_video_frames(str(path))
        assert hr.shape == got.shape and hr_fps == fps
        bound = _jax_writer_error(got, tmp_path / f"jax_hr.{ext}") + 0.5
        assert np.abs(hr.astype(float) - got).mean() <= bound
        assert "Wrote 10 frames to " + str(path) in capsys.readouterr().out


def test_cli_serve_video_sources(tmp_path, npz, capsys, monkeypatch):
    """Two video sources of different geometries through the port's
    cli.serve and the JAX cli.serve (PNGs within 1 level); --output_videos
    writes <name>.mp4 at each source's fps."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    a, b = tmp_path / "walk.mp4", tmp_path / "city.avi"
    _write_like_jax(a, _clip(8, 16, 16, "smooth", seed=7), "mp4v", 10.0)
    _write_like_jax(b, _clip(7, 12, 20, "smooth", seed=8), "MJPG", 24.0)
    srcs = f"{a},{b}"
    jax_cli_serve.main(["--input_dirs", srcs, "--output_dir", str(tmp_path / "jax"),
                        "--max_streams", "2", "--params_npz", npz, "--num_resblock", "2"])
    capsys.readouterr()
    base = ["--device", "cpu", "--input_dirs", srcs, "--max_streams", "2", "--params_npz",
            npz, "--lookahead", "2"]
    stats = cli_serve.main(base + ["--output_dir", str(tmp_path / "port")])
    lengths, shapes = {"walk": 8, "city": 7}, {"walk": (64, 64), "city": (48, 80)}
    assert stats["written"] == lengths
    pngs = {}
    for name, t in lengths.items():
        got = pngs[name] = _read_pngs(tmp_path / "port" / name, t)
        want = _read_pngs(tmp_path / "jax" / name, t)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert got.shape == (t, *shapes[name], 3)
        assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED
    stats = cli_serve.main(base + ["--output_dir", str(tmp_path / "vid"), "--output_videos"])
    assert stats["written"] == lengths
    for name, fps in (("walk", 10.0), ("city", 24.0)):
        hr, hr_fps = read_video_frames(str(tmp_path / "vid" / f"{name}.mp4"))
        assert hr.shape == pngs[name].shape and hr_fps == fps
        bound = _jax_writer_error(pngs[name], tmp_path / f"jax_{name}.mp4") + 0.5
        assert np.abs(hr.astype(float) - pngs[name]).mean() <= bound


def test_chip_smoke_video_bound(tmp_path):
    """chip_smoke.py phase 14 holds each written file's mean error to
    VIDEO_ERR_BOUND: the JAX writer's error on the same clip + 0.5, the
    bound of test_writer_opens_in_cv2; the port's files meet it here."""
    import chip_smoke

    clip = chip_smoke.video_clip(chip_smoke.VIDEO_FRAMES, chip_smoke.LR_H, chip_smoke.LR_W,
                                 chip_smoke.VIDEO_SEED)
    for ext, fps in chip_smoke.VIDEO_FILES:
        path, jax_path = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        w = VideoFrameWriter(str(path), fps=fps)
        w.submit(clip, 0)
        w.close()
        jw = JaxVideoFrameWriter(str(jax_path), fps=fps)
        jw.submit(clip, 0)
        jw.close()
        back, back_fps = read_video_frames(str(path))
        err = np.abs(back.astype(float) - clip).mean()
        jax_err = np.abs(_cv2_frames(jax_path).astype(float) - clip).mean()
        bound = chip_smoke.VIDEO_ERR_BOUND[ext]
        assert back_fps == fps and err <= bound <= jax_err + 0.5, (ext, err, bound, jax_err)


@pytest.mark.parametrize("q", [2, 7, 20, 31])
def test_mpeg4_intra_paths_match_cv2(tmp_path, q):
    """I-VOPs through the decoder paths OpenCV's writers leave out: MPEG
    quantisation (default matrices) and the intra DC among the TCOEF events
    (intra_dc_vlc_thr 7), at quantisers across every DC-scale range."""
    rng = np.random.default_rng(q)
    frames = np.concatenate([_clip(2, 36, 52, "smooth", seed=q),
                             rng.integers(0, 256, (1, 36, 52, 3), dtype=np.uint8)])
    for options in (0, video_native.MPEG4_MPEG_QUANT, video_native.MPEG4_DC_IN_TCOEF,
                    video_native.MPEG4_MPEG_QUANT | video_native.MPEG4_DC_IN_TCOEF):
        path = str(tmp_path / f"o{options}.mkv")
        w = video_native.NativeVideoWriter(path, video_native.MKV_MPEG4, 52, 36, 24, 1, q,
                                           options)
        w.write(frames)
        w.close()
        np.testing.assert_array_equal(read_video_frames(path)[0], _cv2_frames(path))


# Inter VLCs for crafting P-VOPs: MVD codes 0..32, MCBPC (index: 4MV * 16 +
# dquant * 8 + chroma cbp), CBPY in its intra form.
_MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9),
       (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10),
       (9, 10), (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11),
       (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)]
_MCBPC = {0: (1, 1), 1: (3, 4), 2: (2, 4), 3: (5, 6), 8: (3, 3), 9: (7, 7), 10: (6, 7),
          11: (5, 9), 16: (2, 3), 17: (5, 7), 18: (4, 7), 19: (5, 8)}
_CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6),
         (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]


def _p_vop(rng, mbw, mbh, t, residual):
    """A P-VOP of random macroblocks: not coded, 1MV, 4MV or 1MV with
    dquant, random MV differentials (f_code 1-3), a random rounding type;
    with ``residual``, random CBPs of escape-3 TCOEF events."""
    b = []
    for value, n in ((0x1B6, 32), (1, 2), (0, 1), (1, 1), (t, 5), (1, 1), (1, 1),
                     (int(rng.integers(2)), 1), (0, 3), (int(rng.integers(1, 9)), 5)):
        _put(b, value, n)
    fcode = int(rng.integers(1, 4))
    _put(b, fcode, 3)
    for _ in range(mbw * mbh):
        if rng.random() < 0.25:
            _put(b, 1, 1)  # not coded
            continue
        _put(b, 0, 1)
        four = rng.random() < 0.4
        dquant = not four and rng.random() < 0.3
        cbpc, cbpy = (int(rng.integers(4)), int(rng.integers(16))) if residual else (0, 0)
        _put(b, *_MCBPC[16 * four + 8 * dquant + cbpc])
        _put(b, *_CBPY[cbpy ^ 15])
        if dquant:
            _put(b, int(rng.integers(4)), 2)
        for _ in range(8 if four else 2):  # x and y per vector
            code = int(rng.integers(0, 33)) if rng.random() < 0.5 else int(rng.integers(0, 4))
            _put(b, *_MV[code])
            if code:
                _put(b, int(rng.integers(2)), 1)
                if fcode > 1:
                    _put(b, int(rng.integers(1 << (fcode - 1))), fcode - 1)
        cbp = (cbpy << 2) | cbpc
        for n in range(6):
            if not cbp & (32 >> n):
                continue
            events, pos = int(rng.integers(1, 5)), -1
            for e in range(events):
                run = int(rng.integers(0, 6))
                pos += run + 1
                last = e == events - 1 or pos >= 58
                level = int(rng.integers(1, 10)) * (1 if rng.random() < 0.5 else -1)
                for value, n_ in ((3, 7), (3, 2), (last, 1), (run, 6), (1, 1),
                                  (level & 0xFFF, 12), (1, 1)):
                    _put(b, value, n_)
                if last:
                    break
    _stuff(b)
    return _bits_to_bytes(b)


@pytest.mark.parametrize("hw", [(36, 52), (48, 64)], ids=["36x52", "48x64"])
@pytest.mark.parametrize("options", [0, 1], ids=["h263_quant", "mpeg_quant"])
def test_crafted_p_vops_match_cv2(tmp_path, hw, options):
    """P-VOPs crafted bit by bit after an I-VOP of the port's encoder: 4MV
    (median prediction, the chroma vector's rounding, FFmpeg's clip of each
    8x8 block to the displayed size), 1MV, not-coded macroblocks, f_code
    1-3, both rounding types, unrestricted vectors, dquant. Without
    residuals: bit-equal to cv2. With escape-3 residuals under H.263 or
    MPEG quantisation (mismatch control included): bit-equal but for rare
    +-1-2 levels where FFmpeg's x86-64 SSE2 IDCT rounds otherwise than the
    C simple IDCT the port follows (the tolerance below: a few pixels in a
    few clips)."""
    h, w = hw
    for residual in (False, True):
        rng = np.random.default_rng(h * w + options + 7 * residual)
        src = str(tmp_path / "i.mkv")
        wr = video_native.NativeVideoWriter(src, video_native.MKV_MPEG4, w, h, 24, 1, 3, options)
        wr.write(_clip(1, h, w, "smooth", seed=5))
        wr.close()
        first = video_native.NativeVideoReader(src).packet(0)
        path = str(tmp_path / "p.mkv")
        wr = video_native.NativeVideoWriter(path, video_native.MKV_MPEG4, w, h, 24, 1, 3)
        wr.write_packet(first)
        for t in range(1, 12):
            wr.write_packet(_p_vop(rng, (w + 15) // 16, (h + 15) // 16, t, residual), key=False)
        wr.close()
        got, want = read_video_frames(path)[0], _cv2_frames(path)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape == (12, h, w, 3) and got.std() > 20
        if residual:
            assert diff.max() <= 2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())
        else:
            assert diff.max() == 0


def _boxes(data, start=0, end=None):
    """Top-level ISO BMFF boxes as (type, offset, size)."""
    import struct

    out, p, end = [], start, len(data) if end is None else end
    while p + 8 <= end:
        size, kind = struct.unpack(">I4s", data[p:p + 8])
        if size == 1:
            size = struct.unpack(">Q", data[p + 8:p + 16])[0]
        out.append((kind.decode(), p, size))
        p += size
    return out


def _faststart(data):
    """The same MP4 with moov moved before mdat (its chunk offsets shifted)."""
    import struct

    boxes = {k: (o, s) for k, o, s in _boxes(data)}
    moov = bytearray(data[boxes["moov"][0]:boxes["moov"][0] + boxes["moov"][1]])
    at = moov.index(b"stco")
    n = struct.unpack(">I", moov[at + 8:at + 12])[0]
    for i in range(n):
        p = at + 12 + 4 * i
        moov[p:p + 4] = struct.pack(">I", struct.unpack(">I", moov[p:p + 4])[0] + len(moov))
    ftyp = data[:boxes["ftyp"][0] + boxes["ftyp"][1]]
    rest = data[len(ftyp):boxes["moov"][0]]
    return ftyp + bytes(moov) + rest


def _mkv_unknown_sizes(data):
    """The same Matroska file with the Segment's and every Cluster's size
    written as unknown (all ones, same length)."""
    out = bytearray(data)
    for eid in (b"\x18\x53\x80\x67", b"\x1f\x43\xb6\x75"):
        p = out.find(eid)
        while p >= 0:
            q = p + 4
            length = next(i + 1 for i in range(8) if out[q] & (0x80 >> i))
            out[q:q + length] = bytes([(0xFF >> (length - 1)) | (0x80 >> (length - 1))]
                                      + [0xFF] * (length - 1))
            p = out.find(eid, q)
    return bytes(out)


def _avi_rec_no_index(data):
    """The same AVI with each movi chunk inside a LIST 'rec ' and no idx1."""
    import struct

    movi = data.index(b"movi") - 8
    movi_size = struct.unpack("<I", data[movi + 4:movi + 8])[0]
    p, end, body = movi + 12, movi + 8 + movi_size, b"movi"
    while p + 8 <= end:
        size = struct.unpack("<I", data[p + 4:p + 8])[0]
        chunk = data[p:p + 8 + size + (size & 1)]
        body += b"LIST" + struct.pack("<I", 4 + len(chunk)) + b"rec " + chunk
        p += 8 + size + (size & 1)
    head = data[:movi] + b"LIST" + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", len(head) - 8) + head[8:]


@pytest.mark.parametrize("layout", ["mp4_faststart", "mkv_unknown_sizes", "avi_rec_no_idx1"])
def test_container_layouts(tmp_path, layout):
    """Layouts other writers use: the packets and frames equal those of the
    file they were rewritten from, and cv2 decodes the same frames."""
    ext, fourcc, rewrite = {"mp4_faststart": ("mp4", "mp4v", _faststart),
                            "mkv_unknown_sizes": ("mkv", "mp4v", _mkv_unknown_sizes),
                            "avi_rec_no_idx1": ("avi", "XVID", _avi_rec_no_index)}[layout]
    src, dst = tmp_path / f"src.{ext}", tmp_path / f"dst.{ext}"
    _write_like_jax(src, _clip(14, 16, 24, "smooth"), fourcc, 24.0)
    dst.write_bytes(rewrite(src.read_bytes()))
    a, b = video_native.NativeVideoReader(str(src)), video_native.NativeVideoReader(str(dst))
    assert a.packet_count == b.packet_count == 14 and a.fps == b.fps == 24.0
    assert [a.packet(i) for i in range(14)] == [b.packet(i) for i in range(14)]
    assert [a.packet_info(i)[2] for i in range(14)] == [b.packet_info(i)[2] for i in range(14)]
    got = read_video_frames(str(dst))[0]
    np.testing.assert_array_equal(got, read_video_frames(str(src))[0])
    np.testing.assert_array_equal(got, _cv2_frames(dst))


def test_refused_container_features(tmp_path):
    """An OpenDML index (indx) and a laced Matroska block raise
    NotImplementedError naming them."""
    avi, mkv = tmp_path / "a.avi", tmp_path / "a.mkv"
    _write_like_jax(avi, _clip(6, 16, 16, "smooth"), "MJPG", 24.0)
    data = avi.read_bytes()
    strl = data.index(b"strl")
    junk = data.index(b"JUNK", strl)  # FFmpeg's placeholder for an OpenDML index
    (tmp_path / "odml.avi").write_bytes(data[:junk] + b"indx" + data[junk + 4:])
    with pytest.raises(NotImplementedError, match="OpenDML"):
        read_video_frames(str(tmp_path / "odml.avi"))
    w = video_native.NativeVideoWriter(str(mkv), video_native.MKV_MPEG4, 16, 16, 24, 1, 3)
    w.write(_clip(3, 16, 16, "smooth"))
    w.close()
    data = bytearray(mkv.read_bytes())
    cluster = data.index(b"\x1f\x43\xb6\x75")
    block = data.index(b"\xa3", cluster)  # the first SimpleBlock: id, size, track, time, flags
    size_len = next(i + 1 for i in range(8) if data[block + 1] & (0x80 >> i))
    data[block + 1 + size_len + 3] |= 0x02  # Xiph lacing
    (tmp_path / "laced.mkv").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="laced"):
        read_video_frames(str(tmp_path / "laced.mkv"))
