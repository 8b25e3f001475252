"""H.264 and VP9 input of the port (``data/video_nvdec.py``, the NV12 kernel
``kernels/nv12.py``) on the CPU, over the test streams of
``tests/nvdec_streams.py``.

The card's NVDEC decodes H.264 and VP9; without a card, the CPU tests hold
what the card's run is compared with:

- the hand-written H.264 streams decode in OpenCV, through the JAX
  package's ``read_video_frames``, to the frames their numpy model gives,
  converted by the NV12 kernel's plain version, in MP4 and MKV;
- the port's Annex B packets of those files decode in OpenCV to the same
  frames;
- the VP9 fixture's frames, read by the JAX package, match their recorded
  SHA-256, which the card's decode must match too;
- the plain NV12 version against the port's host conversion
  (``csrc/tecovideo_dsp.cpp:picture_to_rgb``, built here into a test
  library);
- the reader's loop and seek over :class:`nvdec_streams.ModelNvdec`;
- what raises: H.264 and VP9 on the CPU, HEVC and AV1 (item 12c), a
  refused profile, a driver without the NVDEC libraries.

``make_vp9_fixture`` rewrites the VP9 fixture and its record:
``PYTHONPATH=. python tests/test_torch_nvdec.py``.
"""

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
from nvdec_streams import (FPS, STREAMS, VP9_FIXTURE, VP9_SHA256, H264Stream, ModelNvdec,
                           _full, frame_sha256, mkv_file, mp4_file, vp9_expected)


def make_vp9_fixture() -> None:
    """Writes :data:`VP9_FIXTURE` with OpenCV's ``VP90`` writer (libvpx,
    hidden alt-ref frames in superframes) from 24 frames of the port's
    procedural scene at 144x180, and :data:`VP9_SHA256`: the SHA-256 of each
    frame the JAX package's ``read_video_frames`` returns, its rate and
    shape. Not run by the tests: ``PYTHONPATH=. python tests/test_torch_nvdec.py``."""
    import cv2

    from tecogan_tpu.data.video_io import read_video_frames
    from tecogan_tpu_torch.data.synthetic import synthetic_clip

    clip = (synthetic_clip(24, 144, 180, seed=15, content="natural") * 255).astype(np.uint8)
    VP9_FIXTURE.parent.mkdir(exist_ok=True)
    wr = cv2.VideoWriter(str(VP9_FIXTURE), cv2.VideoWriter_fourcc(*"VP90"), 24.0, (180, 144))
    assert wr.isOpened()
    for f in clip:
        wr.write(np.ascontiguousarray(f[:, :, ::-1]))
    wr.release()
    frames, fps = read_video_frames(str(VP9_FIXTURE))
    VP9_SHA256.write_text(json.dumps({
        "fps": fps, "shape": list(frames.shape),
        "frames": frame_sha256(frames)}, indent=1) + "\n")


def vp9_mp4(path) -> str:
    """The fixture's packets muxed into MP4 (``vp09`` + ``vpcC``)."""
    from tecogan_tpu_torch.data.video_native import NativeVideoReader

    r = NativeVideoReader(str(VP9_FIXTURE))
    samples = [r.packet(i) for i in range(r.packet_count)]
    keys = [r.packet_info(i)[2] for i in range(r.packet_count)]
    w, h = r.width, r.height
    r.close()
    # vpcC 1.0: profile 0, level 1.0, 8 bits 4:2:0, limited range, unspecified colour.
    vpcc = _full(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1), 2, 2, 2, 0, 0]))
    with open(path, "wb") as f:
        f.write(mp4_file(samples, keys, list(range(len(samples))), w, h, b"vp09", vpcc))
    return str(path)


if __name__ == "__main__":
    make_vp9_fixture()


# ---------------------------------------------------------------- tests
CONTAINERS = ("mp4", "mkv")


def _jax_read(path):
    from tecogan_tpu.data.video_io import read_video_frames

    return read_video_frames(str(path))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the tests' sizes are small), restored after."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def streams():
    return {name: H264Stream(name) for name in STREAMS}


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_decodes_in_cv2_to_the_model(tmp_path, streams, name, container):
    """OpenCV (the JAX package's read) decodes each hand-written stream to
    the model's frames bit for bit, at the container's rate. Stream (v)
    shows that cv2 applies the VUI's full range and BT.709 matrix."""
    s = streams[name]
    frames, fps = _jax_read(s.write(tmp_path / f"{name}.{container}"))
    assert fps == FPS
    np.testing.assert_array_equal(frames, s.expected_rgb())


@pytest.mark.parametrize("name", list(STREAMS))
def test_annexb_packets_decode_in_cv2(tmp_path, streams, name):
    """The port's Annex B packets of the MP4 and of the MKV (SPS and PPS
    from the avcC first) are the writer's stream byte for byte, and as a
    raw .h264 decode in OpenCV to the model's frames."""
    from tecogan_tpu_torch.data.video_native import NativeVideoReader

    s = streams[name]
    for container in CONTAINERS:
        r = NativeVideoReader(s.write(tmp_path / f"{name}.{container}"))
        annexb = b"".join(r.annexb_packet(i, i == 0) for i in range(r.packet_count))
        r.close()
        assert annexb == s.annexb()
        raw = tmp_path / f"{name}_{container}.h264"
        raw.write_bytes(annexb)
        np.testing.assert_array_equal(_jax_read(raw)[0], s.expected_rgb())


@pytest.mark.parametrize("container", CONTAINERS)
def test_demuxer_h264_track(tmp_path, streams, container):
    """The B-frame stream's track: codec, size, rate, the avcC as extradata,
    key flags (stss, SimpleBlock), presentation times (ctts, block
    timecodes) ranking the packets in display order, and the SPS's colour
    for every stream."""
    from tecogan_tpu_torch.data.video_native import NativeVideoReader
    from tecogan_tpu_torch.data.video_nvdec import stream_colour

    s = streams["b_main"]
    r = NativeVideoReader(s.write(tmp_path / f"b.{container}"))
    assert (r.codec, r.container, r.width, r.height, r.fps) == ("h264", container, s.w, s.h,
                                                                FPS)
    assert r.extradata == s.avcc()
    assert [r.packet_info(i)[2] for i in range(r.packet_count)] == s.keys
    assert np.argsort(np.argsort(r.packet_pts(), kind="stable")).tolist() == s.display
    r.close()
    for name, st in streams.items():
        r = NativeVideoReader(st.write(tmp_path / f"{name}.{container}"))
        assert stream_colour("h264", r.annexb_packet(0, True)) == st.colour()
        r.close()


def test_vp9_fixture_frames_match_their_sha256(tmp_path):
    """The JAX package's read of the fixture gives the recorded frames
    (OpenCV's libvpx/FFmpeg decode; hidden alt-ref frames are not counted),
    the port's demuxer reads it as VP9 in WebM with a key first packet, and
    the same packets in MP4 (vp09 + vpcC) decode in OpenCV to the same."""
    from tecogan_tpu_torch.data.video_native import NativeVideoReader
    from tecogan_tpu_torch.data.video_nvdec import stream_colour

    want = vp9_expected()
    frames, fps = _jax_read(VP9_FIXTURE)
    assert (fps, list(frames.shape)) == (want["fps"], want["shape"])
    assert frame_sha256(frames) == want["frames"]
    r = NativeVideoReader(str(VP9_FIXTURE))
    assert (r.codec, r.container, r.width, r.height, r.fps) == ("vp9", "mkv", 180, 144, fps)
    assert r.packet_count == len(frames) and r.packet_info(0)[2]
    assert stream_colour("vp9", r.packet(0)) == (2, False)
    r.close()
    mp4 = vp9_mp4(tmp_path / "vp9.mp4")
    r = NativeVideoReader(mp4)
    assert (r.codec, r.packet_count) == ("vp9", len(frames)) and r.extradata[4] == 0
    r.close()
    assert frame_sha256(_jax_read(mp4)[0]) == want["frames"]
    assert VP9_FIXTURE.stat().st_size <= 200_000


# picture_to_rgb over tightly packed planes, for the test below; built with
# csrc/tecovideo_dsp.cpp into a library of the test's own.
_HOST_RGB = r"""
#include <cstring>
#include "tecovideo.h"
extern "C" void host_yuv420_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                   int w, int h, int full_range, uint8_t* rgb) {
    tv::Picture pic;
    pic.alloc(w, h, 1, 1, 2, 2);
    pic.full_range = full_range != 0;
    const int cw = (w + 1) / 2, ch = (h + 1) / 2;
    for (int r = 0; r < h; r++)
        std::memcpy(&pic.plane[0][size_t(r) * pic.stride[0]], y + size_t(r) * w, size_t(w));
    for (int r = 0; r < ch; r++) {
        std::memcpy(&pic.plane[1][size_t(r) * pic.stride[1]], u + size_t(r) * cw, size_t(cw));
        std::memcpy(&pic.plane[2][size_t(r) * pic.stride[2]], v + size_t(r) * cw, size_t(cw));
    }
    tv::picture_to_rgb(pic, rgb);
}
"""


@pytest.fixture(scope="module")
def host_yuv420_to_rgb(tmp_path_factory):
    """(y, u, v, full_range) -> (h, w, 3) uint8 through the port's host
    conversion, ``csrc/tecovideo_dsp.cpp:picture_to_rgb``."""
    from tecogan_tpu_torch.data import video_native

    csrc = Path(video_native.__file__).resolve().parents[1] / "csrc"
    out = tmp_path_factory.mktemp("host_rgb")
    (out / "host_rgb.cpp").write_text(_HOST_RGB)
    lib_path = out / "libhost_rgb.so"
    subprocess.run([video_native._compiler(), "-O1", "-fPIC", "-std=c++17", "-shared",
                    "-I", str(csrc), str(out / "host_rgb.cpp"), str(csrc / "tecovideo_dsp.cpp"),
                    "-o", str(lib_path)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).host_yuv420_to_rgb
    fn.restype = None

    def convert(y, u, v, full_range):
        planes = [np.ascontiguousarray(p) for p in (y, u, v)]
        h, w = planes[0].shape
        rgb = np.empty((h, w, 3), np.uint8)
        fn(*(ctypes.c_void_p(p.ctypes.data) for p in planes), w, h, int(full_range),
           ctypes.c_void_p(rgb.ctypes.data))
        return rgb

    return convert


@pytest.mark.parametrize("crop", ["even", "odd"])
@pytest.mark.parametrize("full_range", [False, True], ids=["limited", "full"])
def test_plain_nv12_equals_host_conversion(host_yuv420_to_rgb, full_range, crop):
    """The kernel's plain version on a pitched NV12 surface equals the
    port's host ``picture_to_rgb`` (BT.601) on the same planes, cut to the
    display area; odd offsets take chroma in surface coordinates."""
    import torch

    from tecogan_tpu_torch.kernels.nv12 import nv12_to_rgb_plain, yuv_coefficients

    rng = np.random.default_rng(7 + full_range)
    hh, ww, pitch = (50, 70, 96) if crop == "even" else (51, 71, 80)
    left, top, w, h = (2, 4, 64, 44) if crop == "even" else (3, 5, 67, 45)
    surface = rng.integers(0, 256, (hh + (hh + 1) // 2, pitch), dtype=np.uint8)
    cw = (ww + 1) // 2
    u, v = surface[hh:, 0:2 * cw:2], surface[hh:, 1:2 * cw:2]
    host = host_yuv420_to_rgb(surface[:hh, :ww], u, v, full_range)[top:top + h, left:left + w]
    got = nv12_to_rgb_plain(torch.from_numpy(surface), hh, left, top, w, h,
                            yuv_coefficients(2, full_range))
    np.testing.assert_array_equal(got.numpy(), host)
    # swscale's BT.601 derivation is tecovideo_dsp.cpp's kLimited / kFull.
    assert yuv_coefficients(5, full_range) == yuv_coefficients(2, full_range) == (
        (8192, 0, 11485, 14516, -2819, -5850) if full_range
        else (9539, 128, 13075, 16525, -3209, -6660))


def test_nv12_operator_on_the_cpu_runs_the_plain_version():
    """``nv12_to_rgb`` on a CPU tensor is the plain version, launches
    nothing, and checks the display area against the surface."""
    import torch

    from tecogan_tpu_torch.kernels import nv12_to_rgb, nv12_to_rgb_plain, yuv_coefficients

    surface = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (24, 32),
                                                                 dtype=np.uint8))
    before = nv12_to_rgb.launches
    coeffs = yuv_coefficients(1, True)
    assert torch.equal(nv12_to_rgb(surface, 16, 1, 1, 30, 15, coeffs),
                       nv12_to_rgb_plain(surface, 16, 1, 1, 30, 15, coeffs))
    assert nv12_to_rgb.launches == before
    with pytest.raises(ValueError, match="does not fit"):
        nv12_to_rgb(surface, 16, 0, 0, 32, 17)
    with pytest.raises(TypeError):
        nv12_to_rgb(surface.float(), 16, 0, 0, 32, 16)


def _entry_points(path, tmp_path, device):
    from tecogan_tpu_torch.data import prepare, synthetic
    from tecogan_tpu_torch.data.video_io import VideoCapture, VideoReader, read_video_frames

    return {
        "read_video_frames": lambda: read_video_frames(path, device=device),
        "VideoReader": lambda: VideoReader(path, device=device),
        "VideoCapture": lambda: VideoCapture(path, device=device),
        "create_capture": lambda: synthetic.create_capture(path, device=device),
        "extract_scene": lambda: prepare.extract_scene(path, 0, str(tmp_path / "x"),
                                                       device=device),
    }


@pytest.mark.parametrize("codec", ["h264", "vp9"])
def test_h264_and_vp9_on_the_cpu_raise(tmp_path, streams, codec):
    """With device "cpu" every entry point refuses H.264 and VP9 with
    NotImplementedError (NVDEC only: no software decoder, no fallback to a
    procedural scene); so does the default device where there is no card."""
    import torch

    from tecogan_tpu_torch.cli.main import main
    from tecogan_tpu_torch.serve import FrameSource

    path = (streams["crop"].write(tmp_path / "c.mp4") if codec == "h264"
            else str(VP9_FIXTURE))
    for call in _entry_points(path, tmp_path, "cpu").values():
        with pytest.raises(NotImplementedError, match="NVDEC only"):
            call()
    src = FrameSource(path, warmup=False, device="cpu")
    with pytest.raises(NotImplementedError, match="NVDEC only"):
        src.geometry(timeout=30)
    with pytest.raises(NotImplementedError, match="NVDEC only"):
        main(["--mode", "inference", "--device", "cpu", "--input_video", path,
              "--output_dir", str(tmp_path / "o"), "--allow_random_weights",
              "--num_resblock", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(NotImplementedError, match="no CUDA device"):
            _entry_points(path, tmp_path, None)["read_video_frames"]()
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("codec", ["hevc", "av1"])
def test_hevc_and_av1_name_item_12c(tmp_path, streams, codec):
    """HEVC and AV1 tracks (MP4 hvc1 / av01, MKV V_MPEGH/ISO/HEVC / V_AV1)
    raise NotImplementedError naming item 12c, on any device."""
    s = streams["i_pcm"]
    entry, mkv_id = (b"hvc1", b"V_MPEGH/ISO/HEVC") if codec == "hevc" else (b"av01", b"V_AV1")
    paths = [tmp_path / "a.mp4", tmp_path / "a.mkv"]
    paths[0].write_bytes(mp4_file(s._samples(), s.keys, s.display, s.w, s.h, entry, b""))
    paths[1].write_bytes(mkv_file(s._samples(), s.keys, s.display, s.w, s.h, mkv_id, b""))
    for path in paths:
        for device in (None, "cpu"):
            for call in _entry_points(str(path), tmp_path, device).values():
                with pytest.raises(NotImplementedError, match="item 12c"):
                    call()


@pytest.mark.parametrize("profile", [110, 122, 244], ids=["high10", "high422", "high444"])
def test_refused_h264_profiles(tmp_path, streams, profile):
    """An H.264 High 10, 4:2:2 or 4:4:4 stream raises NotImplementedError
    naming its profile before anything touches the card."""
    from tecogan_tpu_torch.data.video_nvdec import NvdecVideoReader

    s = H264Stream("i_pcm")
    s.sps = s.sps[:1] + bytes([profile]) + s.sps[2:]
    s.packets[0][0] = s.sps
    path = s.write(tmp_path / "p.mkv")
    name = {110: "High 10", 122: "High 4:2:2", 244: "High 4:4:4"}[profile]
    with pytest.raises(NotImplementedError, match=name):
        NvdecVideoReader(path, device="cuda:0")


def test_refused_vp9_profile(tmp_path):
    """A VP9 profile 1 stream raises NotImplementedError naming it."""
    from tecogan_tpu_torch.data.video_nvdec import NvdecVideoReader

    data = VP9_FIXTURE.read_bytes()
    key = bytes([0x82, 0x49, 0x83, 0x42])  # profile 0 key frame, its sync code
    path = tmp_path / "p1.webm"
    path.write_bytes(data.replace(key, bytes([0xA2]) + key[1:], 1))
    with pytest.raises(NotImplementedError, match="VP9 profile 1"):
        NvdecVideoReader(str(path), device="cuda:0")


def test_nvdec_binding_builds_and_names_a_missing_driver_library():
    """The binding builds from ``csrc/tecovideo_nvdec.cpp`` with the host
    compiler; where the NVIDIA driver's libcuda or libnvcuvid does not load
    (a machine without the NVIDIA driver), loading raises OSError naming it."""
    import ctypes

    from tecogan_tpu_torch.data import video_nvdec

    def loads(name):
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            return False

    missing = next((n for n in ("libcuda.so.1", "libnvcuvid.so.1") if not loads(n)), None)
    if missing is None:
        video_nvdec.load_library()
    else:
        with pytest.raises(OSError, match=missing.replace(".", r"\.")):
            video_nvdec.load_library()
    assert video_nvdec.library_path().exists()


@pytest.fixture
def stand_in(monkeypatch, streams):
    """The reader on the CPU with :class:`ModelNvdec` in NVDEC's place:
    surfaces on the CPU, found by their pointer; the NV12 operator's plain
    version converts them."""
    import contextlib

    import torch

    from tecogan_tpu_torch.data import video_io, video_nvdec

    model = ModelNvdec(list(streams.values()), device="cpu")

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(video_nvdec, "load_library", lambda: model)
    monkeypatch.setattr(video_nvdec, "_card", lambda device: torch.device("cpu"))
    monkeypatch.setattr(video_nvdec, "_Surface", lambda ptr, rows, pitch: model.surfaces[ptr])
    monkeypatch.setattr(video_io, "_nvdec_device", lambda device: "")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    return model


@pytest.mark.parametrize("container", CONTAINERS)
def test_reader_display_order_and_seek(tmp_path, streams, stand_in, container):
    """The port's reader over a decoder that queues pictures in display
    order: every stream's frames, block by block; ``seek`` on the B-frame
    stream lands on the exact frame in display order from every start
    (inside a GOP, on a key frame, past the end); ``extract_scene`` and
    ``VideoCapture`` through it. OpenCV's seek (the JAX package's
    ``extract_scene``) lands there on an MP4, and on frame 0 of a Matroska
    file without Cues, a deviation the port does not share."""
    from tecogan_tpu.data import prepare as jax_prepare
    from tecogan_tpu_torch.data.png import read_png
    from tecogan_tpu_torch.data.prepare import extract_scene
    from tecogan_tpu_torch.data.synthetic import create_capture
    from tecogan_tpu_torch.data.video_io import VideoReader, read_video_frames
    from tecogan_tpu_torch.ops.resize import resize_area

    for name, st in streams.items():
        path = st.write(tmp_path / f"{name}.{container}")
        with VideoReader(path, block=3) as reader:
            got = np.stack(list(reader))
        np.testing.assert_array_equal(got, st.expected_rgb())
        assert read_video_frames(path, max_frames=2)[0].shape[0] == 2
    want = streams["b_main"].expected_rgb()
    path = str(tmp_path / f"b_main.{container}")
    for start in (0, 2, 5, 7, 9, 10, 13, 17, 18, 40):
        with VideoReader(path, block=4) as reader:
            reader.seek(start)
            rest = list(reader)
        assert len(rest) == max(0, len(want) - start)
        if rest:
            np.testing.assert_array_equal(np.stack(rest), want[start:])
    n = extract_scene(path, 5, str(tmp_path / "port"), duration=10)
    assert n == 10
    for i in range(n):
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / f"col_high_{i:04d}.png")),
                                      resize_area(want[5 + i], 0.5))
    cap = create_capture(path)
    ok, bgr = cap.read()
    assert ok and np.array_equal(bgr[:, :, ::-1], want[0])
    cap.release()
    # OpenCV's CAP_PROP_POS_FRAMES on the same file.
    assert jax_prepare.extract_scene(path, 5, str(tmp_path / "jax"), duration=1) == 1
    import cv2

    jax_first = cv2.imread(str(tmp_path / "jax" / "col_high_0000.png"))[:, :, ::-1]
    cv2_frame = 5 if container == "mp4" else 0
    np.testing.assert_array_equal(jax_first, resize_area(want[cv2_frame], 0.5))


@pytest.mark.parametrize("capabilities, kind, refused", [
    ("compute,utility", 5, True), ("compute,video,utility", 5, False), ("all", 5, False),
    (None, 5, False), ("compute,utility", 4, False)],
    ids=["withheld", "granted", "all", "unset", "other-error"])
def test_nvdec_unavailable_only_for_the_diagnosed_refusal(monkeypatch, capabilities, kind,
                                                          refused):
    """The binding's refusal of cuvidGetDecoderCaps (kind 5) is
    ``NvdecUnavailable`` only in a container whose
    ``NVIDIA_DRIVER_CAPABILITIES`` withholds ``video``; with the capability
    granted, unset, or any other NVDEC failure it is a plain RuntimeError."""
    from tecogan_tpu_torch.data import video_nvdec

    class Lib:
        def tvn_last_error(self):
            return b"cuvidGetDecoderCaps failed: CUresult 2"

        def tvn_last_error_kind(self):
            return kind

    if capabilities is None:
        monkeypatch.delenv("NVIDIA_DRIVER_CAPABILITIES", raising=False)
    else:
        monkeypatch.setenv("NVIDIA_DRIVER_CAPABILITIES", capabilities)
    with pytest.raises(RuntimeError, match="CUresult 2") as info:
        video_nvdec._raise(Lib(), "clip.mp4")
    assert isinstance(info.value, video_nvdec.NvdecUnavailable) == refused
    assert ("'video' capability" in str(info.value)) == refused


@pytest.mark.parametrize("status", [8, 9], ids=["error", "concealed"])
def test_reader_raises_on_a_decode_error(tmp_path, streams, stand_in, status):
    """A picture NVDEC reports as decoded with an error, or with an error
    concealed, raises instead of being converted."""
    from tecogan_tpu_torch.data.video_io import read_video_frames

    stand_in.status = status
    with pytest.raises(ValueError, match=f"decode error \\(status {status}\\) in frame 0"):
        read_video_frames(streams["p_mv"].write(tmp_path / "p.mp4"))
