"""H.264 and VP9 video decoded on the card's NVDEC.

:class:`NvdecVideoReader` has :class:`~tecogan_tpu_torch.data.video_native.
NativeVideoReader`'s interface (``codec``, ``container``, ``width``,
``height``, ``fps``, ``decode(n)``, ``seek(frame)``, ``close()``) and gives
the frames ``cv2.VideoCapture`` gives, as host (k, h, w, 3) uint8 RGB:

- the port's demuxer (``csrc/tecovideo.cpp``) reads the packets in decode
  order, H.264 rewritten to Annex B (``annexb_packet``: the avcC's SPS and
  PPS before the first packet and after every seek), each tagged with its
  display index (the rank of its presentation time) as its timestamp: the
  SDK's parser hands the timestamps out in increasing order with the
  pictures in display order (fed decode indices on a B-frame stream, it
  returned them sorted), so a display index is what comes back;
- the NVDEC binding (``csrc/tecovideo_nvdec.cpp``, built on first use with
  the host C++ compiler into ``_build/tecovideo_nvdec-<hash>/``) parses and
  decodes them on the card and queues the pictures in display order;
- each picture is mapped as an NV12 surface and converted to RGB on the
  card by the hand-written kernel ``kernels/nv12.py:nv12_to_rgb``
  (``csrc/nv12_rgb.cu``: swscale's arithmetic, with the coefficients cv2
  takes from the stream's matrix coefficients and range, which
  :func:`stream_colour` reads from the H.264 SPS's VUI or the VP9 key
  frame's colour config), then brought to the host.

H.264 and VP9 decode exactly by their standards, so NVDEC's 8-bit 4:2:0
pictures equal FFmpeg's, and the conversion is the one the port fitted to
cv2's frames. Refused, with NotImplementedError naming the feature: H.264
profiles other than Baseline, Main and High (High 10, High 4:2:2, High
4:4:4, ...), VP9 profiles 1-3, monochrome, more than 8 bits, interlaced
(field or MBAFF) coding and a change of size within a stream. There is no
software fallback: a missing ``libnvcuvid`` raises OSError naming it, an
NVDEC error raises (:class:`NvdecUnavailable` where NVDEC creates no
decoder), and a CPU device is refused by ``data/video_io.py``.

Unverified: no card at hand decodes with NVDEC. The one H100 this port is
checked on sits in a container that withholds the NVIDIA driver's
``video`` capability, where ``cuvidGetDecoderCaps`` fails with
CUDA_ERROR_OUT_OF_MEMORY for every codec. There the binding builds, loads,
parses each test stream's sequence header to the expected format and then
raises :class:`NvdecUnavailable`; the decoder half (``cuvidCreateDecoder``,
``cuvidDecodePicture``, ``cuvidMapVideoFrame64`` and the structs declared
for them) has never run. The reader, the NV12 kernel and the CLIs are
checked there over the test streams' model (``tests/nvdec_streams.py``) in
NVDEC's place (ROADMAP item 12b).

:meth:`NvdecVideoReader.seek` decodes from the nearest earlier key packet
and drops the frames before the target in display order, so a stream with
B-frames lands on the exact frame.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tecogan_tpu_torch.data import video_native
from tecogan_tpu_torch.kernels.nv12 import UNSPECIFIED, yuv_coefficients

#: NVDEC's codec ids (cudaVideoCodec) of the codecs routed here.
CODEC_IDS = {"h264": 4, "vp9": 10}
_SOURCES = ("tecovideo_nvdec.cpp",)
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17")
_LDFLAGS = ("-shared",)
_LIBS = ("-ldl",)
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
#: cuvidGetDecodeStatus: an error, an error concealed.
_DECODE_ERRORS = (8, 9)
#: The binding's error kind for NVDEC refusing cuvidGetDecoderCaps.
_REFUSED = 5
#: H.264 profiles NVDEC decodes to 8-bit 4:2:0 (profile_idc: name).
H264_PROFILES = {66: "Baseline", 77: "Main", 100: "High"}
_H264_REFUSED = {88: "Extended", 110: "High 10", 122: "High 4:2:2",
                 244: "High 4:4:4 Predictive", 44: "CAVLC 4:4:4 Intra", 118: "Multiview High",
                 128: "Stereo High", 83: "Scalable Baseline", 86: "Scalable High"}


def library_path(compiler: Optional[str] = None) -> Path:
    """Where the binding built by ``compiler`` (default ``$CXX`` or g++) goes."""
    return video_native.shared_library_path("tecovideo_nvdec", _SOURCES, _CXXFLAGS,
                                            _LDFLAGS + _LIBS,
                                            compiler or video_native._compiler())


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64, c_void = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    i_p = ctypes.POINTER(ctypes.c_int)
    signatures = {
        "tvn_last_error": (ctypes.c_char_p, []),
        "tvn_last_error_kind": (c_int, []),
        "tvn_load": (c_int, []),
        "tvn_driver_version": (c_int, []),
        "tvn_caps": (c_int, [c_int, c_int, i_p]),
        "tvn_open": (c_void, [c_int, c_int]),
        "tvn_close": (None, [c_void]),
        "tvn_feed": (c_int, [c_void, ctypes.c_char_p, c_int, c_i64, c_int]),
        "tvn_format": (c_int, [c_void, i_p]),
        "tvn_map": (c_int, [c_void, c_void, ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int64), i_p]),
        "tvn_unmap": (c_int, [c_void, c_void]),
        "tvn_reset": (c_int, [c_void]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """The binding for ``$CXX`` (else g++), built on first use; OSError
    (naming the library) where the NVIDIA driver's libcuda or libnvcuvid is
    missing."""
    compiler = video_native._compiler()
    with _LOCK:
        lib = _LOADED.get(compiler)
        if lib is None:
            path = video_native.build_shared(library_path(compiler), _SOURCES, _CXXFLAGS,
                                             _LDFLAGS, compiler, libs=_LIBS)
            lib = _LOADED[compiler] = _declare(ctypes.CDLL(str(path)))
    if lib.tvn_load() < 0:
        _raise(lib, "NVDEC")
    return lib


class NvdecUnavailable(RuntimeError):
    """NVDEC creates no decoder: ``cuvidGetDecoderCaps`` fails with
    CUDA_ERROR_OUT_OF_MEMORY in a container whose
    ``NVIDIA_DRIVER_CAPABILITIES`` withholds NVIDIA's ``video``
    capability. Raised for that case alone; any other NVDEC failure is a
    RuntimeError."""


def _video_capability_withheld() -> Optional[str]:
    """``NVIDIA_DRIVER_CAPABILITIES`` where it is set and grants neither
    ``video`` nor ``all`` (a container without NVDEC), else None."""
    caps = os.environ.get("NVIDIA_DRIVER_CAPABILITIES")
    if caps is None or {"video", "all"} & {c.strip() for c in caps.split(",")}:
        return None
    return caps


def _raise(lib: ctypes.CDLL, what: str):
    msg = f"{what}: {lib.tvn_last_error().decode(errors='replace')}"
    kind = lib.tvn_last_error_kind()
    withheld = _video_capability_withheld()
    if kind == _REFUSED and withheld is not None:
        raise NvdecUnavailable(f"{msg}; the container's NVIDIA_DRIVER_CAPABILITIES={withheld} "
                               "does not grant the NVIDIA driver's 'video' capability")
    if kind == 1:
        raise ValueError(msg)
    if kind == 2:
        raise NotImplementedError(msg)
    if kind == 3:
        raise OSError(msg)
    raise RuntimeError(msg)


def decoder_caps(codec: str, device: Optional[torch.device] = None) -> dict:
    """NVDEC's capabilities for ``codec`` ("h264", "vp9") at 8-bit 4:2:0 on
    ``device`` (default: the current card), from ``cuvidGetDecoderCaps``."""
    index = _card(device).index
    lib = load_library()
    out = (ctypes.c_int * 7)()
    if lib.tvn_caps(CODEC_IDS[codec], index, out) < 0:
        _raise(lib, f"cuvidGetDecoderCaps({codec})")
    keys = ("supported", "nvdecs", "min_width", "min_height", "max_width", "max_height",
            "max_macroblocks")
    return dict(zip(keys, list(out)))


def _card(device) -> torch.device:
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise NotImplementedError(f"NVDEC decodes on a CUDA device, not {device}")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def _first_sps(annexb: bytes) -> Optional[bytes]:
    """The first SPS NAL unit (type 7) of an Annex B packet, without its
    emulation prevention bytes."""
    for unit in annexb.split(b"\x00\x00\x01")[1:]:
        if unit and unit[0] & 0x1F == 7:
            return unit.replace(b"\x00\x00\x03", b"\x00\x00")
    return None


class _Bits:
    """MSB-first reader of exp-Golomb syntax."""

    def __init__(self, data: bytes):
        self.v, self.n, self.p = int.from_bytes(data, "big"), 8 * len(data), 0

    def u(self, k: int) -> int:
        self.p += k
        if self.p > self.n:
            raise ValueError("the header ends early")
        return (self.v >> (self.n - self.p)) & ((1 << k) - 1)

    def ue(self) -> int:
        zeros = 0
        while not self.u(1):
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


# profile_idc values whose SPS carries chroma_format_idc and bit depths.
_HIGH_SPS = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)
# VP9 color_space -> matrix coefficients, as FFmpeg's VP9 decoder maps it.
_VP9_MATRIX = (UNSPECIFIED, 5, 1, 6, 7, 9, 3, 0)


def stream_colour(codec: str, first_packet: bytes):
    """(matrix coefficients, full range) of a stream, as FFmpeg reads them
    and cv2 applies them: the H.264 SPS's VUI (absent: unspecified, limited)
    in an Annex B packet, or a VP9 key frame's colour config."""
    if codec == "vp9":
        b = _Bits(first_packet[:16])
        if b.u(2) != 2:
            raise ValueError("VP9: no frame marker in the first packet")
        profile = b.u(1) | (b.u(1) << 1)
        if profile == 3:
            b.u(1)
        if b.u(1) or b.u(1):  # show_existing_frame, frame_type (1: not a key frame)
            raise ValueError("VP9: the first packet is not a key frame")
        b.u(2)  # show_frame, error_resilient_mode
        if b.u(24) != 0x498342:
            raise ValueError("VP9: no key frame sync code")
        if profile >= 2:
            b.u(1)  # ten_or_twelve_bit
        space = b.u(3)
        return _VP9_MATRIX[space], space == 7 or bool(b.u(1))
    sps = _first_sps(first_packet)
    if sps is None:
        raise ValueError("H.264: no SPS before the first picture")
    b = _Bits(sps[1:])
    profile = b.u(8)
    b.u(16)  # constraint flags, level_idc
    b.ue()  # seq_parameter_set_id
    if profile in _HIGH_SPS:
        if b.ue() == 3:  # chroma_format_idc
            b.u(1)
        b.ue(), b.ue(), b.u(1)  # bit depths, qpprime_y_zero_transform_bypass_flag
        if b.u(1):  # seq_scaling_matrix_present_flag
            for i in range(8 if profile != 244 else 12):
                if b.u(1):
                    last = nxt = 8
                    for _ in range(16 if i < 6 else 64):
                        if nxt:
                            nxt = (last + b.se() + 256) % 256
                        last = nxt or last
    b.ue()  # log2_max_frame_num_minus4
    poc_type = b.ue()
    if poc_type == 0:
        b.ue()
    elif poc_type == 1:
        b.u(1), b.se(), b.se()
        for _ in range(b.ue()):
            b.se()
    b.ue(), b.u(1), b.ue(), b.ue()  # refs, gaps, width, height
    if not b.u(1):  # frame_mbs_only_flag
        b.u(1)
    b.u(1)  # direct_8x8_inference_flag
    if b.u(1):  # frame_cropping_flag
        b.ue(), b.ue(), b.ue(), b.ue()
    if not b.u(1):  # vui_parameters_present_flag
        return UNSPECIFIED, False
    if b.u(1) and b.u(8) == 255:  # aspect_ratio_idc: Extended_SAR
        b.u(32)
    if b.u(1):  # overscan_info_present_flag
        b.u(1)
    if not b.u(1):  # video_signal_type_present_flag
        return UNSPECIFIED, False
    b.u(3)  # video_format
    full = bool(b.u(1))
    if not b.u(1):  # colour_description_present_flag
        return UNSPECIFIED, full
    b.u(16)  # colour_primaries, transfer_characteristics
    return b.u(8), full


class _Surface:
    """A mapped NV12 picture as ``__cuda_array_interface__`` for torch."""

    def __init__(self, ptr: int, rows: int, pitch: int):
        self.__cuda_array_interface__ = {"shape": (rows, pitch), "typestr": "|u1",
                                         "data": (ptr, False), "strides": None, "version": 2}


class NvdecVideoReader:
    """One H.264 or VP9 track of ``path`` decoded on ``device`` (default: the
    current card); ``decode(n)`` returns host uint8 RGB frames."""

    def __init__(self, path: str, device=None,
                 demuxed: Optional[video_native.NativeVideoReader] = None):
        self.path, self._h = path, None  # __del__ runs even if the build fails
        self._demux = demuxed or video_native.NativeVideoReader(path)
        try:
            self.codec, self.container = self._demux.codec, self._demux.container
            if self.codec not in CODEC_IDS:
                raise NotImplementedError(f"{path}: {self.codec} is not decoded on NVDEC here")
            self.width, self.height, self.fps = (self._demux.width, self._demux.height,
                                                 self._demux.fps)
            self.packet_count = self._demux.packet_count
            if self.packet_count == 0:
                raise ValueError(f"{path}: the video track has no packets")
            self.device = _card(device)
            self._check_profile()
            self._lib = load_library()
            self._h = self._lib.tvn_open(CODEC_IDS[self.codec], self.device.index)
            if not self._h:
                _raise(self._lib, path)
        except BaseException:
            self.close()
            raise
        pts = self._demux.packet_pts()
        order = np.argsort(pts, kind="stable")
        self._rank = np.empty(self.packet_count, np.int64)  # display index by packet
        self._rank[order] = np.arange(self.packet_count)
        self._keys = [i for i in range(self.packet_count) if self._demux.packet_info(i)[2]]
        self._format: Optional[dict] = None
        self._next = 0           # next packet to parse
        self._headers = True     # SPS and PPS before the next packet (H.264)
        self._eos = False
        self._emit_from = 0      # display index of the next frame to return

    def _check_profile(self) -> None:
        """Refuses what NVDEC or the kernel does not take, and reads the
        stream's colour (``matrix``, ``full_range``, ``coeffs``)."""
        if self.codec == "h264":
            first = self._demux.annexb_packet(0, True)
            sps = _first_sps(first)
            profile = sps[1] if sps and len(sps) > 1 else None
            if profile is not None and profile not in H264_PROFILES:
                name = _H264_REFUSED.get(profile, f"profile_idc {profile}")
                raise NotImplementedError(
                    f"{self.path}: H.264 {name} profile (profile_idc {profile}) is not decoded "
                    "(NVDEC and the NV12 kernel take Baseline, Main and High: 8-bit 4:2:0)")
        else:
            first = self._demux.packet(0)
            if first and first[0] >> 6 == 2:  # frame_marker
                profile = ((first[0] >> 5) & 1) | (((first[0] >> 4) & 1) << 1)
                if profile:
                    raise NotImplementedError(
                        f"{self.path}: VP9 profile {profile} is not decoded (NVDEC and the "
                        "NV12 kernel take profile 0: 8-bit 4:2:0)")
        self.matrix, self.full_range = stream_colour(self.codec, first)
        self.coeffs = yuv_coefficients(self.matrix, self.full_range)

    def _feed(self) -> None:
        """Parses the next packet, or ends the stream after the last."""
        if self._next < self.packet_count:
            i = self._next
            data = (self._demux.annexb_packet(i, self._headers) if self.codec == "h264"
                    else self._demux.packet(i))
            flags = 2 if self._headers and i else 0  # a discontinuity after a seek
            self._headers = False
            self._next += 1
        else:
            data, i, flags = b"", 0, 1
            self._eos = True
        tag = int(self._rank[i]) if flags != 1 else 0
        if self._lib.tvn_feed(self._h, data, len(data), tag, flags) < 0:
            _raise(self._lib, self.path)

    def stream_format(self) -> Optional[dict]:
        """The format NVDEC's parser read from the sequence header, once one
        was parsed (also where the decoder was then refused), else None:
        ``coded`` (width, height), ``display`` (left, top, right, bottom),
        ``full_range`` and ``matrix``."""
        fmt = (ctypes.c_int * 8)()
        if not self._h or not self._lib.tvn_format(self._h, fmt):
            return None
        return {"coded": tuple(fmt[:2]), "display": tuple(fmt[2:6]),
                "full_range": bool(fmt[6]), "matrix": fmt[7]}

    def _layout(self) -> dict:
        if self._format is None:
            fmt = self.stream_format()
            if fmt is None:
                raise ValueError(f"{self.path}: a picture before the sequence header")
            self._format = fmt
            left, top, right, bottom = fmt["display"]
            w, h = right - left, bottom - top
            if self.width and self.height and (w, h) != (self.width, self.height):
                raise ValueError(f"{self.path}: frame size {w}x{h} differs from the "
                                 f"container's {self.width}x{self.height}")
            self.width, self.height = w, h
        return self._format

    def _convert(self, ptr: int, pitch: int, index: int, status: int):
        """The mapped picture of display index ``index`` as RGB on the card,
        or None for one before the seek target (which may lack its
        references: its decode status is not read)."""
        from tecogan_tpu_torch.kernels import nv12_to_rgb

        if index < self._emit_from:
            return None
        if status in _DECODE_ERRORS:
            raise ValueError(f"{self.path}: NVDEC reports a decode error (status {status}) "
                             f"in frame {index}")
        fmt = self._layout()
        left, top, right, bottom = fmt["display"]
        luma_rows = (fmt["coded"][1] + 1) & ~1
        surface = torch.as_tensor(_Surface(ptr, luma_rows + luma_rows // 2, pitch),
                                  device=self.device)
        return nv12_to_rgb(surface, luma_rows, left, top, right - left, bottom - top,
                           self.coeffs)

    def decode(self, n: int) -> np.ndarray:
        """Up to ``n`` more frames as (k, h, w, 3) uint8 RGB; k = 0 at the end."""
        frames = []
        ptr, pitch, ts, status = (ctypes.c_uint64(), ctypes.c_uint(), ctypes.c_int64(),
                                  ctypes.c_int())
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            while len(frames) < n:
                got = self._lib.tvn_map(self._h, stream, ptr, pitch, ts, status)
                if got < 0:
                    _raise(self._lib, self.path)
                if not got:  # no picture waits: parse on, or stop at the end
                    if self._eos:
                        break
                    self._feed()
                    continue
                try:
                    frame = self._convert(ptr.value, pitch.value, ts.value, status.value)
                finally:  # waits for the kernel that read the picture
                    if self._lib.tvn_unmap(self._h, stream) < 0:
                        _raise(self._lib, self.path)
                if frame is not None:
                    frames.append(frame)
        if not frames:
            return np.empty((0, self.height, self.width, 3), np.uint8)
        return torch.stack(frames).cpu().numpy()

    def seek(self, frame: int) -> None:
        """The next :meth:`decode` starts at display frame ``frame``: decoding
        from the nearest key packet at or before the one that holds it."""
        frame = max(0, int(frame))
        if frame >= self.packet_count:
            k = self.packet_count  # past the end: nothing more to decode
        else:
            holder = int(np.nonzero(self._rank == frame)[0][0])
            earlier = [k for k in self._keys if k <= holder and self._rank[k] <= frame]
            k = earlier[-1] if earlier else 0
        if self._lib.tvn_reset(self._h) < 0:
            _raise(self._lib, self.path)
        self._next, self._headers, self._eos, self._emit_from = k, True, False, frame

    def close(self) -> None:
        if self._h:
            self._lib.tvn_close(self._h)
            self._h = None
        if getattr(self, "_demux", None) is not None:
            self._demux.close()
            self._demux = None

    def __del__(self):
        self.close()
