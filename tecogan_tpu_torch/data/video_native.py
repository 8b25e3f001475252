"""ctypes bindings for the port's video library, ``csrc/tecovideo*.cpp``.

The library is the port's own: demuxers and muxers for RIFF AVI, ISO BMFF
(``.mp4``/``.m4v``) and Matroska, a baseline JPEG codec (Motion JPEG) and
an MPEG-4 Part 2 codec (decoder: what lavc writes for ``mp4v`` and
``XVID``; encoder: Simple Profile I-VOPs), and the YUV -> RGB conversion
that OpenCV's FFmpeg backend applies. It links nothing beyond libc and
libstdc++, so it builds wherever a C++17 compiler is, the GPU machine
included (it has no OpenCV and no FFmpeg).

It is built on first use with the host C++ compiler (``$CXX``, else
``g++``), each source compiled at once in its own process (``-O3 -fPIC
-std=c++17 -pthread -c``) and linked ``-shared -pthread`` into the
git-ignored ``tecogan_tpu_torch/_build/tecovideo-<hash>/libtecovideo.so``,
the hash taken over the compiler, the flags and the sources, under a file
lock and through a temporary file, as ``data/native_loader.py`` builds its
library.
There is no fallback: a failed build raises :class:`VideoBuildError` with
the compiler's output.

Errors from the library map to Python exceptions by kind: corrupt or
truncated data -> ``ValueError``, an unsupported codec or stream feature ->
``NotImplementedError``, the operating system -> ``OSError``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("tecovideo.cpp", "tecovideo_dsp.cpp", "tecovideo_jpeg.cpp", "tecovideo_mpeg4.cpp")
_HEADERS = ("tecovideo.h",)
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread")
_LDFLAGS = ("-shared", "-pthread")
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}  # compiler -> library

#: Writer kinds of the C ABI (``tv_writer_open``).
AVI_MJPEG, MP4_MPEG4, MKV_MPEG4, MKV_MJPEG = 0, 1, 2, 3
#: MPEG-4 encoder options (bits): MPEG quantisation (default matrices), and
#: the intra DC coded among the TCOEF events. The writers use neither; they
#: drive the decoder's other paths in the tests.
MPEG4_MPEG_QUANT, MPEG4_DC_IN_TCOEF = 1, 2


class VideoBuildError(RuntimeError):
    """The library did not build; the message holds the compiler's output."""


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def shared_library_path(stem: str, sources, cxxflags, ldflags, compiler: str) -> Path:
    """``_build/<stem>-<hash>/lib<stem>.so``, the hash taken over the
    compiler, the flags and the sources (and headers) under ``csrc/``."""
    h = hashlib.sha256(" ".join((compiler, *cxxflags, *ldflags)).encode())
    for name in sources:
        h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    return _PKG / "_build" / f"{stem}-{h.hexdigest()[:16]}" / f"lib{stem}.so"


def library_path(compiler: Optional[str] = None) -> Path:
    """Where the library built by ``compiler`` (default ``$CXX`` or g++)
    from the current sources goes."""
    return shared_library_path("tecovideo", _SOURCES + _HEADERS, _CXXFLAGS, _LDFLAGS,
                               compiler or _compiler())


def _run(cmd) -> None:
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise VideoBuildError(f"{' '.join(cmd)}: {exc}") from exc
    if done.returncode:
        raise VideoBuildError(f"{' '.join(cmd)} exited {done.returncode}:\n"
                              f"{done.stdout}{done.stderr}")


def build_library(compiler: Optional[str] = None) -> Path:
    """Compile the sources unless this compiler, these flags and these
    sources were built before; returns the library's path."""
    compiler = compiler or _compiler()
    return build_shared(library_path(compiler), _SOURCES, _CXXFLAGS, _LDFLAGS, compiler)


def build_shared(path: Path, sources, cxxflags, ldflags, compiler: str,
                 libs=()) -> Path:
    """Compile ``sources`` (under ``csrc/``), one process each, and link them
    with ``libs`` into ``path``, unless it exists."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not path.exists():  # another process may have built it meanwhile
            work = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            work.mkdir()
            try:
                objs = [work / f"{Path(src).stem}.o" for src in sources]
                cmds = [[compiler, *cxxflags, "-c", str(_CSRC / src), "-o", str(obj)]
                        for src, obj in zip(sources, objs)]
                with ThreadPoolExecutor(len(cmds)) as pool:  # one process per source
                    list(pool.map(_run, cmds))
                _run([compiler, *ldflags, "-o", str(work / path.name), *map(str, objs),
                      *libs])
                os.replace(work / path.name, path)  # atomic: a reader never sees half a file
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64, c_void, c_char = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    i_p, i64_p, d_p = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_double))
    signatures = {
        "tv_last_error": (c_char, []),
        "tv_last_error_kind": (c_int, []),
        "tv_open": (c_void, [c_char]),
        "tv_close": (None, [c_void]),
        "tv_info": (c_int, [c_void, c_char, c_int, c_char, c_int, i_p, i_p, d_p, i64_p, i_p]),
        "tv_extradata": (c_int, [c_void, c_char, c_int]),
        "tv_packet": (c_int, [c_void, c_i64, i64_p, i_p, i_p]),
        "tv_read_packet": (c_int, [c_void, c_i64, c_char, c_int]),
        "tv_packet_pts": (c_int, [c_void, i64_p, c_i64]),
        "tv_annexb_packet": (c_int, [c_void, c_i64, c_int, c_char, c_int]),
        "tv_decode": (c_int, [c_void, c_int, c_void]),
        "tv_seek": (c_int, [c_void, c_i64]),
        "tv_writer_open": (c_void, [c_char, c_int, c_int, c_int, c_int, c_int, c_int, c_int]),
        "tv_writer_write": (c_int, [c_void, c_void, c_int]),
        "tv_writer_write_packet": (c_int, [c_void, c_char, c_int, c_int]),
        "tv_writer_close": (c_int, [c_void]),
        "tv_writer_abort": (None, [c_void]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """The library for ``$CXX`` (else g++), built on first use."""
    compiler = _compiler()
    with _LOCK:
        lib = _LOADED.get(compiler)
        if lib is None:
            lib = _LOADED[compiler] = _declare(ctypes.CDLL(str(build_library(compiler))))
        return lib


def _raise(lib: ctypes.CDLL, what: str):
    msg = f"{what}: {lib.tv_last_error().decode(errors='replace')}"
    kind = lib.tv_last_error_kind()
    if kind == 2:
        raise NotImplementedError(msg)
    if kind == 3:
        raise OSError(msg)
    raise ValueError(msg)


class NativeVideoReader:
    """One demuxed video track of a file and its decoder.

    ``codec`` is ``"mjpeg"``, ``"mpeg4"`` or the name of a codec this
    library does not decode (``"h264"``, ``"vp9"``, ``"hevc"``, ``"av1"``,
    ...); :meth:`decode` raises ``NotImplementedError`` on those. H.264 and
    VP9 go to the card's NVDEC (``data/video_nvdec.py``), which reads
    the packets through :meth:`packet`, :meth:`annexb_packet` and
    :meth:`packet_pts`. ``fps`` is the container's rate as
    ``cv2.CAP_PROP_FPS`` reports it.
    """

    def __init__(self, path: str):
        self.path, self._h = path, None  # __del__ runs even if the build fails
        self._lib = load_library()
        self._h = self._lib.tv_open(os.fsencode(path))
        if not self._h:
            _raise(self._lib, path)
        codec, container = ctypes.create_string_buffer(64), ctypes.create_string_buffer(16)
        w, h, n, extra = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64(), ctypes.c_int()
        fps = ctypes.c_double()
        self._lib.tv_info(self._h, codec, 64, container, 16, w, h, fps, n, extra)
        self.codec = codec.value.decode(errors="replace")  # a codec id read from the file
        self.container = container.value.decode()
        self.width, self.height, self.fps = w.value, h.value, fps.value
        self.packet_count = n.value
        self._extra_size = extra.value

    @property
    def extradata(self) -> bytes:
        buf = ctypes.create_string_buffer(max(1, self._extra_size))
        n = self._lib.tv_extradata(self._h, buf, self._extra_size)
        return buf.raw[:n]

    def packet_info(self, i: int) -> Tuple[int, int, bool]:
        """(file offset, size, key flag) of packet ``i``."""
        off, size, key = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
        if self._lib.tv_packet(self._h, i, off, size, key) < 0:
            _raise(self._lib, self.path)
        return off.value, size.value, bool(key.value)

    def packet(self, i: int) -> bytes:
        size = self.packet_info(i)[1]
        buf = ctypes.create_string_buffer(max(1, size))
        n = self._lib.tv_read_packet(self._h, i, buf, size)
        if n < 0:
            _raise(self._lib, self.path)
        return buf.raw[:n]

    def packet_pts(self) -> np.ndarray:
        """Every packet's presentation time in decode order, in the track's
        units (MP4: decode time + ``ctts``; MKV: block timecodes; AVI: the
        packet's index)."""
        pts = np.zeros(self.packet_count, np.int64)
        self._lib.tv_packet_pts(self._h, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                self.packet_count)
        return pts

    def annexb_packet(self, i: int, with_headers: bool) -> bytes:
        """H.264 packet ``i`` in Annex B (start codes), after the avcC's SPS
        and PPS when ``with_headers``."""
        cap = 4 * self.packet_info(i)[1] + 2 * self._extra_size + 64
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.tv_annexb_packet(self._h, i, int(with_headers), buf, cap)
        if n < 0:
            _raise(self._lib, self.path)
        return buf.raw[:n]

    def decode(self, n: int) -> np.ndarray:
        """Up to ``n`` more frames as (k, h, w, 3) uint8 RGB; k = 0 at the end."""
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        got = self._lib.tv_decode(self._h, n, out.ctypes.data)
        if got < 0:
            _raise(self._lib, self.path)
        return out[:got]

    def seek(self, frame: int) -> None:
        """The next :meth:`decode` starts at frame ``frame`` (decoding from
        the nearest earlier key packet)."""
        if self._lib.tv_seek(self._h, frame) < 0:
            _raise(self._lib, self.path)

    def close(self) -> None:
        if self._h:
            self._lib.tv_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeVideoWriter:
    """Encodes RGB frames into a container: ``kind`` is one of
    :data:`AVI_MJPEG`, :data:`MP4_MPEG4`, :data:`MKV_MPEG4`,
    :data:`MKV_MJPEG`; the rate is ``fps_num / fps_den``; ``quality`` is
    the JPEG quality (1-100) or the MPEG-4 quantiser (1-31); ``options``
    the MPEG-4 encoder's (:data:`MPEG4_MPEG_QUANT`, :data:`MPEG4_DC_IN_TCOEF`)."""

    def __init__(self, path: str, kind: int, width: int, height: int, fps_num: int,
                 fps_den: int, quality: int, options: int = 0):
        self.path, self._h = path, None  # __del__ runs even if the build fails
        self.width, self.height = width, height
        self._lib = load_library()
        self._h = self._lib.tv_writer_open(os.fsencode(path), kind, width, height, fps_num,
                                           fps_den, quality, options)
        if not self._h:
            _raise(self._lib, path)

    def write(self, frames: np.ndarray) -> None:
        """(n, h, w, 3) uint8 RGB frames."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"{self.path}: frames of shape {frames.shape[1:]}, the file "
                             f"holds ({self.height}, {self.width}, 3)")
        if self._lib.tv_writer_write(self._h, frames.ctypes.data, frames.shape[0]) < 0:
            _raise(self._lib, self.path)

    def write_packet(self, data: bytes, key: bool = True) -> None:
        """Muxes one packet already encoded in the writer's codec."""
        if self._lib.tv_writer_write_packet(self._h, data, len(data), int(key)) < 0:
            _raise(self._lib, self.path)

    def close(self) -> None:
        """Writes the index and the headers' sizes and closes the file."""
        h, self._h = self._h, None
        if h and self._lib.tv_writer_close(h) < 0:
            _raise(self._lib, self.path)

    def abort(self) -> None:
        """Closes the file as it stands (no index)."""
        h, self._h = self._h, None
        if h:
            self._lib.tv_writer_abort(h)

    def __del__(self):
        self.abort()
