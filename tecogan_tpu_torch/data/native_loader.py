"""ctypes bindings for the port's native data-loader core,
``csrc/tecodata.cpp`` (counterpart of ``tecogan_tpu/data/native_loader.py``).

The C++ library plays the role TensorFlow's C++ queue runners play in the
reference input pipeline (reference lib/dataloader.py:163-165,268-270):
GIL-free threaded PNG decode, crop/flip, float conversion and batch
assembly, plus whole-sequence decode and encode for the inference CLI and
the serving sources. Augmentation decisions come from Python as
:class:`~tecogan_tpu_torch.data.loader.SeqPlan`\\ s, so a native batch is
bit-identical to the python executor's for the same seed.

The library is the port's own copy of the JAX package's source, with its
own PNG codec on zlib in place of libpng (the GPU machine has no libpng).
It is built on first use with the host C++ compiler (``$CXX``, else
``g++``): ``-O3 -fPIC -std=c++17 -shared ... -lz -pthread`` into the
git-ignored ``tecogan_tpu_torch/_build/tecodata-<hash>/libtecodata.so``,
the hash taken over the compiler, the flags and the source. The build
writes a temporary file and renames it into place under a file lock, so
processes that build at once never load half a file. Where it cannot be
built or loaded, :data:`UNAVAILABLE_ERRORS` is raised and callers fall
back to the python codec (``data/png.py``) as the JAX package's do.

Counters (class attributes, under one lock) say what the library did since
they were last set to 0: ``NativeFrameIO.decoded`` / ``.encoded`` frames
and ``NativeExecutor.sequences`` loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "tecodata.cpp"
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LDFLAGS = ("-lz", "-pthread")
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}  # compiler -> library


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(compiler: Optional[str] = None) -> Path:
    """Where the library built by ``compiler`` (default: ``$CXX`` or g++)
    from the current source goes."""
    compiler = compiler or _compiler()
    key = " ".join((compiler, *_CXXFLAGS, *_LDFLAGS)).encode() + _SOURCE.read_bytes()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return _PKG / "_build" / f"tecodata-{digest}" / "libtecodata.so"


def build_library(compiler: Optional[str] = None) -> Path:
    """Compile ``csrc/tecodata.cpp`` unless this compiler, these flags and
    this source were built before; returns the library's path. Raises
    ``OSError`` (no compiler) or ``subprocess.CalledProcessError``."""
    compiler = compiler or _compiler()
    path = library_path(compiler)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not path.exists():  # another process may have built it meanwhile
            tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                subprocess.run([compiler, *_CXXFLAGS, "-o", str(tmp), str(_SOURCE), *_LDFLAGS],
                               check=True, capture_output=True)
                os.replace(tmp, path)  # atomic: a reader never sees half a file
            finally:
                tmp.unlink(missing_ok=True)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_int_p = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    paths, i32_p = ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32)
    f32_p, u8_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    handle = ctypes.c_void_p
    signatures = {
        "td_open": (handle, [c_int]),
        "td_open_cached": (handle, [c_int, c_int]),
        "td_close": (None, [handle]),
        "td_png_dims": (c_int, [ctypes.c_char_p, c_int_p, c_int_p]),
        "td_decode": (c_int, [ctypes.c_char_p, f32_p, c_int_p, c_int_p, c_int]),
        "td_load_batch": (c_int, [handle, paths, i32_p, i32_p, i32_p, c_int, c_int, c_int,
                                  f32_p]),
        "td_load_batch_u8": (c_int, [handle, paths, i32_p, i32_p, i32_p, c_int, c_int, c_int,
                                     u8_p]),
        "td_decode_frames": (c_int, [handle, paths, c_int, c_int_p, c_int_p, f32_p,
                                     ctypes.c_int64]),
        "td_decode_frames_u8": (c_int, [handle, paths, c_int, c_int_p, c_int_p, u8_p,
                                        ctypes.c_int64]),
        "td_encode_frames": (c_int, [handle, paths, u8_p, c_int, c_int, c_int]),
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


#: Exceptions that mean "the native library can't be built/loaded here"
#: (fallback-to-python set; anything else is a real bug and must raise).
UNAVAILABLE_ERRORS = (ImportError, OSError, subprocess.CalledProcessError)


def unavailable_detail(exc: BaseException):
    """Human-readable cause for an UNAVAILABLE_ERRORS failure (the
    compiler's stderr for build failures, the exception itself otherwise)."""
    if isinstance(exc, subprocess.CalledProcessError) and exc.stderr:
        return exc.stderr.decode(errors="replace").strip()
    return exc


def native_available() -> bool:
    try:
        load_library()
        return True
    except UNAVAILABLE_ERRORS:
        return False


def png_dims(path: str) -> Tuple[int, int]:
    """Read only the PNG header -> (H, W)."""
    lib = load_library()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.td_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"td_png_dims failed for {path}")
    return h.value, w.value


def decode_png(path: str) -> np.ndarray:
    """Decode one PNG via the native core -> (H, W, 3) float32 [0,1].

    Reads the header first and allocates exactly h*w*3 (a worst-case
    preallocation would spike RSS by hundreds of MB per call)."""
    lib = load_library()
    hdr_h, hdr_w = png_dims(path)
    buf = np.empty((hdr_h, hdr_w, 3), np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.td_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       ctypes.byref(h), ctypes.byref(w), buf.size)
    if rc != 0 or (h.value, w.value) != (hdr_h, hdr_w):
        raise IOError(f"td_decode failed ({rc}) for {path}")
    return buf


def _path_array(paths: Sequence[str]):
    """A C array of the encoded paths, and the bytes it points into (keep
    both alive for the call)."""
    keepalive = [p.encode() for p in paths]
    return (ctypes.c_char_p * len(keepalive))(*keepalive), keepalive


class _Counted:
    _count_lock = threading.Lock()

    @classmethod
    def _count(cls, name: str, n: int) -> None:
        with _Counted._count_lock:
            setattr(cls, name, getattr(cls, name) + n)


class NativeFrameIO(_Counted):
    """Threaded whole-sequence PNG decode/encode for streaming inference and
    serving.

    Plays the role of the reference's per-frame cv2.imread/save_img calls
    (reference main.py:253-269, dataloader.py:30-36) but off the python
    thread: ctypes releases the GIL for the duration of each call, so a
    writer thread encodes chunk k while the device computes chunk k+1.
    """

    decoded = 0  # frames decoded by any instance
    encoded = 0  # frames encoded by any instance

    def __init__(self, num_threads: int = 8):
        self._lib = load_library()
        self._handle = ctypes.c_void_p(self._lib.td_open(max(1, int(num_threads))))

    def _decode(self, paths: Sequence[str], dtype) -> np.ndarray:
        n = len(paths)
        h, w = png_dims(paths[0])
        out = np.empty((n, h, w, 3), dtype)
        arr, _keep = _path_array(paths)
        ch, cw = ctypes.c_int(), ctypes.c_int()
        fn, ptr = ((self._lib.td_decode_frames_u8, ctypes.c_uint8) if dtype == np.uint8
                   else (self._lib.td_decode_frames, ctypes.c_float))
        rc = fn(self._handle, arr, n, ctypes.byref(ch), ctypes.byref(cw),
                out.ctypes.data_as(ctypes.POINTER(ptr)), out.size)
        if rc != 0 or (ch.value, cw.value) != (h, w):
            raise IOError(f"native decode of {n} frame(s) failed ({rc}; a frame of another "
                          f"geometry than {h}x{w} counts as failed), first {paths[0]}")
        self._count("decoded", n)
        return out

    def decode_frames(self, paths: Sequence[str]) -> np.ndarray:
        """-> (len(paths), H, W, 3) float32 [0,1]; frames must share geometry."""
        return self._decode(paths, np.float32)

    def decode_frames_u8(self, paths: Sequence[str]) -> np.ndarray:
        """-> (len(paths), H, W, 3) uint8 — the PNG's own precision, no
        float round-trip (4x less memory traffic than decode_frames; the
        cheap-upload inference path normalizes on device)."""
        return self._decode(paths, np.uint8)

    def encode_frames(self, paths: Sequence[str], frames: np.ndarray) -> None:
        """frames: (n, H, W, 3) uint8 RGB, one PNG per path."""
        frames = np.ascontiguousarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8 \
                or frames.shape[0] != len(paths):
            raise ValueError(f"encode_frames takes (n, H, W, 3) uint8 frames for "
                             f"{len(paths)} paths, got {frames.dtype} {frames.shape}")
        n, h, w, _ = frames.shape
        arr, _keep = _path_array(paths)
        rc = self._lib.td_encode_frames(
            self._handle, arr, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w)
        if rc != 0:
            raise IOError(f"native encode_frames failed for {rc} frame(s)")
        self._count("encoded", n)

    def close(self):
        if self._handle:
            self._lib.td_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeExecutor(_Counted):
    """Executes batches of SeqPlans through the C++ thread pool.

    ``cache_mb``: LRU decoded-frame cache shared by the pool (0 = off) —
    overlapping RNN windows then share decodes across the epoch (the
    reference's loadHR_batch amortization, dataloader.py:53-167, redesigned
    as a byte-budgeted cache). Pixel-identical either way."""

    sequences = 0  # sequences loaded by any instance

    def __init__(self, num_threads: int, rnn_n: int, tar: int, cache_mb: int = 0):
        self._lib = load_library()
        self._handle = ctypes.c_void_p(
            self._lib.td_open_cached(max(1, int(num_threads)), max(0, int(cache_mb))))
        self.rnn_n = rnn_n
        self.tar = tar

    def load(self, plans: Sequence, as_uint8: bool = False) -> np.ndarray:
        """-> (len(plans), rnn_n, tar, tar, 3) float32 [0,1], or raw uint8
        with ``as_uint8`` (cheap-upload path; device-side /255)."""
        n, rnn_n, tar = len(plans), self.rnn_n, self.tar
        flat: List[str] = []
        for plan in plans:
            if not len(plan.paths) == len(plan.oy) == len(plan.ox) == rnn_n:
                raise ValueError(f"a plan of {len(plan.paths)} frames for rnn_n={rnn_n}")
            flat.extend(plan.paths)
        paths, _keep = _path_array(flat)
        oy = np.concatenate([np.asarray(p.oy, np.int32) for p in plans])
        ox = np.concatenate([np.asarray(p.ox, np.int32) for p in plans])
        flip = np.array([int(p.flip) for p in plans], np.int32)
        i32 = ctypes.POINTER(ctypes.c_int32)
        if as_uint8:
            out = np.empty((n, rnn_n, tar, tar, 3), np.uint8)
            fn, ptr = self._lib.td_load_batch_u8, ctypes.c_uint8
        else:
            out = np.empty((n, rnn_n, tar, tar, 3), np.float32)
            fn, ptr = self._lib.td_load_batch, ctypes.c_float
        rc = fn(self._handle, paths, oy.ctypes.data_as(i32), ox.ctypes.data_as(i32),
                flip.ctypes.data_as(i32), n, rnn_n, tar, out.ctypes.data_as(ctypes.POINTER(ptr)))
        if rc != 0:
            raise IOError(f"native batch load failed for {rc} sequence(s)")
        self._count("sequences", n)
        return out

    def close(self):
        if self._handle:
            self._lib.td_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
