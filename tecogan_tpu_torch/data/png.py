"""A minimal PNG codec on the standard library's ``zlib`` and numpy.

It stands in for ``cv2.imread`` / ``cv2.imwrite`` (``tecogan_tpu/data/
loader.py:190-199``, ``synthetic.py:207``), which the port cannot use: the
GPU machine has no OpenCV. It reads 8-bit gray, RGB and RGBA images, not
interlaced, with any of the five PNG row filters, and writes the same three
formats with filter 0 (None). Anything else (16-bit samples, palettes,
gray + alpha, Adam7 interlacing) raises ValueError.

Images are numpy uint8 arrays in RGB(A) order: (H, W) gray, (H, W, 3) RGB,
(H, W, 4) RGBA.

Rows filtered with None, Sub and Up are undone in numpy. Average and Paeth
predict each byte from the reconstructed one to its left, a serial
recurrence: they are undone by ``csrc/png_unfilter.c``, compiled with the
host C compiler (``$CC``, else ``cc``, ``gcc`` or ``clang``) on first use
into the git-ignored ``tecogan_tpu_torch/_build/`` and loaded with ctypes.
Without a C compiler such a file raises; there is no slow fallback. The
Python loops :func:`_unfilter_average` and :func:`_unfilter_paeth` are the
plain version the tests hold the C code to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels
_BY_CHANNELS = {c: t for t, c in _COLOR_TYPES.items()}


def _chunks(data: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        pos += 12 + length


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> bytearray:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


_PKG = Path(__file__).resolve().parent.parent
_UNFILTER_SRC = _PKG / "csrc" / "png_unfilter.c"
_CFLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")
_LOCK = threading.Lock()


def _c_compiler() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc", "clang"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("reading a PNG with Average or Paeth rows needs a C compiler "
                       f"to build {_UNFILTER_SRC.name}: set CC or put cc, gcc or "
                       "clang on PATH")


def _native() -> ctypes.CDLL:
    """The compiled Average/Paeth unfilter (built on first call)."""
    with _LOCK:
        return _load_native()


@functools.lru_cache(maxsize=None)
def _load_native() -> ctypes.CDLL:
    source = _UNFILTER_SRC.read_bytes()
    digest = hashlib.sha256(" ".join(_CFLAGS).encode() + source).hexdigest()[:16]
    lib_path = _PKG / "_build" / f"png-{digest}" / "libpng_unfilter.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_c_compiler(), *_CFLAGS, "-o", str(tmp), str(_UNFILTER_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"C compiler failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: another process never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.tt_unfilter_average, lib.tt_unfilter_paeth):
        fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2
        fn.restype = None
    return lib


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to uint8 (H, W), (H, W, 3) or (H, W, 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"not a PNG: {path}")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if (depth != 8 or color not in _COLOR_TYPES or compression != 0
            or filter_method != 0 or interlace != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour "
                         f"type {color}, interlace {interlace}); this codec "
                         "reads 8-bit gray, RGB and RGBA, not interlaced")
    bpp = _COLOR_TYPES[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, want "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = zeros = np.zeros(stride, np.uint8)
    if np.isin(rows[:, 0], (3, 4)).any():
        native = _native()
        raw_ptr, out_ptr, zeros_ptr = raw.ctypes.data, out.ctypes.data, zeros.ctypes.data
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:    # None
            out[y] = line
        elif kind == 1:  # Sub: running sum over the pixels, mod 256
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind in (3, 4):  # Average, Paeth: the C unfilter, row by row
            fn = native.tt_unfilter_average if kind == 3 else native.tt_unfilter_paeth
            fn(raw_ptr + y * (stride + 1) + 1,
               out_ptr + (y - 1) * stride if y else zeros_ptr,
               out_ptr + y * stride, stride, bpp)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        prev = out[y]
    img = out.reshape(h, w, bpp)
    return img[:, :, 0] if bpp == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode uint8 (H, W), (H, W, 3) or (H, W, 4) as PNG bytes, every row
    with filter 0, deflated at zlib ``level``."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or channels not in _BY_CHANNELS:
        raise ValueError(f"encode_png takes uint8 gray, RGB or RGBA images, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(h, w * channels)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _BY_CHANNELS[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Encode ``img`` (:func:`encode_png`) to a PNG file."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)
