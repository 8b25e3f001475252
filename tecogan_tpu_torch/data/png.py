"""A minimal PNG codec on the standard library's ``zlib`` and numpy.

It stands in for ``cv2.imread`` / ``cv2.imwrite`` (``tecogan_tpu/data/
loader.py:190-199``, ``synthetic.py:207``), which the port cannot use: the
GPU machine has no OpenCV. It reads 8-bit gray, RGB and RGBA images, not
interlaced, with any of the five PNG row filters, and writes the same three
formats with filter 0 (None). Anything else (16-bit samples, palettes,
gray + alpha, Adam7 interlacing) raises ValueError.

Images are numpy uint8 arrays in RGB(A) order: (H, W) gray, (H, W, 3) RGB,
(H, W, 4) RGBA.
"""

from __future__ import annotations

import struct
import zlib
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
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:    # None
            out[y] = line
        elif kind == 1:  # Sub: running sum over the pixels, mod 256
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind == 3:  # Average
            out[y] = np.frombuffer(_unfilter_average(line.tobytes(), prev.tobytes(), bpp),
                                   np.uint8)
        elif kind == 4:  # Paeth
            out[y] = np.frombuffer(_unfilter_paeth(line.tobytes(), prev.tobytes(), bpp),
                                   np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        prev = out[y]
    img = out.reshape(h, w, bpp)
    return img[:, :, 0] if bpp == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Encode uint8 (H, W), (H, W, 3) or (H, W, 4) to a PNG file, every row
    with filter 0, deflated at zlib ``level``."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or channels not in _BY_CHANNELS:
        raise ValueError(f"write_png takes uint8 gray, RGB or RGBA images, "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(h, w * channels)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _BY_CHANNELS[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))
