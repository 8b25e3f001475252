"""A minimal PNG writer (8-bit RGB, no row filter, zlib level 1) for the
training scenes the benchmark writes at set-up."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Tuple

import numpy as np


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = img.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_all(items: Iterable[Tuple[str, np.ndarray]], threads: int = 8) -> None:
    """Write (path, frame) pairs on ``threads`` threads (zlib releases the
    interpreter lock)."""
    def one(item):
        path, img = item
        with open(path, "wb") as f:
            f.write(encode(img))

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for _ in pool.map(one, items):
            pass
