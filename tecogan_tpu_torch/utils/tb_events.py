"""A TensorBoard event-file writer in Python, for the scalar and image
summaries (``utils/summaries.SummaryLogger``), where the JAX package uses
tensorboardX.

The file is ``<log_dir>/events.out.tfevents.<time>.<host>`` (tensorboardX's
name), a sequence of TFRecord records: the data's length as a little-endian
uint64 and that length's masked CRC-32C, then the data and its masked
CRC-32C. Each record is one ``Event`` protobuf, encoded here by hand:

    Event   {1: double wall_time, 2: int64 step, 3: string file_version,
             5: Summary summary}
    Summary {1: repeated Value value}
    Value   {1: string tag, 2: float simple_value, 4: Image image}
    Image   {1: int32 height, 2: int32 width, 3: int32 colorspace,
             4: bytes encoded_image_string}

The first event carries ``file_version = "brain.Event:2"``; an image is a
PNG from the port's codec (``data/png.py``).
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np


def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ poly, table >> 1).astype(np.uint32)
    return table


_CRC_TABLE = [int(v) for v in _crc32c_table()]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, one table lookup a byte."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right by 15 bits, plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s take ten bytes, two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def scalar_value(tag: str, value: float) -> bytes:
    """A ``Summary.Value`` with a float32 ``simple_value``."""
    return _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)


def image_value(tag: str, image: np.ndarray) -> bytes:
    """A ``Summary.Value`` holding an (H, W, 3) uint8 image as a PNG."""
    # Imported here: the data package imports the streaming path, which
    # imports this package's CUDA graphs.
    from tecogan_tpu_torch.data.png import encode_png

    h, w, c = image.shape
    img = (_int_field(1, h) + _int_field(2, w) + _int_field(3, c)
           + _bytes_field(4, encode_png(image)))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, img)


def event(step: int, wall_time: float, values=(), file_version: str = "") -> bytes:
    """An ``Event`` with a ``Summary`` of ``values`` (encoded
    ``Summary.Value`` messages), or with ``file_version``."""
    out = _key(1, 1) + struct.pack("<d", wall_time) + _int_field(2, step)
    if file_version:
        return out + _bytes_field(3, file_version.encode())
    return out + _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))


class EventWriter:
    """Appends events to one new event file in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._f.write(record(event(0, time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add(self, step: int, values) -> None:
        """One event at ``step`` holding the encoded ``values``."""
        self._f.write(record(event(int(step), time.time(), values)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_records(path: str):
    """The data of every record in an event file, each length and data
    checked against its masked CRC (raises ValueError on a mismatch)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        body = data[pos + 12:pos + 12 + length]
        (crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if len(body) != length or crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        out.append(body)
        pos += 16 + length
    return out
