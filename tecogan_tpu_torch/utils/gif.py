"""An animated-GIF writer in numpy and Python, for the sequence summaries
(``utils/summaries.encode_gif``), where the JAX package calls PIL.

The frames share one palette of at most 256 colours (their colours exactly
when they have that few, else a mean cut over all of them: a summary's
frames are one scene, and one cut costs a tenth of ten), written as the
global colour table; PIL cuts a palette for each frame. Each frame is
LZW-compressed with 8-bit codes to start and written after a
graphic-control block holding its delay; a NETSCAPE2.0 block loops the
animation forever (loop 0), as PIL's ``save(..., loop=0)`` does.
"""

from __future__ import annotations

import heapq
import struct
from typing import List, Tuple

import numpy as np

_MIN_CODE_SIZE = 8
_CLEAR, _END = 1 << _MIN_CODE_SIZE, (1 << _MIN_CODE_SIZE) + 1
_MAX_CODES = 4096


def _box(colors: np.ndarray, counts: np.ndarray, members: np.ndarray):
    """A heap entry for a box: its squared error about its count-weighted
    mean (negated, so the largest pops first), the channel of its widest
    range, that range, the mean in that channel and its members."""
    c, w = colors[members], counts[members]
    total = w.sum()
    mean = (w @ c) / total
    sse = float(w @ (c * c).sum(1) - (mean ** 2).sum() * total)
    ranges = c.max(0) - c.min(0)
    ch = int(np.argmax(ranges))
    return (-sse, len(members), ch, float(ranges[ch]), float(mean[ch]), members)


def split_boxes(colors: np.ndarray, counts: np.ndarray, n: int = 256) -> np.ndarray:
    """Split the (K, 3) colours, weighted by ``counts``, into at most ``n``
    boxes: each time the box with the largest squared error is cut across its
    widest channel at its weighted mean there (a mean cut: no sort, and on
    these frames a lower error than the median's). Returns each colour's
    box index."""
    colors = colors.astype(np.float64)
    counts = counts.astype(np.float64)
    done, heap = [], [_box(colors, counts, np.arange(len(colors)))]
    while heap and len(heap) + len(done) < n:
        _, _, ch, span, mean, members = heapq.heappop(heap)
        if span == 0:  # one colour: nothing to cut
            done.append(members)
            continue
        low = colors[members, ch] <= mean  # min < mean < max: both sides hold some
        for part in (members[low], members[~low]):
            heapq.heappush(heap, _box(colors, counts, part))
    label = np.empty(len(colors), np.int64)
    for i, members in enumerate(done + [entry[-1] for entry in heap]):
        label[members] = i
    return label


def quantize(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(..., 3) uint8 -> a palette (P <= 256, 3) uint8 and (...) uint8
    indices, one palette for all the pixels. At most 256 colours are kept
    exactly. Otherwise the pixels fall into cells of 5 bits a channel, the
    cells' mean colours are split into boxes (:func:`split_boxes`, weighted
    by their pixel counts), each cell then moves to the box whose mean is
    nearest its own, and a palette entry is the mean of its box's pixels."""
    shape = frames.shape[:-1]
    rgb = frames.reshape(-1, 3).astype(np.int64)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    uniq, inverse = np.unique(packed, return_inverse=True)
    if len(uniq) <= 256:
        colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
        return colors.astype(np.uint8), inverse.reshape(shape).astype(np.uint8)
    cell = ((rgb[:, 0] >> 3) << 10) | ((rgb[:, 1] >> 3) << 5) | (rgb[:, 2] >> 3)
    cells, of_pixel = np.unique(cell, return_inverse=True)
    counts = np.bincount(of_pixel, minlength=len(cells)).astype(np.float64)
    sums = np.stack([np.bincount(of_pixel, rgb[:, c], len(cells)) for c in range(3)], 1)
    means = (sums / counts[:, None]).astype(np.float32)

    def box_means(label, k):
        return (np.stack([np.bincount(label, sums[:, c], k) for c in range(3)], 1)
                / np.bincount(label, counts, k)[:, None])

    label = split_boxes(means, counts)
    k = int(label.max()) + 1
    palette = box_means(label, k).astype(np.float32)
    label = sum((means[:, c, None] - palette[None, :, c]) ** 2 for c in range(3)).argmin(1)
    used, label = np.unique(label, return_inverse=True)  # boxes left empty go
    palette = np.rint(box_means(label, len(used)))
    return palette.astype(np.uint8), label[of_pixel].reshape(shape).astype(np.uint8)


def lzw_encode(indices: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit ``indices`` (code size 8: clear
    256, end 257), least significant bit first. The code width grows when
    the table's next code passes it; a full table (4096 codes) emits a
    clear and starts over."""
    out = bytearray()
    acc = nbits = 0
    size = _MIN_CODE_SIZE + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    emit(_CLEAR)
    if indices:
        table = {}
        nxt = _END + 1
        prefix = indices[0]
        for k in indices[1:]:
            key = (prefix << 8) | k
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            emit(prefix)
            if nxt == _MAX_CODES:
                emit(_CLEAR)
                table.clear()
                nxt, size = _END + 1, _MIN_CODE_SIZE + 1
            else:
                table[key] = nxt
                nxt += 1
                if nxt > (1 << size) and size < 12:
                    size += 1
            prefix = k
        emit(prefix)
    emit(_END)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts: List[bytes] = []
    for s in range(0, len(data), 255):
        chunk = data[s:s + 255]
        parts.append(bytes([len(chunk)]) + chunk)
    return b"".join(parts) + b"\x00"


def write_gif(path: str, frames: np.ndarray, duration_ms: int) -> None:
    """Write (T, H, W, 3) uint8 ``frames`` as a looping GIF89a, each frame
    shown ``duration_ms`` (stored in hundredths of a second, truncated, as
    PIL stores it)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"write_gif takes (T, H, W, 3) uint8 frames, got "
                         f"{frames.dtype} {frames.shape}")
    t, h, w, _ = frames.shape
    delay = int(duration_ms) // 10
    palette, idx = quantize(frames)
    bits = max(1, int(np.ceil(np.log2(max(2, len(palette))))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    body = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x80 | 0x70 | (bits - 1), 0, 0),
            table.tobytes(),
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for frame in idx:
        body.append(b"\x21\xf9\x04" + struct.pack("<BHB", 0, delay, 0) + b"\x00")
        body.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        body.append(bytes([_MIN_CODE_SIZE]) + _sub_blocks(lzw_encode(frame.tobytes())))
    body.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(body))
