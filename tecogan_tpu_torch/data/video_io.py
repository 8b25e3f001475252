"""Video-file I/O of the port (counterpart of ``tecogan_tpu/data/video_io.py``)
without OpenCV: the port's own library, ``csrc/tecovideo*.cpp``, through
``data/video_native.py``.

- :func:`read_video_frames` decodes a file to the (T, h, w, 3) RGB array
  the streaming engine consumes, and the container's frame rate.
- :class:`VideoReader` streams frames, with ``seek(frame_index)`` and
  ``fps``; the serving sources, ``data.prepare.extract_scene`` and
  ``data.synthetic.create_capture`` read through it.
- :class:`VideoFrameWriter` encodes HR chunks on a background thread, with
  the ``submit(frames, start_index)`` contract of
  ``data/inference.py:FrameWriter``.

What is read, as the frames ``cv2.VideoCapture`` returns for it:
- Motion JPEG and MPEG-4 Part 2 (the ``mp4v`` and ``XVID`` streams that the
  JAX package's writer produces) in AVI, MP4/M4V and MKV, decoded on the
  host by the port's library (bit-equal on files that OpenCV writes; see
  ``tests/test_torch_video_io.py``);
- H.264 (Baseline, Main, High; MP4/M4V, MKV, AVI) and VP9 (profile 0;
  WebM/MKV, MP4), routed to the card's NVDEC and converted there by the
  NV12 kernel (``data/video_nvdec.py``; ``tests/test_torch_nvdec.py``).
  NVDEC's decode is unverified: the only card the port is checked on
  creates no NVDEC decoder (its container withholds NVIDIA's
  ``video`` capability), so these files raise ``NvdecUnavailable`` there
  (ROADMAP item 12b). The readers take ``device``: None is the card;
  ``"cpu"``, or no card, makes these two codecs raise NotImplementedError
  (there is no software decoder for them), and a driver without
  ``libnvcuvid`` raises OSError.
HEVC and AV1 raise NotImplementedError naming ROADMAP item 12c; other
codecs raise NotImplementedError too.

What is written, by extension as the JAX writer picks its fourcc: ``.avi``
Motion JPEG (4:2:0, quality :data:`JPEG_QUALITY`); ``.mp4``, ``.m4v`` and
``.mkv`` MPEG-4 Part 2 Simple Profile at the fixed quantiser
:data:`MPEG4_QSCALE`. Known deviation: the MPEG-4 writer codes every frame
as an I-VOP, where the JAX package's (lavc's) writes P-VOPs in GOPs of 12;
the codec and container are the same and every frame is a key frame, so
the files are larger (``tests/test_torch_video_io.py`` records the sizes)
and no farther from the source.
"""

from __future__ import annotations

import math
import os
import time
from fractions import Fraction
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tecogan_tpu_torch.data import video_native
from tecogan_tpu_torch.data.inference import AsyncChunkWriter

#: Container and codec per output extension (the JAX writer's fourccs:
#: mp4v for .mp4/.m4v/.mkv, MJPG for .avi).
_KIND_BY_EXT = {
    ".mp4": video_native.MP4_MPEG4,
    ".m4v": video_native.MP4_MPEG4,
    ".avi": video_native.AVI_MJPEG,
    ".mkv": video_native.MKV_MPEG4,
}
#: JPEG quality of the Motion JPEG writer (libjpeg's scaling of Annex K).
JPEG_QUALITY = 95
#: Quantiser of the MPEG-4 writer (H.263 quantisation, 1-31).
MPEG4_QSCALE = 3
#: Codecs this module decodes: on the host, and on the card's NVDEC.
HOST_CODECS = ("mjpeg", "mpeg4")
NVDEC_CODECS = ("h264", "vp9")
#: Codecs that wait for a test stream in the repository (ROADMAP item 12c).
LATER_CODECS = ("hevc", "av1")


def video_kind(path: str) -> int:
    """The writer kind for ``path``'s extension; ValueError for others."""
    ext = os.path.splitext(path)[1].lower()
    kind = _KIND_BY_EXT.get(ext)
    if kind is None:
        raise ValueError(f"unsupported video extension {ext!r}; "
                         f"choose one of {sorted(_KIND_BY_EXT)}")
    return kind


def fps_rational(fps: float, max_num: int = 65535) -> Tuple[int, int]:
    """``fps`` as the integer rate OpenCV's FFmpeg writer derives from it
    (a power-of-ten base until within 0.001), reduced; the numerator is
    capped at ``max_num``, the largest MPEG-4 time resolution."""
    if not fps > 0 or not math.isfinite(fps):
        raise ValueError(f"frame rate must be positive, got {fps}")
    num, den = int(fps + 0.5), 1
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    r = Fraction(num, den)
    if r.numerator > max_num:
        r = Fraction(fps).limit_denominator(max(1, int(max_num / fps)))
    return r.numerator, r.denominator


def _nvdec_device(device) -> str:
    """The card ``device`` names for NVDEC, or why there is none."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return f"device {device} was asked for"
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    return ""


def _open(path: str, device=None):
    if not os.path.exists(path):
        raise FileNotFoundError(f"video not found: {path}")
    reader = video_native.NativeVideoReader(path)
    codec, where = reader.codec, f"{path}: {reader.codec} video ({reader.container})"
    if codec in HOST_CODECS:
        return reader
    if codec in NVDEC_CODECS:
        why = _nvdec_device(device)
        if why:
            reader.close()
            raise NotImplementedError(
                f"{where} decodes on the card's NVDEC only (ROADMAP item 12b), and {why}; "
                "the port has no software decoder for H.264 or VP9")
        from tecogan_tpu_torch.data.video_nvdec import NvdecVideoReader

        return NvdecVideoReader(path, device=device, demuxed=reader)
    reader.close()
    if codec in LATER_CODECS:
        raise NotImplementedError(
            f"{where} is not decoded by the port yet: HEVC and AV1 wait for ROADMAP item 12c, "
            "a test stream of each in the repository (item 12b decodes H.264 and VP9 on the "
            "card's NVDEC)")
    raise NotImplementedError(
        f"{where} is not decoded by the port: it reads Motion JPEG and MPEG-4 Part 2 on the "
        "host, H.264 and VP9 on the card's NVDEC (ROADMAP item 12b)")


class VideoReader:
    """Frames of a video file in order, ``block`` decoded at a time.

    ``fps`` is the container's rate (0.0 when it states none), as
    ``cv2.CAP_PROP_FPS`` reads it. ``device`` is where H.264 and VP9 decode
    (None: the card; see the module's docstring). Missing files raise
    FileNotFoundError, unknown containers ValueError, codecs not decoded
    here NotImplementedError."""

    def __init__(self, path: str, block: int = 8, device=None):
        self.path = path
        self._r = _open(path, device)
        self.fps = self._r.fps
        self._block = max(1, block)
        self._buf: List[np.ndarray] = []

    def read(self) -> Optional[np.ndarray]:
        """The next (h, w, 3) uint8 RGB frame, or None at the end."""
        if not self._buf:
            self._buf = list(self._r.decode(self._block))[::-1]
            if not self._buf:
                return None
        return self._buf.pop()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def seek(self, frame_index: int) -> None:
        """The next :meth:`read` returns frame ``frame_index`` (MPEG-4, H.264
        and VP9 decode from the nearest earlier key frame, as
        ``CAP_PROP_POS_FRAMES`` does; with B-frames the frame is the exact
        one in display order)."""
        self._buf = []
        self._r.seek(frame_index)

    def close(self) -> None:
        self._r.close()

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class VideoCapture:
    """The part of ``cv2.VideoCapture`` the JAX package's ``create_capture``
    callers use: ``read() -> (ok, BGR uint8)``, ``isOpened()``,
    ``release()``, over a :class:`VideoReader`."""

    def __init__(self, path: str, device=None):
        self._reader = VideoReader(path, device=device)
        self.fps = self._reader.fps

    def isOpened(self) -> bool:  # noqa: N802 (OpenCV's name)
        return self._reader is not None

    def read(self):
        frame = self._reader.read() if self._reader is not None else None
        if frame is None:
            return False, None
        return True, np.ascontiguousarray(frame[:, :, ::-1])

    def release(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None


def read_video_frames(path: str, max_frames: int = -1, as_uint8: bool = True,
                      device=None) -> Tuple[np.ndarray, float]:
    """Decode ``path`` to ``(frames, fps)``: (T, h, w, 3) RGB, uint8 (or
    float32 in [0, 1] when ``as_uint8=False``), and the container's rate
    (0.0 if it states none). ``max_frames <= 0`` means every frame;
    ``device`` is where H.264 and VP9 decode (None: the card)."""
    with VideoReader(path, block=16, device=device) as reader:
        frames: List[np.ndarray] = []
        for frame in reader:
            frames.append(frame)
            if 0 < max_frames <= len(frames):
                break
        fps = reader.fps
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    out = np.stack(frames)
    if not as_uint8:
        out = out.astype(np.float32) / 255.0
    return out, fps


class VideoFrameWriter(AsyncChunkWriter):
    """Background HR-chunk video encoder.

    The ``submit``/``close`` contract of ``data/inference.py:FrameWriter``,
    so the CLIs' decode -> device -> encode overlap holds for video output.
    Chunks arrive in stream order; the first must start at ``warmup`` (the
    index of the first output after the warm-up) and a gap raises at
    ``close()``. The extension is checked here in the constructor, before
    any decode or device work; the file opens on the first chunk (it needs
    H and W). The library encodes a chunk's frames on ``num_threads``
    threads, one per core (every frame is a key frame); ``encode_s`` counts
    the writer thread's seconds in encoding.
    """

    def __init__(self, path: str, fps: float = 24.0, warmup: int = 0, depth: int = 4):
        self._kind = video_kind(path)  # fail fast on unsupported extensions
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self.fps = fps if fps > 0 else 24.0
        self.warmup = warmup
        self.encode_s = 0.0
        self.num_threads = os.cpu_count() or 1
        self._rate = fps_rational(self.fps)
        self._writer: Optional[video_native.NativeVideoWriter] = None
        self._next_start = warmup
        super().__init__(depth=depth)

    def _write(self, frames, start: int) -> None:
        # A server's fetch=False frames download here, on the writer thread.
        frames = np.ascontiguousarray(frames)
        if start != self._next_start:
            raise ValueError(f"out-of-order chunk: start {start}, expected "
                             f"{self._next_start} (video output must be sequential)")
        self._next_start = start + frames.shape[0]
        t0 = time.perf_counter()
        if self._writer is None:
            h, w = frames.shape[1:3]
            quality = JPEG_QUALITY if self._kind == video_native.AVI_MJPEG else MPEG4_QSCALE
            self._writer = video_native.NativeVideoWriter(self.path, self._kind, w, h,
                                                          *self._rate, quality)
        self._writer.write(frames)
        self.count += frames.shape[0]
        self.encode_s += time.perf_counter() - t0

    def _finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()
