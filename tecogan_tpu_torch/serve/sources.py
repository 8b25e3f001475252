"""Incremental per-stream LR frame sources for serving (counterpart of
``tecogan_tpu/serve/sources.py``).

A :class:`FrameSource` decodes its source on a worker thread into a bounded
queue: host memory stays O(lookahead) per stream, serving starts as soon
as the first frame lands, and a lagging source never blocks the tick loop
(:meth:`try_next` does not wait, and the server keeps an omitted stream's
slot state bit for bit). This is the reference's per-frame feed loop
(reference main.py:253-270) for N concurrent sources.

The reversed-[5..1] warm-up (reference dataloader.py:42-44) is applied in
the stream: the producer buffers the first six frames, emits frames 5..1
reversed, then the sequence from frame 0, the order of
``data/inference.py:load_inference_frames``.

PNG directories decode in blocks of four frames through the native thread
pool (``data/native_loader.py``) where it builds, as the JAX package's
libpng pool does, else with the port's python codec (``data/png.py``);
either way on the worker thread, and ``decode_s`` counts its seconds.
A video file decodes through ``data/video_io.py:VideoReader`` on the same
thread, one decoder per source (Motion JPEG and MPEG-4 Part 2 on the host;
H.264 and VP9 on ``device``'s NVDEC, unverified (ROADMAP item 12b), the
card unless the caller asks for the CPU, where they raise), and ``fps``
is its container's rate once the first frame is out.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np

from tecogan_tpu_torch.data.inference import read_rgb
from tecogan_tpu_torch.ops.image import list_png_in_dir

#: try_next() result meaning "no frame decoded yet; ask again next tick".
PENDING = object()
#: try_next() result meaning "source exhausted; close the stream".
EOS = object()

_WARMUP = 5  # reversed warm-up prefix length (reference dataloader.py:42-44)
_DECODE_BLOCK = 4  # PNGs decoded at once (the native pool, or zlib and the unfilter
                   # releasing the GIL)


class FrameSource:
    """Bounded-lookahead frame feeder for one serving stream.

    Args:
      src: LR source, a PNG directory or a video file. ``frames`` (an iterable of (h, w, 3)
        arrays) substitutes for tests and live feeds.
      lookahead: producer queue depth; host memory per stream is
        O(lookahead) frames.
      warmup: prepend the reversed-[5..1] warm-up frames (offline-sequence
        semantics; pass False for live sources).
      max_frames: cap on source frames (before warm-up padding); <= 0 means
        the whole source.
      as_uint8: keep frames uint8 (the serving feed); else float32 in [0, 1].

    ``decode_s`` counts the worker thread's seconds spent decoding.
    """

    def __init__(self, src: Optional[str] = None, lookahead: int = 16,
                 warmup: bool = True, max_frames: int = -1,
                 as_uint8: bool = True,
                 frames: Optional[Iterable[np.ndarray]] = None, device=None):
        if (src is None) == (frames is None):
            raise ValueError("pass exactly one of src / frames")
        self.src = src
        self.warmup = _WARMUP if warmup else 0
        self.shape: Optional[tuple] = None  # (h, w) after the first frame
        self.fps = 0.0  # a video source's frame rate (0 = unknown, PNG dirs)
        self.decode_s = 0.0
        self._frames = frames
        self._max_frames = max_frames
        self._as_uint8 = as_uint8
        self._device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=max(2, lookahead))
        self._err: Optional[BaseException] = None
        self._head: Optional[list] = [] if self.warmup else None
        self._first = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name=f"frame-source-{src}")
        self._thread.start()

    # ------------------------------------------------------------ consumer
    @property
    def ready(self) -> bool:
        """True once the first frame decoded (geometry known), or the
        producer failed, in which case :meth:`geometry` raises."""
        return self._first.is_set()

    def geometry(self, timeout: Optional[float] = None):
        """Block until the first frame decodes; returns (h, w).

        Raises the producer's deferred error if it failed before producing
        anything (missing path, video file, decode error)."""
        if not self._first.wait(timeout):
            raise TimeoutError(f"no frame from {self.src!r} in {timeout}s")
        if self.shape is None:
            if self._err is None:
                raise RuntimeError(f"{self.src!r} ended before its first frame")
            raise self._err
        return self.shape

    def try_next(self):
        """Non-blocking fetch: an (h, w, 3) frame, PENDING when the decoder
        has not caught up, or EOS when the source is exhausted. Producer
        errors re-raise here (after any frames already decoded)."""
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            if not self._thread.is_alive() and self._q.empty():
                # The producer ended between its last put and the sentinel.
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                return EOS
            return PENDING
        if item is None:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            return EOS
        return item

    def stop(self) -> None:
        """Abandon the stream: unblock and join the producer."""
        self._stopped.set()
        try:  # unblock a producer parked on a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)

    # ------------------------------------------------------------ producer
    def _put(self, frame: np.ndarray) -> bool:
        while not self._stopped.is_set():
            try:
                self._q.put(frame, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _emit(self, raw) -> bool:
        """Warm-up-aware emission: buffers the first 6 frames, then emits
        [f5..f1 reversed, f0, f1, ...] as load_inference_frames orders them."""
        if self.shape is None:
            self.shape = tuple(np.asarray(raw).shape[:2])
            self._first.set()
        if self._head is not None:
            self._head.append(raw)
            if len(self._head) < _WARMUP + 1:
                return True
            head, self._head = self._head, None
            for f in head[_WARMUP:0:-1] + head:
                if not self._put(f):
                    return False
            return True
        return self._put(raw)

    def _produce(self) -> None:
        n = 0
        try:
            for frame in (self._frames if self._frames is not None
                          else self._iter_src()):
                if 0 < self._max_frames <= n:
                    break
                n += 1
                if not self._emit(frame):
                    return  # stopped
            if self._head is not None:
                raise ValueError(
                    f"warm-up needs >= {_WARMUP + 1} frames "
                    f"({len(self._head)} in {self.src!r}); pass "
                    "--no_warmup for short/live sources")
        except BaseException as exc:  # re-raised to the consumer by try_next
            self._err = exc
        finally:
            self._first.set()  # geometry() must not hang on failure
            try:
                self._q.put_nowait(None)
            except queue.Full:
                # stop() drained one slot, or the consumer vanished; the
                # is_alive() check in try_next covers the EOS then.
                pass

    def _iter_src(self):
        if os.path.isfile(self.src):
            yield from self._iter_video()
            return
        yield from self._iter_png_dir()

    def _iter_video(self):
        from tecogan_tpu_torch.data.video_io import VideoReader

        with VideoReader(self.src, block=_DECODE_BLOCK, device=self._device) as reader:
            self.fps = reader.fps
            while True:
                t0 = time.perf_counter()
                rgb = reader.read()
                self.decode_s += time.perf_counter() - t0
                if rgb is None:
                    return
                yield rgb if self._as_uint8 else rgb.astype(np.float32) / 255.0

    def _iter_png_dir(self):
        paths = list_png_in_dir(self.src, prefix_skip="\x00")
        if not paths:
            raise ValueError(f"no .png frames in {self.src}")
        if 0 < self._max_frames < len(paths):
            paths = paths[:self._max_frames]
        from tecogan_tpu_torch.data.inference import _native_io

        io = _native_io(num_threads=_DECODE_BLOCK)
        pool = ThreadPoolExecutor(_DECODE_BLOCK) if io is None else None
        try:
            for i in range(0, len(paths), _DECODE_BLOCK):
                block = paths[i:i + _DECODE_BLOCK]
                t0 = time.perf_counter()
                if io is not None:
                    frames = list(io.decode_frames_u8(block) if self._as_uint8
                                  else io.decode_frames(block))
                else:
                    frames = list(pool.map(read_rgb, block))
                    if not self._as_uint8:
                        frames = [f.astype(np.float32) / 255.0 for f in frames]
                self.decode_s += time.perf_counter() - t0
                yield from frames
        finally:
            if io is not None:
                io.close()
            else:
                pool.shutdown()
