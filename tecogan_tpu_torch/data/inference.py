"""Frame I/O of the inference CLI (counterpart of
``tecogan_tpu/data/inference.py``; reference dataloader.py:11-50 and the
per-frame save loop main.py:253-270).

- lists the PNGs of a directory with the numeric-aware sort;
- HR -> LR when only an HR directory is given: OpenCV's Gaussian blur
  (sigma 1.5, ``ops/blur.py``), every 4th pixel, / 255;
- prepends reversed frames [5..1] as warm-up padding;
- decodes through the native thread pool (``data/native_loader.py``,
  ``csrc/tecodata.cpp``) where it builds, on both routes, else with the
  port's python codec (``data/png.py``) on worker threads, in place of
  the JAX package's libpng pool or ``cv2.imread``; the pixels are the same
  either way;
- :class:`FrameWriter` encodes the HR PNGs (natively where it can) while
  the device computes the next chunk.

Images are RGB, as ``cv2.imread(path, 3)[..., ::-1]`` gives them: a gray
PNG is replicated into three channels and an alpha channel is dropped.
``load_inference_frames(input_video=...)`` decodes a video file instead
(``data/video_io.py``); frames are written as PNG here, or as a video by
``data/video_io.py:VideoFrameWriter``. The JAX package's ``cv2.imwrite``
fallback for other image extensions is not ported.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from tecogan_tpu_torch.data import native_loader
from tecogan_tpu_torch.data.png import read_png, write_png
from tecogan_tpu_torch.ops.blur import gaussian_blur_reflect101
from tecogan_tpu_torch.ops.image import list_png_in_dir
from tecogan_tpu_torch.recurrent.inference import prepend_warmup


class InferenceData(NamedTuple):
    paths_lr: List[str]
    inputs: np.ndarray  # (T, h, w, 3) [0, 1] f32 or raw uint8, warm-up included
    fps: float = 0.0  # source frame rate (video-file input only; 0 = unknown)


def _native_io(num_threads: int = 8) -> Optional[native_loader.NativeFrameIO]:
    """The native frame codec, or None (the cause printed) where its library
    cannot be built or loaded: callers then use ``data/png.py``."""
    try:
        return native_loader.NativeFrameIO(num_threads)
    except native_loader.UNAVAILABLE_ERRORS as exc:
        print("inference IO: native decoder unavailable "
              f"({native_loader.unavailable_detail(exc)}); using data/png.py")
        return None


def read_rgb(path: str) -> np.ndarray:
    """A PNG as uint8 (H, W, 3) RGB, as ``cv2.imread(path, 3)[..., ::-1]``
    reads an 8-bit one: gray replicated, alpha dropped."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_frames(paths: List[str], num_threads: int = 8) -> np.ndarray:
    """Decode PNGs to one (T, H, W, 3) uint8 array, ``num_threads`` files at
    a time (``zlib.decompress`` releases the GIL)."""
    with ThreadPoolExecutor(max(1, num_threads)) as pool:
        return np.stack(list(pool.map(read_rgb, paths)))


def hr_to_lr(frames: np.ndarray, device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """(T, H, W, 3) uint8 HR frames -> (T, ceil(H/4), ceil(W/4), 3) float32
    LR in [0, 1]: ``cv2.GaussianBlur(im.astype(np.float32), (0, 0),
    sigmaX=1.5)[::4, ::4] / 255.0`` (reference dataloader.py:34-36), the
    blur on ``device``, one frame at a time."""
    out = []
    for frame in frames:
        x = torch.from_numpy(frame).to(device).float()
        out.append((gaussian_blur_reflect101(x, 1.5)[::4, ::4] / 255.0).cpu().numpy())
    return np.stack(out)


def load_inference_frames(
    input_dir_lr: Optional[str] = None,
    input_dir_hr: Optional[str] = None,
    max_frames: int = -1,
    as_uint8: bool = False,
    device: Union[str, torch.device] = "cuda",
    num_threads: int = 8,
    use_native: bool = True,
    input_video: Optional[str] = None,
) -> InferenceData:
    """Load the LR input sequence: the PNGs of ``input_dir_lr`` or, when that
    is not given or missing, the HR PNGs of ``input_dir_hr`` blurred and
    subsampled 4x (the blur on ``device``, the card unless the caller asks
    for the CPU); reversed frames [5..1] are prepended as warm-up.

    ``as_uint8`` keeps LR frames as raw uint8 (StreamingSR normalises on the
    device); ignored on the HR route, which is float by construction.
    ``use_native`` decodes through the native thread pool where it builds
    (the JAX package decodes only the LR route so; here the HR route's
    frames go through it too, as uint8, before the same blur).

    ``input_video`` decodes a video file instead of a PNG directory
    (``data/video_io.py``; H.264 and VP9 on ``device``'s NVDEC); the frames
    are the LR sequence, ``paths_lr`` names them ``<path>#<i>`` and ``fps``
    is the container's rate. The same
    reversed-[5..1] warm-up is prepended."""
    if input_video:
        from tecogan_tpu_torch.data.video_io import read_video_frames

        frames, fps = read_video_frames(input_video, max_frames=max_frames,
                                        as_uint8=as_uint8, device=device)
        if frames.shape[0] < 6:
            raise ValueError(f"warm-up needs >= 6 frames ({frames.shape[0]} in {input_video})")
        paths = prepend_warmup([f"{input_video}#{i}" for i in range(frames.shape[0])])
        frames = np.concatenate([frames[5:0:-1], frames], axis=0)
        return InferenceData(paths_lr=paths, inputs=np.ascontiguousarray(frames), fps=fps)

    filedir, down_sp = input_dir_lr, False
    if filedir is None or not os.path.exists(filedir):
        if input_dir_hr is None or not os.path.exists(input_dir_hr):
            raise ValueError("Input directory not found")
        filedir, down_sp = input_dir_hr, True

    paths = list_png_in_dir(filedir, prefix_skip="\x00")  # no IB-skip here
    if max_frames > 0:
        paths = paths[:max_frames]
    if not paths:
        raise ValueError(f"no .png frames in {filedir}")
    u8 = as_uint8 or down_sp
    io = _native_io(num_threads) if use_native else None
    if io is not None:
        try:
            frames = io.decode_frames_u8(paths) if u8 else io.decode_frames(paths)
        finally:
            io.close()
    else:
        frames = read_frames(paths, num_threads)
        if not u8:
            frames = frames.astype(np.float32) / 255.0
    if down_sp:
        frames = hr_to_lr(frames, device)

    paths = prepend_warmup(paths)
    frames = np.concatenate([frames[5:0:-1], frames], axis=0)
    return InferenceData(paths_lr=paths, inputs=np.ascontiguousarray(frames))


class AsyncChunkWriter:
    """A bounded queue feeding a worker thread, so host encoding overlaps
    device compute; errors are deferred to ``close()``. Subclasses
    implement ``_write(frames, start)`` and optionally ``_finalize()``."""

    def __init__(self, depth: int = 4):
        self.count = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: List[BaseException] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _write(self, frames: np.ndarray, start: int) -> None:
        raise NotImplementedError

    def _finalize(self) -> None:
        """Release encoder resources; runs even when a write failed."""

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except BaseException as exc:  # surfaced by close()
                self._err.append(exc)

    def submit(self, frames: np.ndarray, start_index: int) -> None:
        """frames: (n, H, W, 3) uint8 for output indices start_index..+n,
        counted with the warm-up, whose frames are already dropped
        (StreamingSR.run's ``on_chunk`` contract)."""
        self._q.put((frames, start_index))

    def close(self) -> int:
        """Flush, join, raise any deferred encode error; returns #frames."""
        self._q.put(None)
        self._thread.join()
        self._finalize()
        if self._err:
            raise self._err[0]
        return self.count


class FrameWriter(AsyncChunkWriter):
    """Writes HR chunks as ``<name>_<i:04d>.png``, ``i`` counted from 0
    after the warm-up (reference main.py:262-269), each chunk's frames
    encoded on ``num_threads`` threads: by the native library's pool
    (:meth:`NativeFrameIO.encode_frames`, Sub rows, deflate level 1) where
    it builds, else through :func:`data.png.write_png`. Only ``ext="png"``
    is supported. ``encode_s`` counts the writer thread's seconds in
    encoding (and waiting for ``fetch=False`` frames to download)."""

    def __init__(self, out_dir: str, name: str = "output", ext: str = "png",
                 warmup: int = 0, num_threads: int = 8):
        if ext != "png":
            raise ValueError(f"--output_ext {ext}: only png is written (the JAX "
                             "package's cv2.imwrite fallback is not ported)")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.name = name
        self.ext = ext
        self.warmup = warmup
        self.num_threads = max(1, num_threads)
        self.encode_s = 0.0
        self._native = _native_io(self.num_threads)
        self._pool = ThreadPoolExecutor(self.num_threads) if self._native is None else None
        super().__init__()

    def _path(self, out_idx: int) -> str:
        return os.path.join(self.out_dir, f"{self.name}_{out_idx:04d}.{self.ext}")

    def _write(self, frames: np.ndarray, start: int) -> None:
        t0 = time.perf_counter()
        frames = np.ascontiguousarray(frames)
        first = start - self.warmup
        paths = [self._path(first + i) for i in range(frames.shape[0])]
        if self._native is not None:
            self._native.encode_frames(paths, frames)
        else:
            for done in [self._pool.submit(write_png, p, f) for p, f in zip(paths, frames)]:
                done.result()
        self.count += len(paths)
        self.encode_s += time.perf_counter() - t0

    def _finalize(self) -> None:
        if self._native is not None:
            self._native.close()
        else:
            self._pool.shutdown()
