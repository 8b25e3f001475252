"""Frame I/O of the inference CLI (counterpart of
``tecogan_tpu/data/inference.py``; reference dataloader.py:11-50 and the
per-frame save loop main.py:253-270).

- lists the PNGs of a directory with the numeric-aware sort;
- HR -> LR when only an HR directory is given: OpenCV's Gaussian blur
  (sigma 1.5, ``ops/blur.py``), every 4th pixel, / 255;
- prepends reversed frames [5..1] as warm-up padding;
- decodes with the port's PNG codec (``data/png.py``) on worker threads, in
  place of the JAX package's libpng pool or ``cv2.imread``;
- :class:`FrameWriter` encodes the HR PNGs on worker threads while the
  device computes the next chunk.

Images are RGB, as ``cv2.imread(path, 3)[..., ::-1]`` gives them: a gray
PNG is replicated into three channels and an alpha channel is dropped.
Only PNG is read and written; the JAX package's video files
(``data/video_io.py``) and its ``cv2.imwrite`` fallback for other
extensions are not ported.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from tecogan_tpu_torch.data.png import read_png, write_png
from tecogan_tpu_torch.ops.blur import gaussian_blur_reflect101
from tecogan_tpu_torch.ops.image import list_png_in_dir
from tecogan_tpu_torch.recurrent.inference import prepend_warmup


class InferenceData(NamedTuple):
    paths_lr: List[str]
    inputs: np.ndarray  # (T, h, w, 3) [0, 1] f32 or raw uint8, warm-up included


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


def hr_to_lr(frames: np.ndarray, device: Union[str, torch.device] = "cpu") -> np.ndarray:
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
    device: Union[str, torch.device] = "cpu",
    num_threads: int = 8,
) -> InferenceData:
    """Load the LR input sequence: the PNGs of ``input_dir_lr`` or, when that
    is not given or missing, the HR PNGs of ``input_dir_hr`` blurred and
    subsampled 4x (the blur on ``device``); reversed frames [5..1] are
    prepended as warm-up.

    ``as_uint8`` keeps LR frames as raw uint8 (StreamingSR normalises on the
    device); ignored on the HR route, which is float by construction."""
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
    frames = read_frames(paths, num_threads)
    if down_sp:
        frames = hr_to_lr(frames, device)
    elif not as_uint8:
        frames = frames.astype(np.float32) / 255.0

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
    encoded on ``num_threads`` threads through :func:`data.png.write_png`.
    Only ``ext="png"`` is supported."""

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
        self._pool = ThreadPoolExecutor(self.num_threads)
        super().__init__()

    def _path(self, out_idx: int) -> str:
        return os.path.join(self.out_dir, f"{self.name}_{out_idx:04d}.{self.ext}")

    def _write(self, frames: np.ndarray, start: int) -> None:
        frames = np.ascontiguousarray(frames)
        first = start - self.warmup
        paths = [self._path(first + i) for i in range(frames.shape[0])]
        for done in [self._pool.submit(write_png, p, f) for p, f in zip(paths, frames)]:
            done.result()
        self.count += len(paths)

    def _finalize(self) -> None:
        self._pool.shutdown()
