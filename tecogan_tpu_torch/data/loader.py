"""Training data loader: scene discovery, per-sequence augmentation, threaded
decode, prefetch (counterpart of ``tecogan_tpu/data/loader.py``).

Functional parity with reference lib/dataloader.py:170-348 (``loadHR`` +
``frvsr_gpu_data_loader``):

- scenes ``<dir>/<prefix>_%04d`` for indices [str_dir, end_dir], skipping
  folders missing frame ``max_frm`` (dataloader.py:183-188)
- every length-``rnn_n`` window of every scene is one example
  (dataloader.py:189-191)
- per-sequence augmentations (dataloader.py:207-261):
  * movingFirstFrame (p=0.3): synthesize a camera pan from the static first
    frame — per-frame integer offsets ``floor(U(-3.5, 4.5))``, exclusive
    cumsum trajectory
  * random crop to ``hr_load_size`` (= 4*crop + gaussian margin)
  * random left-right flip (p=0.5)
- shuffled batches; a validation split uses scene indices
  [end_dir+1, end_dir_val] (dataloader.py:290-297)

The HR->LR Gaussian runs on the device inside the train step, so only the
HR crops cross to the device. The augmentation decisions (:class:`SeqPlan`)
draw from the RNG in the JAX loader's order, so a seed gives the same
windows, crops and flips under either executor: ``"python"`` decodes with
``data/png.py`` (the GPU machine has no OpenCV) and crops in numpy on host
threads; ``"native"`` runs the plans through the C++ thread pool of
``data/native_loader.py`` (``csrc/tecodata.cpp``) with its byte-budgeted
frame cache, off the interpreter lock; ``"auto"`` (the training loop's)
takes the native one and falls back to python only where the library
cannot be built or loaded.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.native_loader import (
    UNAVAILABLE_ERRORS,
    NativeExecutor,
    unavailable_detail,
)
from tecogan_tpu_torch.data.png import read_png
from tecogan_tpu_torch.utils.profiling import span


def png_dims(path: str) -> Tuple[int, int]:
    """(height, width) from the PNG IHDR without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


class SeqPlan(NamedTuple):
    """A fully-decided sequence load: frame files + per-frame crop + flip.

    Decouples the augmentation *decisions* (RNG) from their *execution*.
    """

    paths: List[str]           # rnn_n entries (repeats for movingFirstFrame)
    oy: np.ndarray             # (rnn_n,) int32 crop top offsets
    ox: np.ndarray             # (rnn_n,) int32 crop left offsets
    flip: bool


class _FrameLRU:
    """Thread-safe byte-budgeted LRU of decoded uint8 frames (see
    ``loader_cache_mb``)."""

    def __init__(self, budget_mb: int):
        from collections import OrderedDict

        self.budget = max(0, budget_mb) << 20
        self.used = 0
        self._map: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str) -> Optional[np.ndarray]:
        with self._lock:
            img = self._map.get(path)
            if img is not None:
                self._map.move_to_end(path)
            return img

    def put(self, path: str, img: np.ndarray) -> None:
        with self._lock:
            if path in self._map:
                return
            self._map[path] = img
            self.used += img.nbytes + len(path) + 128
            while self.used > self.budget and self._map:
                victim, vimg = self._map.popitem(last=False)
                self.used -= vimg.nbytes + len(victim) + 128


class SceneDataset:
    """Enumerates (scene, start_frame) windows and materializes augmented
    HR sequences."""

    def __init__(self, config: TecoConfig, validation: bool = False):
        self.config = config
        self.frame_cache: Optional[_FrameLRU] = None  # set by BatchLoader
        lo = config.end_dir + 1 if validation else config.str_dir
        hi = config.end_dir_val if validation else config.end_dir
        self.scenes: List[str] = []
        for i in range(lo, hi + 1):
            d = os.path.join(
                config.input_video_dir, f"{config.input_video_pre}_{i:04d}"
            )
            if os.path.exists(d):
                if not os.path.exists(
                    os.path.join(d, f"col_high_{config.max_frm:04d}.png")
                ):
                    # reference dataloader.py:186-188
                    print(f"Skip {d}: not enough frames")
                    continue
                self.scenes.append(d)
        if not self.scenes:
            raise FileNotFoundError(
                f"No usable scenes under {config.input_video_dir} "
                f"[{lo}, {hi}]"
            )
        self.windows_per_scene = config.max_frm - config.rnn_n + 1
        self.num_examples = len(self.scenes) * self.windows_per_scene
        self._dims_cache: dict = {}

    def __len__(self):
        return self.num_examples

    # ----------------------------------------------------------- planning
    def _frame_path(self, scene: str, fi: int) -> str:
        return os.path.join(scene, f"col_high_{fi:04d}.png")

    def _scene_dims(self, scene: str) -> Tuple[int, int]:
        dims = self._dims_cache.get(scene)
        if dims is None:
            dims = png_dims(self._frame_path(scene, 0))
            self._dims_cache[scene] = dims
        return dims

    def plan_sequence(self, index: int, rng: np.random.RandomState) -> SeqPlan:
        """Decide one window's files/crops/flip; RNG draw order matches the
        reference augmentation graph (dataloader.py:207-261)."""
        cfg = self.config
        scene = self.scenes[index // self.windows_per_scene]
        start = index % self.windows_per_scene
        tar = cfg.hr_load_size
        h, w = self._scene_dims(scene)

        moving = (
            cfg.moving_first_frame
            and rng.rand() >= (1.0 - cfg.moving_first_frame_prob)
        )
        if moving:
            # Synthetic camera pan from the static first frame
            # (reference dataloader.py:207-228).
            offsets = np.floor(rng.uniform(-3.5, 4.5, size=(cfg.rnn_n, 2))).astype(
                np.int64
            )
            pos = np.cumsum(offsets, axis=0) - offsets  # exclusive cumsum
            mn = pos.min(axis=0)
            rg = pos.max(axis=0) - mn  # [range_x, range_y] in (x, y) order
            lefttop = pos - mn
            # Random crop of the shrunken valid region.
            max_oh = h - tar - rg[1]
            max_ow = w - tar - rg[0]
            if max_oh <= 0 or max_ow <= 0:
                raise ValueError(
                    f"Scene {scene} too small for crop {tar} + pan margin"
                )
            oh = int(rng.uniform(0, max_oh))
            ow = int(rng.uniform(0, max_ow))
            paths = [self._frame_path(scene, start)] * cfg.rnn_n
            oy = (oh + lefttop[:, 1]).astype(np.int32)
            ox = (ow + lefttop[:, 0]).astype(np.int32)
        else:
            if h < tar or w < tar:
                raise ValueError(f"Scene {scene} smaller than crop {tar}")
            oh = int(rng.uniform(0, h - tar)) if cfg.random_crop else 0
            ow = int(rng.uniform(0, w - tar)) if cfg.random_crop else 0
            paths = [self._frame_path(scene, start + fi) for fi in range(cfg.rnn_n)]
            oy = np.full(cfg.rnn_n, oh, np.int32)
            ox = np.full(cfg.rnn_n, ow, np.int32)

        flip = bool(cfg.flip and rng.rand() < 0.5)  # reference ops.py:230-235
        return SeqPlan(paths=paths, oy=oy, ox=ox, flip=flip)

    # ----------------------------------------------------------- sampling
    def _read_u8(self, path: str) -> np.ndarray:
        """Decode one frame to uint8 RGB, through the shared LRU if set. As
        ``cv2.imread(path, 3)``: gray is repeated to three channels and
        alpha dropped. Cropping before the /255 conversion is bit-identical
        to converting the full image first (pure elementwise)."""
        if self.frame_cache is not None:
            img = self.frame_cache.get(path)
            if img is not None:
                return img
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        img = read_png(path)
        img = np.ascontiguousarray(
            np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img[:, :, :3])
        if self.frame_cache is not None:
            self.frame_cache.put(path, img)
        return img

    def load_plan(self, plan: SeqPlan, as_uint8: bool = False) -> np.ndarray:
        """Execute a plan -> (rnn_n, tar, tar, 3) float32 [0,1], or
        raw uint8 with ``as_uint8`` (cheap-upload path; device-side /255)."""
        tar = self.config.hr_load_size
        frames = []
        cache_path, cache_img = None, None
        for p, oy, ox in zip(plan.paths, plan.oy, plan.ox):
            if p != cache_path:
                cache_img = self._read_u8(p)
                cache_path = p
            crop = cache_img[oy : oy + tar, ox : ox + tar]
            frames.append(
                crop if as_uint8 else crop.astype(np.float32) / 255.0)
        seq = np.stack(frames)
        if plan.flip:
            seq = seq[:, :, ::-1]
        return np.ascontiguousarray(seq)

    def load_sequence(self, index: int, rng: np.random.RandomState,
                      as_uint8: bool = False) -> np.ndarray:
        """Load + augment one window -> (rnn_n, tar, tar, 3)."""
        return self.load_plan(self.plan_sequence(index, rng), as_uint8)


class BatchLoader:
    """Threaded shuffling batch producer with bounded prefetch."""

    def __init__(
        self,
        dataset: SceneDataset,
        batch_size: Optional[int] = None,
        seed: Optional[int] = None,
        num_threads: Optional[int] = None,
        prefetch: Optional[int] = None,
        executor: str = "python",
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """``executor``: ``"python"``, ``"native"`` (raises where the C++
        library cannot be built or loaded) or ``"auto"`` (falls back to
        python then, printing the cause); :attr:`executor_used` says which
        runs. ``shard_id``/``num_shards``: data-parallel sharding, one shard
        per process (``parallel/dp.py``): shard ``i`` samples the stride
        ``indices[i::num_shards]`` of the example index space with its own
        stream ``RandomState(seed + i)``, as the JAX loader does, and
        produces that process's piece of the global batch."""
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} is not in [0, {num_shards})")
        cfg = dataset.config
        self.dataset = dataset
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.batch_size = batch_size or cfg.batch_size
        self.seed = cfg.rand_seed if seed is None else seed
        self.num_threads = num_threads or max(1, cfg.queue_thread)
        self.prefetch = prefetch or cfg.prefetch_depth
        if executor not in ("python", "native", "auto"):
            raise ValueError(f"executor must be python|native|auto, got {executor}")
        self._native: Optional[NativeExecutor] = None
        if executor in ("native", "auto"):
            # Only build/load failures fall back (no compiler, no zlib); a
            # fault in the native path must not silently degrade to python.
            try:
                self._native = NativeExecutor(num_threads=self.num_threads, rnn_n=cfg.rnn_n,
                                              tar=cfg.hr_load_size,
                                              cache_mb=cfg.loader_cache_mb)
            except UNAVAILABLE_ERRORS as exc:
                if executor == "native":
                    raise
                print("BatchLoader: native decoder unavailable "
                      f"({type(exc).__name__}: {unavailable_detail(exc)}); "
                      "using the python executor (slower)")
        self.executor_used = "python" if self._native is None else "native"
        # Emit raw uint8 batches (4x less host->device traffic; the train
        # step normalizes on the device, trainer.py:prepare_batch).
        self.as_uint8 = bool(cfg.train_upload_uint8)
        if self._native is None and cfg.loader_cache_mb > 0:
            # The python executor's analog of the C++ frame cache, shared
            # across the decode pool; batches stay bit-identical.
            dataset.frame_cache = _FrameLRU(cfg.loader_cache_mb)
        # Each batch with its production milliseconds (plan and decode).
        self._queue: "queue.Queue[Tuple[np.ndarray, float]]" = queue.Queue(
            maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._producer_exc: Optional[BaseException] = None

    # --------------------------------------------------------------- iter
    def _producer(self):
        rng = np.random.RandomState(self.seed + self.shard_id)
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        indices = np.arange(len(self.dataset))[self.shard_id::self.num_shards]
        n = len(indices)
        perm = indices[rng.permutation(n)]
        cursor = 0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter_ns()
                idxs = []
                for _ in range(self.batch_size):
                    if cursor >= n:
                        perm = indices[rng.permutation(n)]
                        cursor = 0
                    idxs.append(int(perm[cursor]))
                    cursor += 1
                seeds = rng.randint(0, 2**31 - 1, size=len(idxs))
                if self._native is not None:
                    plans = [self.dataset.plan_sequence(i, np.random.RandomState(s))
                             for i, s in zip(idxs, seeds)]
                    batch = self._native.load(plans, as_uint8=self.as_uint8)
                else:
                    futures = [
                        pool.submit(
                            self.dataset.load_sequence, i,
                            np.random.RandomState(s), self.as_uint8
                        )
                        for i, s in zip(idxs, seeds)
                    ]
                    batch = np.stack([f.result() for f in futures])
                made = (batch, (time.perf_counter_ns() - t0) / 1e6)
                while not self._stop.is_set():
                    try:
                        self._queue.put(made, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer:
            # a producer that dies silently leaves next_batch() blocked on
            # the queue forever (c7d1830); next_batch() re-raises it.
            self._producer_exc = e
        finally:
            pool.shutdown(wait=False)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        return self

    def next_batch(self) -> np.ndarray:
        """(B, rnn_n, tar, tar, 3) — float32 in [0, 1], or raw uint8 when
        ``config.train_upload_uint8`` (the train step normalizes on device).
        Its span ``loader.wait`` records the queue's depth on entry and the
        batch's production milliseconds (``produce_ms``): the producer
        thread is not profiled, so it stamps every batch."""
        if self._thread is None:
            self.start()
        with span("loader.wait", depth=self._queue.qsize()) as waited:
            while True:
                try:
                    batch, produce_ms = self._queue.get(timeout=0.5)
                    break
                except queue.Empty:
                    if self._producer_exc is not None:
                        raise RuntimeError(
                            "data producer thread died"
                        ) from self._producer_exc
                    if self._thread is not None and not self._thread.is_alive():
                        raise RuntimeError("data producer thread exited "
                                           "without an exception")
            waited.set(produce_ms=produce_ms)
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # Drain so the producer can observe the stop flag.
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
