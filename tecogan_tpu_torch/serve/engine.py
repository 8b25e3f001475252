"""Multi-stream VSR serving (counterpart of ``tecogan_tpu/serve/engine.py``;
reference main.py:253-270 serves one video per process).

:class:`VSRServer` batches N independent streams into one recurrent step:
a fixed pool of ``max_streams`` slots, each holding one stream's recurrent
state (``prev_lr``/``prev_hr``) on the device. Streams attach and detach at
any time; every tick runs one batched frame step and two masks reconcile
the streams with the fixed batch:

- ``reset``: slots whose stream delivers its first frame restart from the
  zero state (the reference's first-frame convention, main.py:197-199);
- ``active``: slots with no frame this tick keep their state bit for bit
  (the step computes on their stale inputs and the result is not kept).

Both are ``torch.where`` selections on device bool masks, so a tick reads
nothing from the device on the host. The masks and the LR batch go up in
one host-to-device copy each, from pinned host buffers the server keeps,
into device buffers it keeps; the state tensors keep their storage from
tick to tick (the new state is written into them). On the card the tick
is one captured CUDA graph per LR frame dtype over those buffers
(``utils/cuda_graphs.py``; the JAX package's ``jax.jit(server_step,
donate_argnums=(2,))``, ``tecogan_tpu/serve/engine.py:163``), replayed
every tick; its output batch is static, and each tick copies it into its
own pinned host buffer before the next replay can overwrite it (stream
order). On the CPU the same tick runs eagerly.

The frame step is the streaming engine's (recurrent/step.py:frame_step):
the packed warp + space-to-depth route. The JAX package's folded-input
route (``fold_s2d_active``) is TPU tuning and is not ported.

:class:`MultiGeometryServer` buckets streams by LR geometry, one slot pool
each, under a device-memory budget.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.recurrent.inference import as_output, place_models
from tecogan_tpu_torch.recurrent.step import RecurrentState, frame_step, init_state
from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram, resolve_capture
from tecogan_tpu_torch.utils.profiling import span

_FRAME_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


def build_frame_fn(config: TecoConfig, output: str = "uint8"):
    """The single-frame serving body, shared by :class:`VSRServer` and the
    exported artifact (serve/export.py).

    Returns ``fn(generator, fnet, state, lr) -> (state, out)`` where ``lr``
    is (B, h, w, 3) uint8 (divided by 255 on the device, in float32) or
    float in [0, 1], and ``out`` the HR batch (B, 4h, 4w, 3): uint8,
    quantised on the device as ``StreamingSR`` does (reference
    ops.py:520-523), or float32 in [0, 1], per ``output``.
    """
    if output not in ("float32", "uint8"):
        raise ValueError(f"output must be float32|uint8, got {output}")
    dtype = config.torch_dtype

    def frame_fn(generator: Generator, fnet: FNet, state: RecurrentState,
                 lr: torch.Tensor) -> Tuple[RecurrentState, torch.Tensor]:
        if lr.dtype == torch.uint8:
            lr = lr.float() / 255.0
        state, hr = frame_step(generator, fnet, state, lr.to(dtype))
        return state, as_output(hr, output)

    return frame_fn


@torch.inference_mode()
def server_tick(frame_fn, generator: Generator, fnet: FNet, masks: torch.Tensor,
                state: RecurrentState, lr: torch.Tensor) -> torch.Tensor:
    """One batched step on the device LR batch under the device (2, S)
    reset/active masks; the new state is written into ``state``'s tensors
    (the JAX package's donated state). Returns the HR batch."""
    reset = masks[0].view(-1, 1, 1, 1)
    active = masks[1].view(-1, 1, 1, 1)
    base = RecurrentState(*(torch.where(reset, 0.0, s) for s in state))
    stepped, out = frame_fn(generator, fnet, base, lr)
    for dst, new, old in zip(state, stepped, base):
        torch.where(active, new, old, out=dst)
    return out


class HostFrame:
    """One stream's HR frame of a tick whose device-to-host copy may still
    be in flight. ``np.asarray(frame)`` waits for that tick's copy only (a
    CUDA event) and gives the (4h, 4w, 3) frame; it stays valid across
    later ticks (each tick copies into its own pinned buffer) and may be
    read on another thread. ``tick`` numbers the server's tick that made it
    (the item of its ``serve.fetch_wait`` span)."""

    __slots__ = ("_host", "_done", "_slot", "tick")

    def __init__(self, host: torch.Tensor, done: Optional[torch.cuda.Event], slot: int,
                 tick: int):
        self._host, self._done, self._slot, self.tick = host, done, slot, tick

    def __array__(self, dtype=None, copy=None):
        with span("serve.fetch_wait", item=self.tick):
            if self._done is not None:
                self._done.synchronize()
        frame = self._host.numpy()[self._slot]
        if dtype is not None and frame.dtype != dtype:
            return frame.astype(dtype)
        return frame.copy() if copy else frame


class _Staging:
    """The pinned host buffers of one tick's uploads (the LR batch per frame
    dtype and the (2, S) reset/active masks) and the event of their last
    copy, so a buffer is refilled only after the device has read it."""

    def __init__(self, slots: int, device: torch.device):
        self.pinned = device.type == "cuda"
        self.masks = torch.zeros((2, slots), dtype=torch.bool, pin_memory=self.pinned)
        self.lr: Dict[torch.dtype, torch.Tensor] = {}
        self.done: Optional[torch.cuda.Event] = None

    def lr_buffer(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        if dtype not in self.lr:
            self.lr[dtype] = torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)
        return self.lr[dtype]


class VSRServer:
    """Continuous-batching 4x VSR server over a fixed slot pool.

    Args:
      config: model/runtime configuration (``compute_dtype``; geometry-free).
      generator / fnet: the models; moved to ``device`` and the compute
        dtype in place (as ``StreamingSR`` does).
      height / width: LR frame geometry of every stream of this pool.
      max_streams: slot-pool size, the served batch.
      output: "uint8" (quantised on the device, the PNG byte format) or
        "float32".
      mesh: a :class:`~tecogan_tpu_torch.parallel.Mesh` with a
        ``config.dp_axis`` axis: the slot pool is split on that axis
        (``batch_sharding``), ``max_streams / n`` slots a device, each
        device with its own copy of the weights (``replicated``), its
        state, its masks and its (captured) tick; a tick queues every
        device's before it reads any output. Streams take the first
        device's slots first. ``device`` is then the first device.
      device: where to run; the card unless the caller asks for the CPU.
      capture: None (the default) runs the tick as a captured CUDA graph on
        the card, captured by :meth:`prewarm` or the first tick of each LR
        frame dtype, and eagerly on the CPU; False runs eagerly on the card
        too; True on the CPU raises.
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 height: int, width: int, max_streams: int = 4,
                 output: str = "uint8", mesh=None, device="cuda",
                 capture: Optional[bool] = None):
        self.config = config
        self.height, self.width = height, width
        self.max_streams = max_streams
        self.output = output
        self._pools: Optional[List["VSRServer"]] = None
        if mesh is not None:
            self._shard_pool(generator, fnet, mesh, capture)
            return
        self.device = torch.device(device)
        self.capture = resolve_capture(capture, self.device)
        self.dtype = config.torch_dtype
        self.generator, self.fnet = place_models(generator, fnet, self.device, self.dtype)
        self._frame_fn = build_frame_fn(config, output=output)
        self._state = init_state(max_streams, height, width, self.dtype, self.device)
        self._masks = torch.zeros((2, max_streams), dtype=torch.bool, device=self.device)
        self._lr: Dict[torch.dtype, torch.Tensor] = {}  # device LR batch per frame dtype
        self._programs: Dict[torch.dtype, Callable[[], torch.Tensor]] = {}
        # Two sets of host buffers, used in turn: the host fills one while
        # the device may still be reading the other's last upload.
        self._staging = [_Staging(max_streams, self.device) for _ in range(2)]
        self._ticks = 0
        self._capture_s = 0.0
        self._slot_of: Dict[object, int] = {}
        self._fresh: Dict[object, bool] = {}
        self._free = list(range(max_streams - 1, -1, -1))  # pop() -> slot 0 first
        # Serializes ticks: a background prewarm
        # (MultiGeometryServer.prewarm(background=True)) may race a tick.
        self._dispatch_lock = threading.Lock()

    def _shard_pool(self, generator: Generator, fnet: FNet, mesh, capture) -> None:
        """The pool split over ``mesh``'s ``dp_axis``: one single-device
        :class:`VSRServer` of ``max_streams / n`` slots per device."""
        from tecogan_tpu_torch.parallel.mesh import batch_sharding, replicated
        from tecogan_tpu_torch.parallel.spatial import replicate

        axis = self.config.dp_axis
        slots = batch_sharding(mesh, axis)
        devices = slots.devices
        if self.max_streams % len(devices):
            raise ValueError(f"max_streams={self.max_streams} must divide evenly across the "
                             f"{len(devices)}-device '{axis}' axis")
        bounds = slots.bounds(self.max_streams)
        self.device = devices[0]
        self.dtype = self.config.torch_dtype
        place_models(generator, fnet, self.device, self.dtype)
        every = replicated(mesh).devices  # a copy of the weights on each
        copies = dict(zip(every, zip(replicate(generator, every), replicate(fnet, every))))
        self._pools = [VSRServer(self.config, *copies[d], self.height, self.width,
                                 max_streams=b - a, output=self.output, device=d,
                                 capture=capture)
                       for d, (a, b) in zip(devices, bounds)]
        self.capture = self._pools[0].capture
        self.generator, self.fnet = generator, fnet
        self._slot_of: Dict[object, int] = {}

    def _lr_batch(self, dtype: torch.dtype) -> torch.Tensor:
        if dtype not in self._lr:
            self._lr[dtype] = torch.zeros((self.max_streams, self.height, self.width, 3),
                                          dtype=dtype, device=self.device)
        return self._lr[dtype]

    def _program(self, dtype: torch.dtype) -> Callable[[], torch.Tensor]:
        """The tick over the static LR batch of ``dtype``: on first use
        captured (its warm-up tick runs with every slot inactive, so it
        keeps every state bit for bit) or, eager, the tick itself. Caller
        holds ``_dispatch_lock``."""
        tick = self._programs.get(dtype)
        if tick is None:
            lr = self._lr_batch(dtype)
            body = functools.partial(server_tick, self._frame_fn, self.generator, self.fnet,
                                     self._masks, self._state, lr)
            if self.capture:
                self._masks.zero_()
                t0 = time.perf_counter()
                tick = CapturedProgram(body, (lr, self._masks, *self._state),
                                       name=f"VSRServer tick {tuple(lr.shape)} {dtype}")
                self._capture_s += time.perf_counter() - t0
            else:
                tick = body
            self._programs[dtype] = tick
        return tick

    def prewarm(self, frame_dtype=np.uint8) -> None:
        """Capture the tick for ``frame_dtype`` (uint8 is the serving feed)
        and run one all-inactive tick before the first stream's: the
        capture's warm-up loads the kernel library (building it on first
        use) and settles cuDNN's choices for this geometry, so no stream's
        tick pays for them. Every slot's state stays bit for bit (``active``
        all False), so it is safe at any point in the server's life."""
        if self._pools is not None:
            for pool in self._pools:
                pool.prewarm(frame_dtype)
            return
        on_cuda = self.device.type == "cuda"
        # A background thread starts on CUDA device 0: name the server's.
        with self._dispatch_lock, (torch.cuda.device(self.device) if on_cuda
                                   else contextlib.nullcontext()):
            tick = self._program(_FRAME_DTYPES[np.dtype(frame_dtype)])
            self._masks.zero_()
            tick()
            if on_cuda:
                torch.cuda.synchronize()

    @property
    def capture_s(self) -> float:
        """Seconds the captured ticks took to warm up and capture (every
        device's, with a mesh), as ``StreamingSR.capture_s`` counts them."""
        if self._pools is not None:
            return sum(pool.capture_s for pool in self._pools)
        return self._capture_s

    def graph_pool_bytes(self) -> int:
        """Device bytes held by the captured ticks' memory pools (their
        temporaries and output batches); 0 when the ticks run eagerly."""
        if self._pools is not None:  # every device's pools
            return sum(pool.graph_pool_bytes() for pool in self._pools)
        ticks = list(self._programs.values())  # one read: a prewarm may add one meanwhile
        return sum(t.pool_bytes() for t in ticks if isinstance(t, CapturedProgram))

    def release(self) -> None:
        """Free the captured ticks' graphs and memory pools (a bucket that a
        :class:`MultiGeometryServer` evicts); a later tick captures anew."""
        if self._pools is not None:
            for pool in self._pools:
                pool.release()
            return
        with self._dispatch_lock:
            for tick in self._programs.values():
                if isinstance(tick, CapturedProgram):
                    tick.close()
            self._programs.clear()

    # ------------------------------------------------------------ lifecycle
    def open(self, stream_id) -> int:
        """Attach a stream; returns its slot. Raises when the pool is full
        (admission control is the caller's policy: queue or shed)."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id!r} already open")
        if self._pools is not None:
            first = 0
            for pool in self._pools:
                if len(pool.open_streams) < pool.max_streams:
                    slot = self._slot_of[stream_id] = first + pool.open(stream_id)
                    return slot
                first += pool.max_streams
            raise RuntimeError(f"no free slots (max_streams={self.max_streams})")
        if not self._free:
            raise RuntimeError(f"no free slots (max_streams={self.max_streams})")
        slot = self._free.pop()
        self._slot_of[stream_id] = slot
        self._fresh[stream_id] = True
        return slot

    def close(self, stream_id) -> None:
        """Detach a stream and free its slot (its state is reset on reuse)."""
        if self._pools is not None:
            self._pool_of(stream_id).close(stream_id)
            self._slot_of.pop(stream_id)
            return
        slot = self._slot_of.pop(stream_id)
        self._fresh.pop(stream_id, None)
        self._free.append(slot)

    @property
    def open_streams(self):
        return tuple(self._slot_of)

    def _pool_of(self, stream_id) -> "VSRServer":
        for pool in self._pools:
            if stream_id in pool._slot_of:
                return pool
        raise KeyError(f"streams not open: [{stream_id!r}]")

    # ------------------------------------------------------------- serving
    def step(self, frames: Mapping[object, np.ndarray], fetch: bool = True
             ) -> Dict[object, np.ndarray]:
        """Advance every stream that delivered a frame by one step.

        Args:
          frames: {stream_id: (h, w, 3) LR frame}, uint8 or float32 in
            [0, 1] (all the same dtype). Streams must be ``open``; streams
            omitted this tick keep their state untouched.
          fetch: True returns numpy arrays (the tick's output copied to the
            host and waited for). False returns per-stream :class:`HostFrame`
            objects at once; ``np.asarray`` of one waits for this tick's
            copy only, so a writer thread can read it while the next tick
            computes. They stay valid across later ticks.

        Returns:
          {stream_id: (4h, 4w, 3) HR frame} per ``output`` dtype.
        """
        if not frames:
            return {}
        ids = list(frames)
        missing = [s for s in ids if s not in self._slot_of]
        if missing:
            raise KeyError(f"streams not open: {missing}")
        if self._pools is not None:
            # Queue every device's tick before reading any output.
            parts = [pool.step({sid: frames[sid] for sid in ids if sid in pool._slot_of},
                               fetch=False) for pool in self._pools]
            out = {sid: hr for part in parts for sid, hr in part.items()}
            return {sid: np.asarray(h) for sid, h in out.items()} if fetch else out
        first = np.asarray(frames[ids[0]])
        if first.dtype not in _FRAME_DTYPES:
            raise ValueError(
                f"frames must be uint8 or float32 in [0, 1], got "
                f"{first.dtype} (cast float inputs to float32)")
        dtype = _FRAME_DTYPES[first.dtype]
        with self._dispatch_lock, span("serve.step", item=self._ticks, frames=len(ids),
                                       slots=self.max_streams):
            tick = self._program(dtype)  # before the uploads: a capture zeroes the masks
            staging = self._staging[self._ticks % len(self._staging)]
            if staging.done is not None:
                with span("serve.stage_wait"):
                    staging.done.synchronize()  # its last upload has been read
            with span("serve.stage"):
                lr_host = staging.lr_buffer((self.max_streams, self.height, self.width, 3),
                                            dtype)
                lr_np, masks_np = lr_host.numpy(), staging.masks.numpy()
                masks_np[:] = False
                for sid in ids:
                    slot = self._slot_of[sid]
                    frame = np.asarray(frames[sid])
                    if frame.shape != (self.height, self.width, 3):
                        raise ValueError(
                            f"stream {sid!r}: frame shape {frame.shape} != "
                            f"({self.height}, {self.width}, 3)")
                    if frame.dtype != first.dtype:
                        raise ValueError("mixed frame dtypes in one tick")
                    lr_np[slot] = frame
                    masks_np[1, slot] = True
                    masks_np[0, slot] = self._fresh[sid]
            with span("serve.upload"):
                lr = self._lr_batch(dtype)
                lr.copy_(lr_host, non_blocking=True)
                self._masks.copy_(staging.masks, non_blocking=True)
                if self.device.type == "cuda":
                    staging.done = torch.cuda.Event()
                    staging.done.record()
            out = tick()
            with span("serve.copy_out"):
                host, done = out, None  # on the CPU, the eager tick's own new tensor
                if self.device.type == "cuda":  # the next replay overwrites out
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
            tick_id = self._ticks
            self._ticks += 1
        for sid in ids:
            self._fresh[sid] = False
        handles = {sid: HostFrame(host, done, self._slot_of[sid], tick_id) for sid in ids}
        if fetch:
            return {sid: np.asarray(h) for sid, h in handles.items()}
        return handles


class MultiGeometryServer:
    """Continuous batching across streams of several LR geometries.

    A slot pool holds one geometry, and a serving endpoint receives 144x180
    and 540x960 streams alike, so streams are bucketed by their LR
    ``(height, width)``: each geometry gets its own :class:`VSRServer`
    pool, created on demand, and one :meth:`step` fans a tick's frames out
    to the buckets that received any. All buckets share the models and the
    config; per-stream semantics are :class:`VSRServer`'s.

    Every bucket's tick is queued before any output is read, so one
    bucket's download overlaps the next bucket's compute.

    Args:
      slots_per_geometry: slot-pool size of each bucket.
      state_budget_mb: cap on the device bytes the buckets pin: each
        resident bucket's recurrent state plus one tick's LR input and HR
        output (:meth:`bucket_bytes`) and its captured ticks' graph pool
        (:meth:`VSRServer.graph_pool_bytes`), and for the bucket being
        admitted :meth:`bucket_bytes` plus :meth:`pool_estimate`. A new
        geometry first evicts idle buckets (no open stream), least
        recently used first; if it still does not fit, ``open`` raises
        RuntimeError with the computed numbers instead of running the card
        out of memory. ``None`` disables the guard.
      mesh: each bucket's :class:`VSRServer` ``mesh`` (its slots split on
        the ``dp_axis``); the budget is then per device, as in the JAX
        package: :meth:`bucket_bytes` divided by the axis size, and every
        device's graph pools summed and divided likewise.
      device: where to run; the card unless the caller asks for the CPU
        (with a mesh, the mesh's first device).
      capture: each bucket's :class:`VSRServer` ``capture``.
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 slots_per_geometry: int = 4, output: str = "uint8",
                 mesh=None, state_budget_mb: Optional[float] = 2048.0,
                 device="cuda", capture: Optional[bool] = None):
        self.config = config
        self.mesh = mesh
        self._devices = 1
        if mesh is not None:
            devices = mesh.axis_devices(config.dp_axis)
            self._devices, device = len(devices), devices[0]
        self.device = torch.device(device)
        self.capture = resolve_capture(capture, self.device)
        self.generator, self.fnet = place_models(generator, fnet, self.device,
                                                 config.torch_dtype)
        self.slots_per_geometry = slots_per_geometry
        self.output = output
        self.state_budget_mb = state_budget_mb
        self._buckets: Dict[Tuple[int, int], VSRServer] = {}
        self._geo_of: Dict[object, Tuple[int, int]] = {}
        self._bucket_lock = threading.Lock()
        self._use_clock = 0  # LRU ordinal for idle-bucket eviction
        self._last_use: Dict[Tuple[int, int], int] = {}

    def bucket_bytes(self, height: int, width: int) -> int:
        """Device bytes one (height, width) bucket pins while it exists: the
        slot pool's recurrent state (prev_lr (h, w, 3) + prev_hr (4h, 4w, 3)
        = 51·h·w·itemsize a slot) plus one tick's LR input and HR output:
        the JAX package's formula, whose budget errors the tests hold the
        port to. A captured bucket also holds its tick's temporaries in the
        graph's memory pool (:meth:`VSRServer.graph_pool_bytes`), which the
        budget adds (:attr:`footprint_bytes`, :meth:`pool_estimate`); an
        eager tick's temporaries go back to PyTorch's allocator from tick
        to tick. With a mesh, each device's share: divided by the
        ``dp_axis`` size."""
        hw = int(height) * int(width)
        item = self.config.torch_dtype.itemsize
        state = 51 * hw * item
        out_item = 1 if self.output == "uint8" else 4
        tick_io = 3 * hw * 1 + 48 * hw * out_item  # uint8 LR in, HR out
        return self.slots_per_geometry * (state + tick_io) // self._devices

    def _pool_share(self, srv: VSRServer) -> int:
        """A bucket's captured graph pools (every device's), per device."""
        return srv.graph_pool_bytes() // self._devices

    def pool_estimate(self, height: int, width: int) -> int:
        """The graph pool a new (height, width) bucket is expected to hold
        once its tick is captured: the largest resident bucket's measured
        pool, scaled by slots x height x width (every bucket has
        ``slots_per_geometry`` slots, so by the pixels). 0 while no resident
        bucket has captured a tick (eager, on the CPU, or the first bucket:
        it is admitted on :meth:`bucket_bytes`, and its pool counts from its
        capture on)."""
        pool, geo = max(((self._pool_share(srv), g) for g, srv in self._buckets.items()),
                        default=(0, None))
        if pool == 0:
            return 0
        return -(-pool * int(height) * int(width) // (geo[0] * geo[1]))

    def _resident_bytes(self, geo: Tuple[int, int]) -> int:
        return self.bucket_bytes(*geo) + self._pool_share(self._buckets[geo])

    @property
    def footprint_bytes(self) -> int:
        """Device bytes the buckets pin: :meth:`bucket_bytes` and the
        captured graph pool of each."""
        return sum(self._resident_bytes(geo) for geo in self._buckets)

    def _bucket(self, geo: Tuple[int, int]) -> VSRServer:
        with self._bucket_lock:
            srv = self._buckets.get(geo)
            if srv is None:
                self._admit_locked(geo)
                srv = self._buckets[geo] = VSRServer(
                    self.config, self.generator, self.fnet, geo[0], geo[1],
                    max_streams=self.slots_per_geometry, output=self.output,
                    mesh=self.mesh, device=self.device, capture=self.capture)
            self._use_clock += 1
            self._last_use[geo] = self._use_clock
        return srv

    def _admit_locked(self, geo: Tuple[int, int]) -> None:
        """Fit a new geometry under ``state_budget_mb``: evict idle buckets
        LRU-first, refuse with the computed bytes if that is not enough.
        Caller holds ``_bucket_lock``."""
        if self.state_budget_mb is None:
            return
        budget = int(self.state_budget_mb * 2**20)
        need = self.bucket_bytes(*geo) + self.pool_estimate(*geo)
        if need > budget:
            raise RuntimeError(
                f"geometry {geo} alone needs ~{need / 2**20:.1f} MB of "
                f"device state ({self.slots_per_geometry} slots) — over the "
                f"{self.state_budget_mb:.0f} MB state_budget_mb; lower "
                f"slots_per_geometry or raise the budget")
        idle = sorted(
            (g for g, srv in self._buckets.items() if not srv.open_streams),
            key=lambda g: self._last_use.get(g, 0))
        while self.footprint_bytes + need > budget and idle:
            g = idle.pop(0)
            self._buckets.pop(g).release()  # its graph's pool; its tensors go with it
            self._last_use.pop(g, None)
        if self.footprint_bytes + need > budget:
            busy = {g: f"{self._resident_bytes(g) / 2**20:.1f} MB"
                    for g in self._buckets}
            raise RuntimeError(
                f"opening geometry {geo} (~{need / 2**20:.1f} MB) would put "
                f"the server at "
                f"{(self.footprint_bytes + need) / 2**20:.1f} MB resident "
                f"state, over state_budget_mb={self.state_budget_mb:.0f} and "
                f"every remaining bucket has open streams: {busy}. Close "
                f"streams, lower slots_per_geometry, or raise the budget.")

    def prewarm(self, geometries: Iterable[Tuple[int, int]],
                frame_dtype=np.uint8, background: bool = False
                ) -> Optional[threading.Thread]:
        """Create each ``(height, width)`` bucket and run its all-inactive
        warm tick (:meth:`VSRServer.prewarm`), so no stream's first tick
        pays for the kernel library's load or cuDNN's first choices.

        ``background=True`` returns a started daemon thread that warms the
        menu while the other buckets keep serving (each bucket's dispatch
        lock serializes its own ticks); join it to wait. In the foreground
        it returns None when done.
        """
        geos = [(int(h), int(w)) for h, w in geometries]

        def work():
            for geo in geos:
                self._bucket(geo).prewarm(frame_dtype)

        if background:
            t = threading.Thread(target=work, daemon=True, name="tecogan-serve-prewarm")
            t.start()
            return t
        work()
        return None

    # ------------------------------------------------------------ lifecycle
    def open(self, stream_id, height: int, width: int) -> int:
        """Attach a stream of LR geometry (height, width); returns its slot
        within the geometry's bucket. Raises RuntimeError when that bucket
        is full (admission control is the caller's policy)."""
        if stream_id in self._geo_of:
            raise ValueError(f"stream {stream_id!r} already open")
        geo = (int(height), int(width))
        slot = self._bucket(geo).open(stream_id)
        self._geo_of[stream_id] = geo
        return slot

    def close(self, stream_id) -> None:
        geo = self._geo_of.pop(stream_id)
        self._buckets[geo].close(stream_id)

    def free_slots(self, height: int, width: int) -> int:
        """Free slots in the (height, width) bucket; the full pool size when
        the bucket does not exist yet."""
        srv = self._buckets.get((int(height), int(width)))
        if srv is None:
            return self.slots_per_geometry
        return self.slots_per_geometry - len(srv.open_streams)

    @property
    def open_streams(self):
        return tuple(self._geo_of)

    @property
    def geometries(self):
        """The buckets as {(height, width): (open, capacity)}."""
        return {geo: (len(srv.open_streams), self.slots_per_geometry)
                for geo, srv in self._buckets.items()}

    # ------------------------------------------------------------- serving
    def step(self, frames: Mapping[object, np.ndarray], fetch: bool = True
             ) -> Dict[object, np.ndarray]:
        """Advance every stream that delivered a frame (any mix of
        geometries) by one step; the contract of :meth:`VSRServer.step`."""
        if not frames:
            return {}
        by_geo: Dict[Tuple[int, int], Dict[object, np.ndarray]] = {}
        for sid, frame in frames.items():
            geo = self._geo_of.get(sid)
            if geo is None:
                raise KeyError(f"streams not open: [{sid!r}]")
            by_geo.setdefault(geo, {})[sid] = frame
        with self._bucket_lock:
            self._use_clock += 1
            for geo in by_geo:
                self._last_use[geo] = self._use_clock
        # Queue every bucket's tick before reading any output.
        parts: List[Dict[object, HostFrame]] = [
            self._buckets[geo].step(fs, fetch=False) for geo, fs in by_geo.items()]
        out: Dict[object, np.ndarray] = {}
        for part in parts:
            for sid, hr in part.items():
                out[sid] = np.asarray(hr) if fetch else hr
        return out
