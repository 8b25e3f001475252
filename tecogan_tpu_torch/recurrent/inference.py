"""Streaming 4x VSR inference (counterpart of
``tecogan_tpu/recurrent/inference.py``; reference main.py:180-270).

The sequence runs in chunks of ``config.infer_chunk`` frames. Per chunk,
FNet and the flow upsample run once over all T*B (previous, current) pairs;
then a per-frame loop carries the truly recurrent warp + generator. LR
frames may arrive as uint8 and are normalised on the device; HR frames may
leave as uint8, quantised on the device exactly as
``np.clip(img * 255, 0, 255).astype(np.uint8)`` (reference ops.py:520-523).

On CUDA, each chunk runs as one captured CUDA graph (the JAX package's
``jax.jit`` of the chunk's ``lax.scan`` with the state donated,
``tecogan_tpu/recurrent/inference.py:259``): the chunk goes up from pinned
host buffers used in turn into a static LR buffer, the graph replays over
it and the static state, which it updates in place, and its output is
copied to pinned host memory without blocking and read only after the next
chunk has been queued, so the copies and the host's work overlap the
device's. On the CPU the same chunk body runs eagerly. With a spatial mesh
the chunk's frames and state are split by rows over the mesh's devices
(``parallel/spatial.py``); with every shard on one device the sharded
chunk is one captured graph too (the JAX package's ``jax.jit`` of the
sharded chunk, ``tecogan_tpu/parallel/spatial.py:63``), across devices it
runs eagerly (ROADMAP item 11c).

Warm-up protocol: the first 5 outputs belong to reversed frames [5..1]
prepended by :func:`prepend_warmup` and are dropped (reference
dataloader.py:42-44, main.py:262-269).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.recurrent.step import (
    RecurrentState,
    generator_step,
    init_state,
    upscale_flow,
)
from tecogan_tpu_torch.utils.cuda_graphs import (
    CapturedProgram,
    capture_route,
    resolve_capture,
)
from tecogan_tpu_torch.utils.profiling import span

WARMUP_FRAMES = 5  # reference dataloader.py:42-44


def place_model(module: torch.nn.Module, device: torch.device,
                dtype: torch.dtype) -> torch.nn.Module:
    """Move ``module`` to ``device`` and ``dtype`` in place, in eval mode;
    on the card in ``channels_last``, the layout of the NHWC activations
    the convolutions see."""
    memory_format = (torch.channels_last if device.type == "cuda"
                     else torch.preserve_format)
    return module.to(device=device, dtype=dtype, memory_format=memory_format).eval()


def place_models(generator: Generator, fnet: FNet, device: torch.device,
                 dtype: torch.dtype) -> Tuple[Generator, FNet]:
    """:func:`place_model` of both models."""
    return place_model(generator, device, dtype), place_model(fnet, device, dtype)


def prepend_warmup(frames: List) -> List:
    """Prepend reversed frames [5..1] (reference dataloader.py:42-44)."""
    return list(frames[5:0:-1]) + list(frames)


def chunk_pairs(prev_lr: torch.Tensor, lr_chunk: torch.Tensor, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's (T, B, h, w, 3) LR frames in ``dtype`` (uint8 divided by
    255 on the device) and its T*B (previous, current) pairs for FNet,
    the first frame's previous being ``prev_lr`` (B, h, w, 3)."""
    if lr_chunk.dtype == torch.uint8:
        lr_chunk = lr_chunk.float() / 255.0
    lr_chunk = lr_chunk.to(dtype)
    t, b, h, w, c = lr_chunk.shape
    prev = torch.cat([prev_lr[None], lr_chunk[:-1]], dim=0)
    return lr_chunk, torch.cat([prev, lr_chunk], dim=-1).reshape(t * b, h, w, 2 * c)


def as_output(hr: torch.Tensor, output: str) -> torch.Tensor:
    """HR frames in [0, 1] as float32, or as uint8 quantised on the device
    (reference ops.py:520-523)."""
    if output == "uint8":
        return (hr.float() * 255.0).clamp_(0.0, 255.0).to(torch.uint8)
    return hr.float()


def chunk_flows(fnet: FNet, dtype: torch.dtype, prev_lr: torch.Tensor,
                lr_chunk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's frame-parallel prologue: FNet over its T*B (previous,
    current) pairs and K1's x4 flow upsample -> the (T, B, h, w, 3) frames
    in ``dtype`` and their (T, B, 4h, 4w, 2) HR flows."""
    lr_chunk, pairs = chunk_pairs(prev_lr, lr_chunk, dtype)
    t, b, h, w, _ = lr_chunk.shape
    return lr_chunk, upscale_flow(fnet(pairs), h, w).reshape(t, b, 4 * h, 4 * w, 2)


@torch.inference_mode()
def run_frames(generator: Generator, output: str, state: RecurrentState,
               lr_chunk: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """A chunk's recurrence: the per-frame warp + generator over the
    frames and flows of :func:`chunk_flows` -> (T, B, 4h, 4w, 3) HR frames
    (float32 or uint8, per ``output``); the new state is written into
    ``state``'s tensors in place (the JAX package's donated state)."""
    outs, st = [], state
    for i in range(lr_chunk.shape[0]):
        st, hr = generator_step(generator, st, lr_chunk[i], flow[i])
        outs.append(as_output(hr, output))
    for dst, new in zip(state, st):
        dst.copy_(new)
    return torch.stack(outs)


@torch.inference_mode()
def run_chunk(generator: Generator, fnet: FNet, dtype: torch.dtype, output: str,
              state: RecurrentState, lr_chunk: torch.Tensor) -> torch.Tensor:
    """One chunk: (T, B, h, w, 3) LR frames on the device -> (T, B, 4h, 4w,
    3) HR frames (float32 or uint8, per ``output``). The new state is written
    into ``state``'s tensors in place (the JAX package's donated state)."""
    lr_chunk, flow = chunk_flows(fnet, dtype, state.prev_lr, lr_chunk)
    return run_frames(generator, output, state, lr_chunk, flow)


@torch.inference_mode()
def run_chunk_sharded(step: "ShardedStep", dtype: torch.dtype, output: str,
                      states: List[RecurrentState], lr_chunks: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """:func:`run_chunk` over row shards (``parallel/spatial.py``): shard
    i's (T, B, h_i, w, 3) LR rows and state in, its (T, B, 4h_i, 4w, 3) HR
    rows out; the new state is written into ``states`` in place."""
    from tecogan_tpu_torch.parallel.spatial import ShardedState

    lrs, pairs = zip(*(chunk_pairs(s.prev_lr, lr, dtype) for s, lr in zip(states, lr_chunks)))
    t, b, _, w, _ = lrs[0].shape
    h = sum(lr.shape[2] for lr in lrs)
    flows = [f.reshape(t, b, f.shape[1], f.shape[2], 2)
             for f in step.flows(list(pairs), h, w)]
    st = ShardedState([s.prev_lr for s in states], [s.prev_hr for s in states])
    outs: List[List[torch.Tensor]] = [[] for _ in states]
    for i in range(t):
        st, hr = step.generator_step(st, [lr[i] for lr in lrs], [f[i] for f in flows])
        for k, x in enumerate(hr):
            outs[k].append(as_output(x, output))
    for state, new_lr, new_hr in zip(states, st.prev_lr, st.prev_hr):
        state.prev_lr.copy_(new_lr)
        state.prev_hr.copy_(new_hr)
    return [torch.stack(o) for o in outs]


class Staging:
    """The host side of a chunk shape's uploads into its static LR buffers
    (one a row shard), for ``StreamingSR`` and the pipeline
    (``parallel/pipeline.py``): on the card two pinned buffers a device
    buffer, used in turn, so the host fills one while the device may still
    be reading the other's last upload; on the CPU the host writes the
    device buffers themselves."""

    def __init__(self, lrs: List[torch.Tensor]):
        self.lrs = lrs
        self.buffers = ([[torch.zeros(lr.shape, dtype=lr.dtype, pin_memory=True)
                          for lr in lrs] for _ in range(2)]
                        if lrs[0].device.type == "cuda" else [lrs])
        self.read: List[List[torch.cuda.Event]] = [[] for _ in self.buffers]
        self.uploads = 0

    def upload(self, piece: np.ndarray) -> None:
        """Put (n <= chunk, B, h, w, 3) frames, split by rows over the LR
        buffers, into them on each device's current stream, padded by
        repeating the last frame (the extra outputs are discarded)."""
        with span("stream.upload"):
            i = self.uploads % len(self.buffers)
            with span("stream.upload_wait"):
                for event in self.read[i]:
                    event.synchronize()  # the device has read its last upload
            r0, read = 0, []
            for host, lr in zip(self.buffers[i], self.lrs):
                rows = lr.shape[2]
                view = host.numpy()
                view[:len(piece)] = piece[:, :, r0:r0 + rows]
                view[len(piece):] = piece[-1, :, r0:r0 + rows]
                r0 += rows
                if host is not lr:
                    with torch.cuda.device(lr.device):
                        lr.copy_(host, non_blocking=True)
                        read.append(torch.cuda.Event())
                        read[-1].record()
            self.read[i] = read
            self.uploads += 1


def copy_out(hrs: List[torch.Tensor], n: int) -> Tuple[List[torch.Tensor], List]:
    """A chunk's first ``n`` outputs (one tensor a row shard) on their way
    to the host, for :func:`fetch_chunk`: on the card copied into fresh
    pinned memory on each device's current stream without blocking, an
    event each (the next chunk's run overwrites a graph's output); on the
    CPU as they are."""
    with span("stream.copy_out"):
        hosts, done = [x[:n] for x in hrs], []
        for k, x in enumerate(hosts):
            if x.device.type == "cuda":
                hosts[k] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                with torch.cuda.device(x.device):
                    hosts[k].copy_(x, non_blocking=True)
                    done.append(torch.cuda.Event())
                    done[-1].record()
    return hosts, done


class _Chunk:
    """One chunk shape's program: the static device buffers (the LR chunk
    and the recurrent state, one of each per row shard on a spatial mesh),
    their :class:`Staging`, and :func:`run_chunk` (on a spatial mesh
    :func:`run_chunk_sharded`) over them, captured on the card (the graph's
    pool holds its temporaries and its HR output) or eager."""

    def __init__(self, sr: "StreamingSR", chunk: int, batch: int, h: int, w: int,
                 frame_dtype: torch.dtype):
        if sr.step is None:
            rows, devices = [h], [sr.device]
        else:
            rows, devices = sr.step.rows(h), sr.step.devices
        self.lrs = [torch.zeros((chunk, batch, r, w, 3), dtype=frame_dtype, device=d)
                    for r, d in zip(rows, devices)]
        self.states = [init_state(batch, r, w, sr.dtype, d) for r, d in zip(rows, devices)]
        self.lr, self.state = self.lrs[0], self.states[0]
        self.staging = Staging(self.lrs)
        if sr.step is None:
            body = functools.partial(run_chunk, sr.generator, sr.fnet, sr.dtype, sr.output,
                                     self.state, self.lr)
        else:
            body = functools.partial(run_chunk_sharded, sr.step, sr.dtype, sr.output,
                                     self.states, self.lrs)
        if sr.capture:  # the shards, if any, all on one device (sharded_capture)
            self.run = CapturedProgram(
                body, (*self.lrs, *(t for state in self.states for t in state)),
                name=f"StreamingSR chunk {tuple(self.lr.shape)} in {len(self.lrs)} row "
                     f"shard(s)")
        else:
            self.run = body


class StreamingSR:
    """Chunked streaming super-resolver.

    Args:
      config: model/runtime configuration (``compute_dtype``, ``infer_chunk``).
      generator / fnet: the models; they are moved to ``device`` and cast to
        the compute dtype in place (:func:`place_models`).
      output: "float32" (HR in [0, 1]) or "uint8" (quantised on the device).
      device: where to run; the card unless the caller asks for the CPU.
      capture: None (the default) runs each chunk shape as one captured CUDA
        graph on the card (``utils/cuda_graphs.py``; the JAX package's jitted
        chunk with its donated state) and eagerly on the CPU; False runs
        eagerly on the card too; True on the CPU raises.
      spatial_mesh: a :class:`~tecogan_tpu_torch.parallel.Mesh` with a
        ``config.sp_axis`` axis: frames, recurrent state and every
        activation are split by rows over its devices, each layer behind a
        halo exchange (``parallel/spatial.py``; the kernels run on every
        shard). With every shard on one device (``[cuda:0, cuda:0]``)
        ``capture`` acts as above, the whole sharded chunk one graph; with
        shards on distinct devices None runs it eagerly and True raises:
        a graph across cards is ROADMAP item 11c
        (``parallel/spatial.py:sharded_capture``). ``device`` is then the
        first shard's.

    :attr:`route` says which route runs and why, before anything runs.

    Each chunk shape (chunk length, batch, h, w, LR dtype) gets its static
    buffers and its program on first use, kept for later runs; a new shape
    warms up and captures once, inside that run's wall time
    (:attr:`capture_s` sums those seconds). Each run zeroes the state first;
    :attr:`runs` counts them, and a run's spans carry its number
    (``utils/profiling.py:span``, recorded while a profiler runs).
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 output: str = "float32", device="cuda",
                 capture: Optional[bool] = None, spatial_mesh=None):
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be float32|uint8, got {output}")
        self.config = config
        self.output = output
        self.dtype = config.torch_dtype
        self.spatial_mesh = spatial_mesh
        self.step = None
        if spatial_mesh is None:
            self.device = torch.device(device)
            self.capture = resolve_capture(capture, self.device)
            self.route = capture_route(self.capture, self.device)
        else:
            from tecogan_tpu_torch.parallel.mesh import canonical_device
            from tecogan_tpu_torch.parallel.spatial import ShardedStep, sharded_capture

            devices = [canonical_device(d) for d in spatial_mesh.axis_devices(config.sp_axis)]
            self.capture, self.route = sharded_capture(capture, devices)
            self.device = devices[0]
        self.generator, self.fnet = place_models(generator, fnet, self.device,
                                                 self.dtype)
        if spatial_mesh is not None:
            self.step = ShardedStep(self.generator, self.fnet, devices,
                                    max_displacement=4.0 * config.flow_max_velocity)
        self._chunks: Dict[Tuple, _Chunk] = {}
        self.capture_s = 0.0
        self.runs = 0

    def _chunk(self, chunk: int, frames: np.ndarray) -> _Chunk:
        _, batch, h, w, _ = frames.shape
        key = (chunk, batch, h, w, torch.from_numpy(np.zeros(0, frames.dtype)).dtype)
        prog = self._chunks.get(key)
        if prog is None:
            t0 = time.perf_counter()
            prog = self._chunks[key] = _Chunk(self, *key)
            self.capture_s += time.perf_counter() - t0
        return prog

    def _stream(self, frames: np.ndarray, chunk: int,
                deliver: Callable[[np.ndarray, int], None]) -> float:
        """Run (T, B, h, w, 3) frames; ``deliver(hr, start)`` gets each
        chunk's (n, B, 4h, 4w, 3) outputs in order. Returns wall seconds."""
        t0 = time.perf_counter()
        self.runs += 1
        with span("stream.run", item=self.runs, frames=frames.shape[0], chunk=chunk):
            with span("stream.reset"):
                prog = self._chunk(chunk, frames)
                for state in prog.states:  # the zero state (reference main.py:197-199)
                    for t in state:
                        t.zero_()
            pending = None
            for s in range(0, frames.shape[0], chunk):
                piece = frames[s:s + chunk]
                prog.staging.upload(piece)
                hr = prog.run()
                hosts, done = copy_out(hr if isinstance(hr, list) else [hr], len(piece))
                if pending is not None:
                    _deliver(deliver, pending)
                pending = (hosts, done, s)
            if pending is not None:
                _deliver(deliver, pending)
        return time.perf_counter() - t0

    # ------------------------------------------------------------- public
    def run(self, frames: np.ndarray, warmup: int = 0,
            chunk: Optional[int] = None,
            on_chunk: Optional[Callable[[np.ndarray, int], None]] = None,
            ) -> Tuple[Optional[np.ndarray], float]:
        """Super-resolve one sequence.

        Args:
          frames: (T, h, w, 3) LR frames, float32 in [0, 1] or uint8; warm-up
            padding already applied by the caller if desired.
          warmup: number of leading outputs to drop.
          chunk: frames per chunk (default ``config.infer_chunk``).
          on_chunk: optional ``fn(hr_frames, start_index)`` called with each
            chunk as it lands; ``start_index`` counts from 0 including the
            warm-up frames, which are not delivered. With it set, nothing is
            accumulated and the first return value is None.

        Returns:
          ((T - warmup, 4h, 4w, 3) HR frames, float32 in [0, 1] or uint8 per
          ``output``, or None with ``on_chunk``; wall-clock seconds including
          host<->device copies).
        """
        chunk = chunk or self.config.infer_chunk
        outs = []

        def deliver(hr: np.ndarray, start: int) -> None:
            got = hr[:, 0]
            if on_chunk is None:
                outs.append(got)
            elif start + len(got) > warmup:
                on_chunk(got[max(warmup - start, 0):], max(start, warmup))

        elapsed = self._stream(frames[:, None], chunk, deliver)
        if on_chunk is not None:
            return None, elapsed
        return np.concatenate(outs, axis=0)[warmup:], elapsed

    def run_streams(self, frames: np.ndarray, warmup: int = 0,
                    chunk: Optional[int] = None) -> Tuple[np.ndarray, float]:
        """Super-resolve B independent streams together: (B, T, h, w, 3)
        float32 in [0, 1] -> ((B, T - warmup, 4h, 4w, 3), wall seconds)."""
        chunk = chunk or self.config.infer_chunk
        outs = []
        elapsed = self._stream(frames.transpose(1, 0, 2, 3, 4), chunk,
                               lambda hr, start: outs.append(hr))
        hrs = np.concatenate(outs, axis=0).transpose(1, 0, 2, 3, 4)
        return hrs[:, warmup:], elapsed


def fetch_chunk(hosts: List[torch.Tensor], done: List, start: int) -> Tuple[np.ndarray, int]:
    """A pending chunk's outputs as numpy (the row shards joined), after
    its copies (``done``, CUDA events; none on the CPU) have landed."""
    with span("stream.fetch_wait"):
        for event in done:
            event.synchronize()
    if len(hosts) == 1:
        return hosts[0].numpy(), start
    return np.concatenate([h.numpy() for h in hosts], axis=2), start


def _deliver(deliver: Callable[[np.ndarray, int], None], pending: Tuple) -> None:
    """Hand a pending chunk's fetched outputs to the caller."""
    got = fetch_chunk(*pending)
    with span("stream.deliver"):
        deliver(*got)
