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
device's. On the CPU the same chunk body runs eagerly.

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
from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram, resolve_capture

WARMUP_FRAMES = 5  # reference dataloader.py:42-44


def place_models(generator: Generator, fnet: FNet, device: torch.device,
                 dtype: torch.dtype) -> Tuple[Generator, FNet]:
    """Move the models to ``device`` and ``dtype`` in place, in eval mode;
    on the card in ``channels_last``, the layout of the NHWC activations
    the convolutions see."""
    memory_format = (torch.channels_last if device.type == "cuda"
                     else torch.preserve_format)
    return tuple(m.to(device=device, dtype=dtype, memory_format=memory_format).eval()
                 for m in (generator, fnet))


def prepend_warmup(frames: List) -> List:
    """Prepend reversed frames [5..1] (reference dataloader.py:42-44)."""
    return list(frames[5:0:-1]) + list(frames)


@torch.inference_mode()
def run_chunk(generator: Generator, fnet: FNet, dtype: torch.dtype, output: str,
              state: RecurrentState, lr_chunk: torch.Tensor) -> torch.Tensor:
    """One chunk: (T, B, h, w, 3) LR frames on the device -> (T, B, 4h, 4w,
    3) HR frames (float32 or uint8, per ``output``). The new state is written
    into ``state``'s tensors in place (the JAX package's donated state)."""
    if lr_chunk.dtype == torch.uint8:
        lr_chunk = lr_chunk.float() / 255.0
    lr_chunk = lr_chunk.to(dtype)
    t, b, h, w, c = lr_chunk.shape
    prev = torch.cat([state.prev_lr[None], lr_chunk[:-1]], dim=0)
    pairs = torch.cat([prev, lr_chunk], dim=-1).reshape(t * b, h, w, 2 * c)
    flow = upscale_flow(fnet(pairs), h, w).reshape(t, b, 4 * h, 4 * w, 2)
    outs, st = [], state
    for i in range(t):
        st, hr = generator_step(generator, st, lr_chunk[i], flow[i])
        if output == "uint8":
            outs.append((hr.float() * 255.0).clamp_(0.0, 255.0).to(torch.uint8))
        else:
            outs.append(hr.float())
    for dst, new in zip(state, st):
        dst.copy_(new)
    return torch.stack(outs)


class _Chunk:
    """One chunk shape's program: the static device buffers (the LR chunk
    and the recurrent state), the host buffers its uploads go through, and
    :func:`run_chunk` over them, captured on the card (the graph's pool holds
    its temporaries and its HR output) or eager."""

    def __init__(self, sr: "StreamingSR", chunk: int, batch: int, h: int, w: int,
                 frame_dtype: torch.dtype):
        device = sr.device
        self.lr = torch.zeros((chunk, batch, h, w, 3), dtype=frame_dtype, device=device)
        self.state = init_state(batch, h, w, sr.dtype, device)
        if device.type == "cuda":
            # Two pinned buffers used in turn: the host fills one while the
            # device may still be reading the other's last upload.
            self.staging = [torch.zeros(self.lr.shape, dtype=frame_dtype, pin_memory=True)
                            for _ in range(2)]
        else:
            self.staging = [self.lr]  # the host writes the input itself
        self.done: List[Optional[torch.cuda.Event]] = [None] * len(self.staging)
        self.uploads = 0
        body = functools.partial(run_chunk, sr.generator, sr.fnet, sr.dtype, sr.output,
                                 self.state, self.lr)
        if sr.capture:
            self.run = CapturedProgram(body, (self.lr, *self.state),
                                       name=f"StreamingSR chunk {tuple(self.lr.shape)}")
        else:
            self.run = body

    def upload(self, piece: np.ndarray) -> None:
        """Put (n <= chunk, B, h, w, 3) frames into the LR buffer, padded by
        repeating the last frame (the extra outputs are discarded)."""
        i = self.uploads % len(self.staging)
        if self.done[i] is not None:
            self.done[i].synchronize()  # the device has read its last upload
        host = self.staging[i].numpy()
        host[:len(piece)] = piece
        host[len(piece):] = piece[-1]
        if self.staging[i] is not self.lr:
            self.lr.copy_(self.staging[i], non_blocking=True)
            self.done[i] = torch.cuda.Event()
            self.done[i].record()
        self.uploads += 1


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

    Each chunk shape (chunk length, batch, h, w, LR dtype) gets its static
    buffers and its program on first use, kept for later runs; a new shape
    warms up and captures once, inside that run's wall time
    (:attr:`capture_s` sums those seconds). Each run zeroes the state first.
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 output: str = "float32", device="cuda",
                 capture: Optional[bool] = None):
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be float32|uint8, got {output}")
        self.config = config
        self.output = output
        self.dtype = config.torch_dtype
        self.device = torch.device(device)
        self.capture = resolve_capture(capture, self.device)
        self.generator, self.fnet = place_models(generator, fnet, self.device,
                                                 self.dtype)
        self._chunks: Dict[Tuple, _Chunk] = {}
        self.capture_s = 0.0

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
        on_cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        prog = self._chunk(chunk, frames)
        for t in prog.state:  # the zero state (reference main.py:197-199)
            t.zero_()
        pending = None
        for s in range(0, frames.shape[0], chunk):
            piece = frames[s:s + chunk]
            prog.upload(piece)
            hr = prog.run()
            host, done = hr[:len(piece)], None
            if on_cuda:  # the next chunk's run overwrites hr: copy it first
                host = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                host.copy_(hr[:len(piece)], non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                deliver(*_fetch(*pending))
            pending = (host, done, s)
        if pending is not None:
            deliver(*_fetch(*pending))
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


def _fetch(host: torch.Tensor, done, start: int) -> Tuple[np.ndarray, int]:
    """A pending chunk's outputs as numpy, after its copy (``done``, a CUDA
    event, or None on the CPU) has landed."""
    if done is not None:
        done.synchronize()
    return host.numpy(), start
