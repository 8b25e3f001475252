"""Streaming 4x VSR inference (counterpart of
``tecogan_tpu/recurrent/inference.py``; reference main.py:180-270).

The sequence runs in chunks of ``config.infer_chunk`` frames. Per chunk,
FNet and the flow upsample run once over all T*B (previous, current) pairs;
then a per-frame loop carries the truly recurrent warp + generator. LR
frames may arrive as uint8 and are normalised on the device; HR frames may
leave as uint8, quantised on the device exactly as
``np.clip(img * 255, 0, 255).astype(np.uint8)`` (reference ops.py:520-523).

On CUDA, each chunk's output is copied to pinned host memory without
blocking, and read only after the next chunk has been queued, so the copy
and the host's work overlap the device's.

Warm-up protocol: the first 5 outputs belong to reversed frames [5..1]
prepended by :func:`prepend_warmup` and are dropped (reference
dataloader.py:42-44, main.py:262-269).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

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


class StreamingSR:
    """Chunked streaming super-resolver.

    Args:
      config: model/runtime configuration (``compute_dtype``, ``infer_chunk``).
      generator / fnet: the models; they are moved to ``device`` and cast to
        the compute dtype in place (:func:`place_models`).
      output: "float32" (HR in [0, 1]) or "uint8" (quantised on the device).
      device: where to run; the card unless the caller asks for the CPU.
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 output: str = "float32", device="cuda"):
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be float32|uint8, got {output}")
        self.config = config
        self.output = output
        self.dtype = config.torch_dtype
        self.device = torch.device(device)
        self.generator, self.fnet = place_models(generator, fnet, self.device,
                                                 self.dtype)

    @torch.inference_mode()
    def _run_chunk(self, state: RecurrentState, lr_chunk: torch.Tensor
                   ) -> Tuple[RecurrentState, torch.Tensor]:
        """(T, B, h, w, 3) LR frames on the device -> new state and
        (T, B, 4h, 4w, 3) HR frames (float32 or uint8)."""
        if lr_chunk.dtype == torch.uint8:
            lr_chunk = lr_chunk.float() / 255.0
        lr_chunk = lr_chunk.to(self.dtype)
        t, b, h, w, c = lr_chunk.shape
        prev = torch.cat([state.prev_lr[None], lr_chunk[:-1]], dim=0)
        pairs = torch.cat([prev, lr_chunk], dim=-1).reshape(t * b, h, w, 2 * c)
        flow = upscale_flow(self.fnet(pairs), h, w).reshape(
            t, b, 4 * h, 4 * w, 2)
        outs = []
        for i in range(t):
            state, hr = generator_step(self.generator, state, lr_chunk[i],
                                       flow[i])
            if self.output == "uint8":
                outs.append((hr.float() * 255.0).clamp_(0.0, 255.0)
                            .to(torch.uint8))
            else:
                outs.append(hr.float())
        return state, torch.stack(outs)

    def _chunks(self, frames: np.ndarray, chunk: int):
        """Yield (piece, n, start): (chunk, B, h, w, 3) device tensors from
        (T, B, h, w, 3) frames, the last padded by repeating its last frame
        (the extra outputs are discarded)."""
        for s in range(0, frames.shape[0], chunk):
            piece = frames[s:s + chunk]
            n = piece.shape[0]
            if n < chunk:
                piece = np.concatenate(
                    [piece, np.repeat(piece[-1:], chunk - n, axis=0)], axis=0)
            yield torch.from_numpy(np.ascontiguousarray(piece)).to(self.device), n, s

    def _stream(self, frames: np.ndarray, chunk: int,
                deliver: Callable[[np.ndarray, int], None]) -> float:
        """Run (T, B, h, w, 3) frames; ``deliver(hr, start)`` gets each
        chunk's (n, B, 4h, 4w, 3) outputs in order. Returns wall seconds."""
        _, bsz, h, w, _ = frames.shape
        state = init_state(bsz, h, w, self.dtype, self.device)
        on_cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        pending = None
        for lr, n, s in self._chunks(frames, chunk):
            state, hr = self._run_chunk(state, lr)
            host, done = hr[:n], None
            if on_cuda:
                host = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                host.copy_(hr[:n], non_blocking=True)
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
