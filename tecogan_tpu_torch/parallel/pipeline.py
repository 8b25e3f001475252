"""Two-stage pipeline-parallel streaming inference (counterpart of
``tecogan_tpu/parallel/pipeline.py``).

Frame t+1's first op (the warp) reads frame t's last output, so a layer
pipeline over the recurrence would drain every frame. What can overlap is
the frame-parallel prefix of the step: FNet and the 4x flow upsample read
only the LR frames. This module pipelines that seam:

  stage F (``flow_device``): FNet over the chunk's frame pairs + K1's flow
    upsample;
  stage R (``recurrent_device``): the sequential warp + generator loop.

Each stage runs on a CUDA stream of its own, and an event hands chunk k's
flows (and its LR frames) from F to R, copied to R's device when it is
another. The host queues chunk k's stages before it fetches chunk k-1's
outputs, so while R runs chunk k, F computes chunk k+1: on two devices, or
on one (``flow_device == recurrent_device``), where the two streams share
the card. On the CPU the stages run in turn.

The semantics are ``StreamingSR``'s (the same batched FNet prologue, the
same per-frame body), so the outputs equal ``StreamingSR(capture=False)``'s
on the same device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.parallel.mesh import canonical_device
from tecogan_tpu_torch.recurrent.inference import as_output, chunk_pairs, fetch_chunk
from tecogan_tpu_torch.recurrent.step import (
    RecurrentState,
    generator_step,
    init_state,
    upscale_flow,
)


def _place(module: torch.nn.Module, device: torch.device, dtype: torch.dtype):
    fmt = torch.channels_last if device.type == "cuda" else torch.preserve_format
    return module.to(device=device, dtype=dtype, memory_format=fmt).eval()


class PipelinedStreamingSR:
    """Streaming 4x VSR with the flow stage on its own device and stream.

    Args:
      config: model/runtime configuration (``infer_chunk`` sets the
        pipeline's granularity).
      generator / fnet: the models; FNet is moved to ``flow_device``, the
        generator to ``recurrent_device``, in the compute dtype, in place.
      output: "float32" or "uint8" (quantised on the device), as in
        ``StreamingSR``.
      flow_device / recurrent_device: the stages' devices (default: the
        first two CUDA devices; with fewer and none named, ValueError).
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 output: str = "float32", flow_device=None, recurrent_device=None):
        if flow_device is None or recurrent_device is None:
            count = torch.cuda.device_count()
            if count < 2:
                raise ValueError(f"PipelinedStreamingSR needs two devices; have {count}")
            flow_device, recurrent_device = "cuda:0", "cuda:1"
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be float32|uint8, got {output}")
        self.config = config
        self.dtype = config.torch_dtype
        self.output = output
        self.flow_device = canonical_device(flow_device)
        self.recurrent_device = canonical_device(recurrent_device)
        if {self.flow_device.type, self.recurrent_device.type} == {"cpu", "cuda"}:
            raise ValueError("the two stages run both on the card or both on the CPU")
        self.fnet = _place(fnet, self.flow_device, self.dtype)
        self.generator = _place(generator, self.recurrent_device, self.dtype)
        self.on_cuda = self.flow_device.type == "cuda"
        if self.on_cuda:
            self.flow_stream = torch.cuda.Stream(self.flow_device)
            self.recurrent_stream = torch.cuda.Stream(self.recurrent_device)

    def _in(self, stage: str):
        """Run on ``stage``'s ("flow" or "recurrent") device and stream."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        stream = self.flow_stream if stage == "flow" else self.recurrent_stream
        return torch.cuda.stream(stream)

    # ------------------------------------------------------------- stages
    @torch.inference_mode()
    def _flow_chunk(self, prev_last: torch.Tensor, lr_chunk: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage F: (T, B, h, w, 3) LR frames (uint8 or float) and the last
        frame of the chunk before -> the (T, B, 4h, 4w, 2) HR flows and the
        frames in the compute dtype (``recurrent/inference.py:run_chunk``'s
        prologue)."""
        lr_chunk, pairs = chunk_pairs(prev_last, lr_chunk, self.dtype)
        t, b, h, w, _ = lr_chunk.shape
        flow = upscale_flow(self.fnet(pairs), h, w).reshape(t, b, 4 * h, 4 * w, 2)
        return flow, lr_chunk

    @torch.inference_mode()
    def _recurrent_chunk(self, state: RecurrentState, lr_chunk: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
        """Stage R: the per-frame warp + generator loop (``run_chunk``'s
        body, with the flows from stage F); the state is updated in place."""
        outs, st = [], state
        for i in range(lr_chunk.shape[0]):
            st, hr = generator_step(self.generator, st, lr_chunk[i], flow[i])
            outs.append(as_output(hr, self.output))
        for dst, new in zip(state, st):
            dst.copy_(new)
        return torch.stack(outs)

    # ------------------------------------------------------------- public
    def run(self, frames: np.ndarray, warmup: int = 0, chunk: Optional[int] = None,
            on_chunk: Optional[Callable[[np.ndarray, int], None]] = None,
            ) -> Tuple[Optional[np.ndarray], float]:
        """Super-resolve a (T, h, w, 3) sequence, float32 in [0, 1] or uint8;
        the contract of ``StreamingSR.run`` (``on_chunk`` included). Stage F
        of chunk k is queued before chunk k-1's outputs are fetched."""
        chunk = chunk or self.config.infer_chunk
        t, h, w, _ = frames.shape
        frame_dtype = torch.from_numpy(frames[:0]).dtype
        outs: List[np.ndarray] = []

        def deliver(hr: np.ndarray, start: int) -> None:
            if on_chunk is None:
                outs.append(hr)
            elif start + len(hr) > warmup:
                on_chunk(hr[max(warmup - start, 0):], max(start, warmup))

        t0 = time.perf_counter()
        if self.on_cuda:  # the models and the inputs were made on the default streams
            for stream, device in ((self.flow_stream, self.flow_device),
                                   (self.recurrent_stream, self.recurrent_device)):
                stream.wait_stream(torch.cuda.current_stream(device))
        staging = [torch.zeros((chunk, 1, h, w, 3), dtype=frame_dtype,
                               pin_memory=self.on_cuda) for _ in range(2)]
        read: List[Optional[torch.cuda.Event]] = [None, None]
        with self._in("flow"):
            prev_last = torch.zeros((1, h, w, 3), dtype=self.dtype, device=self.flow_device)
        with self._in("recurrent"):
            state = init_state(1, h, w, self.dtype, self.recurrent_device)
        pending = held = None
        for k, s in enumerate(range(0, t, chunk)):
            piece = frames[s:s + chunk]
            n = len(piece)
            host = staging[k % 2]
            if read[k % 2] is not None:
                read[k % 2].synchronize()  # stage F has read its last upload
            view = host.numpy()
            view[:n, 0] = piece
            view[n:, 0] = piece[-1]  # pad to the chunk; the extra outputs are dropped
            with self._in("flow"):
                lr_f = host.to(self.flow_device, non_blocking=True)
                if self.on_cuda:
                    read[k % 2] = torch.cuda.Event()
                    read[k % 2].record()
                flow, lr_f = self._flow_chunk(prev_last, lr_f)
                prev_last = lr_f[-1]
                handed = torch.cuda.Event() if self.on_cuda else None
                if handed is not None:
                    handed.record()
            with self._in("recurrent"):
                if handed is not None:
                    self.recurrent_stream.wait_event(handed)
                flow_r = flow.to(self.recurrent_device, non_blocking=True)
                lr_r = lr_f.to(self.recurrent_device, non_blocking=True)
                hr = self._recurrent_chunk(state, lr_r, flow_r)[:n, 0]
                done = None
                if self.on_cuda:
                    out = torch.empty(hr.shape, dtype=hr.dtype, pin_memory=True)
                    out.copy_(hr, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    hr = out
            if pending is not None:
                deliver(*fetch_chunk(*pending))
            # Stage F's tensors stay referenced until stage R's copy of this
            # chunk (``done``) has been waited for, so the allocator cannot
            # hand their memory out again on the flow stream meanwhile.
            pending, held = ([hr], [done] if done is not None else [], s), (flow, lr_f)
        if pending is not None:
            deliver(*fetch_chunk(*pending))
        elapsed = time.perf_counter() - t0
        if on_chunk is not None:
            return None, elapsed
        return np.concatenate(outs, axis=0)[warmup:], elapsed

