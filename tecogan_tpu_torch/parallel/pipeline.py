"""Two-stage pipeline-parallel streaming inference (counterpart of
``tecogan_tpu/parallel/pipeline.py``).

Frame t+1's first op (the warp) reads frame t's last output, so a layer
pipeline over the recurrence would drain every frame. What can overlap is
the frame-parallel prefix of the step: FNet and the 4x flow upsample read
only the LR frames. This module pipelines that seam:

  stage F (``flow_device``): FNet over the chunk's frame pairs + K1's flow
    upsample (:func:`flow_stage`);
  stage R (``recurrent_device``): the sequential warp + generator loop
    (``recurrent/inference.py:run_frames``), the state updated in place.

Each chunk shape gets static buffers and one program per stage, each on
its stage's device: on the card by default a captured CUDA graph, the
counterparts of the JAX package's ``jax.jit(flow_chunk)`` and
``jax.jit(recur_chunk, donate_argnums=(1,))``
(``tecogan_tpu/parallel/pipeline.py:137-138``); F updates the last frame it
saw and R the recurrent state in place. Each stage runs on a CUDA stream of
its own, and an event hands chunk k's flows (and its LR frames) from F to
R, which copies them into its own inputs, across devices where the two
differ. The host queues chunk k's stages before it fetches chunk k-1's
outputs, so while R runs chunk k, F computes chunk k+1: on two devices, or
on one (``flow_device == recurrent_device``), where the two streams share
the card. F's input and outputs are static (its frames are its input where
they need no cast), so F's next upload and run wait for an event that R
records after its copy. On the CPU the stages run in turn, eagerly.

The semantics are ``StreamingSR``'s (the same batched FNet prologue, the
same per-frame body), so the outputs equal ``StreamingSR``'s on the same
device.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.parallel.mesh import canonical_device
from tecogan_tpu_torch.recurrent.inference import (
    Staging,
    chunk_flows,
    copy_out,
    fetch_chunk,
    place_model,
    run_frames,
)
from tecogan_tpu_torch.recurrent.step import init_state
from tecogan_tpu_torch.utils.cuda_graphs import (
    CapturedProgram,
    capture_route,
    resolve_capture,
)


@torch.inference_mode()
def flow_stage(fnet: FNet, dtype: torch.dtype, prev_last: torch.Tensor,
               lr_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage F: (T, B, h, w, 3) LR frames (uint8 or float) and the last
    frame of the chunk before (``prev_last``, (B, h, w, 3), overwritten with
    this chunk's last) -> the (T, B, 4h, 4w, 2) HR flows and the frames in
    ``dtype`` (``recurrent/inference.py:chunk_flows``)."""
    lr, flow = chunk_flows(fnet, dtype, prev_last, lr_in)
    prev_last.copy_(lr[-1])
    return flow, lr


class _Stages:
    """One chunk shape's static buffers and its two programs: F over the
    uploaded frames and the last frame seen, on the flow device; R over
    F's flows and frames copied in and the recurrent state, on the
    recurrent device. Captured on the card (each graph's pool holds its
    temporaries and its outputs) or eager."""

    def __init__(self, pipe: "PipelinedStreamingSR", chunk: int, h: int, w: int,
                 frame_dtype: torch.dtype):
        fd, rd, dtype = pipe.flow_device, pipe.recurrent_device, pipe.dtype
        self.lr_in = torch.zeros((chunk, 1, h, w, 3), dtype=frame_dtype, device=fd)
        self.prev_last = torch.zeros((1, h, w, 3), dtype=dtype, device=fd)
        self.lr = torch.zeros((chunk, 1, h, w, 3), dtype=dtype, device=rd)
        self.flow = torch.zeros((chunk, 1, 4 * h, 4 * w, 2), dtype=dtype, device=rd)
        self.state = init_state(1, h, w, dtype, rd)
        self.staging = Staging([self.lr_in])
        flow = functools.partial(flow_stage, pipe.fnet, dtype, self.prev_last, self.lr_in)
        recurrent = functools.partial(run_frames, pipe.generator, pipe.output,
                                      self.state, self.lr, self.flow)
        if pipe.capture:
            shape = (chunk, 1, h, w)
            self.run_flow = CapturedProgram(flow, (self.lr_in, self.prev_last),
                                            name=f"pipeline stage F {shape} on {fd}")
            self.run_recurrent = CapturedProgram(
                recurrent, (self.lr, self.flow, *self.state),
                name=f"pipeline stage R {shape} on {rd}")
        else:
            self.run_flow, self.run_recurrent = flow, recurrent

    def pool_bytes(self) -> Tuple[int, int]:
        """Device bytes of stage F's and stage R's graph pools (0 eager)."""
        return tuple(p.pool_bytes() if isinstance(p, CapturedProgram) else 0
                     for p in (self.run_flow, self.run_recurrent))


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
      capture: as ``StreamingSR``'s (``utils/cuda_graphs.py:resolve_capture``):
        None (the default) runs each stage of each chunk shape as a
        captured CUDA graph on the card and eagerly on the CPU; False runs
        eagerly; True on the CPU raises.

    Each chunk shape's buffers and programs are made on first use, inside
    that run's wall time (:attr:`capture_s` sums those seconds), and kept;
    each run zeroes the state first. :attr:`route` says how the stages run.
    """

    def __init__(self, config: TecoConfig, generator: Generator, fnet: FNet,
                 output: str = "float32", flow_device=None, recurrent_device=None,
                 capture: Optional[bool] = None):
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
        self.capture = resolve_capture(capture, self.flow_device)
        self.route = (f"stage F {capture_route(self.capture, self.flow_device)}, stage R "
                      f"{capture_route(self.capture, self.recurrent_device)}")
        self.fnet = place_model(fnet, self.flow_device, self.dtype)
        self.generator = place_model(generator, self.recurrent_device, self.dtype)
        self.on_cuda = self.flow_device.type == "cuda"
        if self.on_cuda:
            self.flow_stream = torch.cuda.Stream(self.flow_device)
            self.recurrent_stream = torch.cuda.Stream(self.recurrent_device)
        self._stages: Dict[Tuple, _Stages] = {}
        self.capture_s = 0.0

    def _in(self, stage: str):
        """Run on ``stage``'s ("flow" or "recurrent") device and stream."""
        if not self.on_cuda:
            return contextlib.nullcontext()
        stream = self.flow_stream if stage == "flow" else self.recurrent_stream
        return torch.cuda.stream(stream)

    def _record(self) -> Optional[torch.cuda.Event]:
        """An event on the current stream (None on the CPU)."""
        if not self.on_cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _stages_for(self, chunk: int, h: int, w: int, frame_dtype: torch.dtype) -> _Stages:
        key = (chunk, h, w, frame_dtype)
        stages = self._stages.get(key)
        if stages is None:
            t0 = time.perf_counter()
            stages = self._stages[key] = _Stages(self, *key)
            self.capture_s += time.perf_counter() - t0
        return stages

    # ------------------------------------------------------------- public
    def run(self, frames: np.ndarray, warmup: int = 0, chunk: Optional[int] = None,
            on_chunk: Optional[Callable[[np.ndarray, int], None]] = None,
            ) -> Tuple[Optional[np.ndarray], float]:
        """Super-resolve a (T, h, w, 3) sequence, float32 in [0, 1] or uint8;
        the contract of ``StreamingSR.run`` (``on_chunk`` included). Stage F
        of chunk k is queued before chunk k-1's outputs are fetched."""
        chunk = chunk or self.config.infer_chunk
        t, h, w, _ = frames.shape
        outs: List[np.ndarray] = []

        def deliver(hr: np.ndarray, start: int) -> None:
            hr = hr[:, 0]
            if on_chunk is None:
                outs.append(hr)
            elif start + len(hr) > warmup:
                on_chunk(hr[max(warmup - start, 0):], max(start, warmup))

        t0 = time.perf_counter()
        st = self._stages_for(chunk, h, w, torch.from_numpy(frames[:0]).dtype)
        for x in (st.prev_last, *st.state):  # the zero state (reference main.py:197-199)
            x.zero_()
        if self.on_cuda:  # the buffers were zeroed and the models made on the default streams
            for stream, device in ((self.flow_stream, self.flow_device),
                                   (self.recurrent_stream, self.recurrent_device)):
                stream.wait_stream(torch.cuda.current_stream(device))
        frames = frames[:, None]
        pending = copied = None
        for s in range(0, t, chunk):
            piece = frames[s:s + chunk]
            with self._in("flow"):
                # The upload and F overwrite F's input and outputs, which R
                # copies in (its frames are its input where they need no
                # cast, float32 in float32): only after R's last copy.
                if copied is not None:
                    self.flow_stream.wait_event(copied)
                st.staging.upload(piece)
                flow, lr_f = st.run_flow()
                handed = self._record()
            with self._in("recurrent"):
                if handed is not None:
                    self.recurrent_stream.wait_event(handed)
                st.flow.copy_(flow, non_blocking=True)
                st.lr.copy_(lr_f, non_blocking=True)
                copied = self._record()
                # The next chunk's run overwrites the output: copy it first.
                hosts, done = copy_out([st.run_recurrent()], len(piece))
            if pending is not None:
                deliver(*fetch_chunk(*pending))
            pending = (hosts, done, s)
        if pending is not None:
            deliver(*fetch_chunk(*pending))
        elapsed = time.perf_counter() - t0
        if on_chunk is not None:
            return None, elapsed
        return np.concatenate(outs, axis=0)[warmup:], elapsed
