"""One captured CUDA graph over static tensors: the port's counterpart of
``jax.jit`` with donated arguments.

The JAX package runs each inference path and each training step as one
compiled program: the streaming chunk is a ``jax.jit`` of a ``lax.scan``
whose recurrent state is donated (``tecogan_tpu/recurrent/inference.py:259,324``),
the server tick ``jax.jit(server_step, donate_argnums=(2,))``
(``tecogan_tpu/serve/engine.py:163``), the train step
``jax.jit(self._train_step_impl, donate_argnums=(0,))`` and the eval step
(``tecogan_tpu/train/trainer.py:173-174``). Here the same body is captured once
per shape into a ``torch.cuda.CUDAGraph`` and replayed: it reads static
input tensors, writes the recurrent state into static tensors in place (the
donation) and returns its output, whose storage, from the graph's private
memory pool, stays the same from replay to replay. Its temporaries live in
that pool too.

:class:`CapturedProgram`:

- warms up before it captures: one eager run of the body on a side stream
  loads the kernel library, runs each kernel's one-time
  ``cudaFuncSetAttribute`` opt-in (``csrc/resblock_chain_mma.cu``,
  ``csrc/resblock_chain.cu``) and settles cuDNN's algorithm choices, none
  of which may happen under capture. The caller makes that run harmless:
  the streaming state is zeroed after it, a server's warm tick has every
  slot inactive, a training step's state is saved before it and restored
  after the capture;
- captures under ``torch.cuda.graph(..., capture_error_mode="thread_local")``,
  so other threads keep using the card meanwhile (a serving bucket warmed
  in the background while another bucket ticks; writer threads waiting on
  events), one capture at a time in the process. Python's garbage
  collector runs just before and not during the capture: a collection
  inside it would free dead programs' pinned buffers and events on the
  capturing thread, whose allocator calls are not allowed there, and would
  invalidate the capture. A capture that fails raises, naming the line
  that broke it; nothing falls back to eager;
- replays on the caller's current stream, and adds the kernel launches its
  capture counted (:class:`~tecogan_tpu_torch.kernels.LaunchRecord`, keyed
  by the capture's stream, so a backward's launches on autograd's device
  thread count) to the wrappers' ``launches`` counters, so they count the
  kernels that ran;
- releases its graph and its memory pool on :meth:`close`, or when it is
  dropped (a ``CUDAGraph`` resets itself when freed);
- while a profiler runs, marks its warm-up and capture (span
  ``graph.capture``, from outside the captured block) and each replay
  (``graph.replay``) with :func:`~tecogan_tpu_torch.utils.profiling.span`.

A replay reads every tensor at the address it had during the capture, the
models' parameters included: moving the models (``.to()`` another dtype or
device) after a capture leaves the graph reading freed memory.
"""

from __future__ import annotations

import gc
import os
import threading
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import torch

from tecogan_tpu_torch.kernels import LaunchRecord
from tecogan_tpu_torch.utils.profiling import span

# torch.cuda.graph allows one capture at a time in a process.
_CAPTURE_LOCK = threading.Lock()
_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep


def resolve_capture(capture: Optional[bool], device: torch.device) -> bool:
    """The ``capture=`` argument of the inference entry points: None
    captures on a CUDA device and runs eagerly on the CPU; False runs
    eagerly anywhere; True on the CPU raises."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}: "
                         "CUDA graphs exist only on the card")
    return bool(capture)


def capture_route(captured: bool, device: torch.device) -> str:
    """What :func:`resolve_capture` decided for ``device``, and why, as the
    entry points print it."""
    if captured:
        return f"captured CUDA graphs on {device}"
    if device.type == "cuda":
        return f"eager on {device} (capture=False)"
    return f"eager on {device} (CUDA graphs exist only on the card)"


def _where(exc: BaseException) -> str:
    """The innermost line of ``exc``'s traceback outside PyTorch."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH_DIR)]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class CapturedProgram:
    """``body()`` captured as a CUDA graph; calling the program replays it
    and returns the body's static output.

    Args:
      body: a function of no arguments that reads and writes only tensors
        that outlive the program (``inputs``) and returns its output.
      inputs: the static tensors the body reads or writes in place, all on
        one CUDA device; the program keeps them alive.
      name: what the program is, for errors.
    """

    captures = 0  # graphs captured in this process

    def __init__(self, body: Callable[[], object], inputs: Sequence[torch.Tensor],
                 name: str):
        self.name = name
        self.inputs: Tuple[torch.Tensor, ...] = tuple(inputs)
        device = self.inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs CUDA tensors, not {device}")
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        failure = None
        with (span("graph.capture", program=name) as capture_span, _CAPTURE_LOCK,
              torch.cuda.device(device)):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            side.synchronize()  # as torch.cuda.graph does on entry: the warm-up's end
            capture_span.set(warmup_s=time.perf_counter() - t0)
            graph = torch.cuda.CUDAGraph()
            record = LaunchRecord(stream=side.cuda_stream)
            collecting = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                with record, torch.cuda.graph(graph, stream=side,
                                              capture_error_mode="thread_local"):
                    try:
                        self.output = body()
                    except Exception as exc:
                        failure = exc
                        raise
            except Exception as exc:
                cause = failure or exc
                raise RuntimeError(f"capturing {name} failed at {_where(cause)}: "
                                   f"{type(cause).__name__}: {cause}") from cause
            finally:
                if collecting:
                    gc.enable()
                record.add(-1)  # the capture queued these launches and ran none
            self._launches = record
            self._graph = graph
            self.pool_id = tuple(graph.pool())
            CapturedProgram.captures += 1

    def __call__(self):
        """Replay the graph on the current stream; returns the output."""
        if self._graph is None:
            raise RuntimeError(f"{self.name}: the program was closed")
        with span("graph.replay", program=self.name):
            self._graph.replay()
        self._launches.add()
        return self.output

    def pool_bytes(self) -> int:
        """Device bytes held by the graph's private memory pool: its
        temporaries and its output."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == self.pool_id)

    def close(self) -> None:
        """Free the graph and, with its output, its memory pool (dropping
        the program does the same: the graph resets itself when freed)."""
        graph, self._graph = self._graph, None
        self.output, self.inputs = None, ()
        if graph is not None:
            graph.reset()
