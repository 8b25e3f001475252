"""Profiling and timing (counterpart of ``tecogan_tpu/utils/profiling.py``).

The reference has no tracing, only wall-clock aggregates: per-frame SR time
at inference (main.py:256-260,270) and images/sec + ETA in training
(main.py:404-411). This module gives both, and traces:

- :func:`trace`: ``torch.profiler`` around a block (the CPU, and the card's
  kernels when there is one), written as a Chrome trace into a directory;
- :func:`sync`: wait for a tensor's device and return a scalar;
- :class:`StepTimer`: images/sec and ETA, the JAX package's arithmetic;
- :func:`device_time_samples` / :func:`device_time`: seconds per call of a
  function in its steady state, timed with CUDA events on the card and with
  ``perf_counter`` after a synchronisation on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/trace"):`` profiles the block and writes
    ``<log_dir>/trace.json`` (Chrome trace format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(x) -> float:
    """Wait until everything the first tensor in ``x`` (a tensor, or a
    list, tuple or dict holding one) depends on is done; returns its sum as
    a float (0.0 when ``x`` holds no tensor)."""
    t = _first_tensor(x)
    if t is None:
        return 0.0
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.detach().float().sum())


class StepTimer:
    """Images/sec + ETA tracking (reference main.py:404-411 semantics)."""

    def __init__(self, items_per_step: float, total_steps: Optional[int] = None):
        self.items_per_step = items_per_step
        self.total_steps = total_steps
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.items_per_step * self._steps / dt if dt > 0 else 0.0

    def eta_hours(self, current_step: int) -> Optional[float]:
        if not self.total_steps or self._steps == 0:
            return None
        dt = time.perf_counter() - self._t0
        per_step = dt / self._steps
        return (self.total_steps - current_step) * per_step / 3600.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0


def device_time_samples(fn: Callable, *args, iters: int = 10,
                        warmup: int = 2, passes: int = 1) -> list:
    """``passes`` measurements of ``iters`` calls each; one seconds-per-call
    sample per pass. On the card (the first tensor among ``fn``'s outputs,
    else its arguments, lies there) each pass is timed between two CUDA
    events on the current stream; elsewhere with ``perf_counter`` up to a
    :func:`sync` of the last output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    probe = _first_tensor(out) if out is not None else None
    probe = probe if probe is not None else _first_tensor(args)
    on_card = probe is not None and probe.device.type == "cuda"
    sync(out)
    samples = []
    for _ in range(max(1, passes)):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            sync(out)
            samples.append((time.perf_counter() - t0) / iters)
    return samples


def device_time(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn``."""
    return device_time_samples(fn, *args, iters=iters, warmup=warmup)[0]
