"""Profiling and timing (counterpart of ``tecogan_tpu/utils/profiling.py``).

The reference has no tracing, only wall-clock aggregates: per-frame SR time
at inference (main.py:256-260,270) and images/sec + ETA in training
(main.py:404-411); the port's training loop keeps its own images/sec
window (``train/loop.py``). This module traces and times:

- :func:`trace`: ``torch.profiler`` around a block (the CPU, and the card's
  kernels when there is one), written as a Chrome trace into a directory;
- :func:`span`: the port's spans at its layer boundaries, on the
  profiler's clock, recorded only while a profiler runs on the calling
  thread and no CUDA graph captures on it (:func:`spans`, :func:`clear`);
- :func:`sync`: wait for a tensor's device and return a scalar;
- :func:`device_time_samples` / :func:`device_time`: seconds per call of a
  function in its steady state, timed with CUDA events on the card and with
  ``perf_counter`` after a synchronisation on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

SPAN_PREFIX = "tecogan."  # a span's range in the profiler's trace
RING_RECORDS = 65536  # closed spans kept in memory, the newest


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
    ``<log_dir>/trace.json`` (Chrome trace format), with the port's spans
    (:func:`span`) opened on this thread among the kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SpanRecord(NamedTuple):
    """One closed span. ``start_ns``/``end_ns`` are on the profiler's clock
    (``time.time_ns``, the duration from ``perf_counter_ns``); ``parent`` is
    the ``id`` of the span open around it on its thread (None at the top);
    ``item`` is the clip, tick or step it belongs to (its parent's unless
    given)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    item: object
    thread: int
    attrs: Dict


class _SpanRing:
    """The newest ``size`` closed spans; the oldest are dropped and counted."""

    def __init__(self, size: int):
        self.records: "collections.deque[SpanRecord]" = collections.deque(maxlen=size)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


_RING = _SpanRing(RING_RECORDS)
_IDS = itertools.count(1)
_OPEN = threading.local()  # each thread's stack of open spans


def _open_spans() -> List["_Span"]:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Span:
    """A span while the profiler runs: a ``record_function`` range in the
    trace and, once closed, a :class:`SpanRecord` in the ring."""

    __slots__ = ("name", "item", "attrs", "id", "parent", "_range", "_start_ns", "_t0")

    def __init__(self, name: str, item, attrs: Dict):
        self.name, self.item, self.attrs = name, item, attrs

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.item is None and outer is not None:
            self.item = outer.item
        self.id = next(_IDS)
        stack.append(self)
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        # Stamp before opening the range: the profiler stamps the range's
        # start early in the call, and the call can be slow (about 1 ms the
        # first time in a profile), so a stamp taken after it starts late.
        self._start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        took = time.perf_counter_ns() - self._t0
        _open_spans().pop()
        self._range.__exit__(*exc)
        _RING.add(SpanRecord(self.id, self.name, self._start_ns, self._start_ns + took,
                             self.parent, self.item, threading.get_ident(), self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


class _Off:
    """The span while no profiler runs on the calling thread: it enters
    nothing and records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, item=None, **attrs):
    """``with span("serve.step", item=tick, frames=n):`` marks a layer
    boundary of the port. Off unless a profiler runs on the calling thread
    (:func:`trace`, or any ``torch.profiler.profile``): then it is one
    shared no-op and costs the check. Off too while the current CUDA
    stream captures a graph: a replay runs no Python, so a span in a
    captured body (the trainer's stages) records only when the body runs
    eagerly. On, the block is the range ``tecogan.<name>`` in the
    profiler's trace, and its record (name, start and end on the
    profiler's clock, the enclosing span, ``item``, the thread, ``attrs``)
    goes into an in-memory ring when it closes."""
    if not torch.autograd._profiler_enabled() or _capturing():
        return _OFF
    return _Span(name, item, attrs)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never before
    the process has made its CUDA context; the check makes none)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def spans() -> List[SpanRecord]:
    """The ring's records, oldest first, each appended as its span closed."""
    with _RING.lock:
        return list(_RING.records)


def dropped_spans() -> int:
    """Records the ring dropped, full, since the last :func:`clear`."""
    return _RING.dropped


def clear() -> None:
    """Empty the ring and its count of dropped records."""
    with _RING.lock:
        _RING.records.clear()
        _RING.dropped = 0


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
