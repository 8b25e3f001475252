"""The kernels' launches as registered PyTorch operators,
``torch.ops.tecogan_torch.<name>``.

``torch.export`` traces a program with fake tensors, which have no data
pointer for a ctypes launch. As an operator with a fake kernel (its
output's shape), a launch stays one node of the exported graph, and a
loaded program calls it back through the dispatcher: importing
:mod:`tecogan_tpu_torch.kernels` registers every operator, and is all a
loaded program needs besides ``torch``.

Each operator has one body for the CPU and CUDA dispatch keys: the plain
version on a CPU tensor, the kernel on a CUDA tensor (anything else has no
kernel and raises). They are defined through ``torch.library.Library``,
whose Python kernels cost less to dispatch than ``torch.library.custom_op``'s
wrapper; the inference path calls them several times a frame.

Each body counts its kernel launches with :func:`count`, in its wrapper's
``launches`` integer, in the calling thread's tally and in the record of a
capture running on the current CUDA stream. A captured CUDA graph replays
launches without running any Python, so the captured program
(``utils/cuda_graphs.py``) reads the launches its capture made in a
:class:`LaunchRecord` and adds them again on every replay: ``launches``
counts the kernels that ran. A capture's record is keyed by its stream,
not by the capturing thread: a backward runs on autograd's device thread,
on the stream of its forward, so the K2 launch of a captured training
step lands in the capture's record.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

NAMESPACE = "tecogan_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def register(schema: str, body: Callable, fake: Callable) -> None:
    """Define ``tecogan_torch::<schema>`` with ``body`` on CPU and CUDA
    tensors and ``fake`` for tracing."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, body, "CPU")
    _LIB.impl(name, body, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


_COUNT_LOCK = threading.Lock()  # += on a shared integer is not atomic
_THREAD = threading.local()
# The records of the captures running now, by their CUDA stream (at most one
# at a time: torch.cuda.graph allows one capture in a process).
_STREAM_RECORDS: Dict[int, "LaunchRecord"] = {}


def _tally() -> Dict[Callable, int]:
    """This thread's launches by wrapper, since the thread started."""
    tally = getattr(_THREAD, "tally", None)
    if tally is None:
        tally = _THREAD.tally = {}
    return tally


def _stream_key() -> int:
    """The calling thread's current CUDA stream, as a capture's record is
    keyed (autograd's device thread runs a backward on its forward's
    stream)."""
    return torch.cuda.current_stream().cuda_stream


def count(wrapper: Callable, n: int = 1) -> None:
    """Add ``n`` kernel launches to ``wrapper.launches``, to the calling
    thread's tally and, during a capture on the current stream, to that
    capture's record."""
    record = _STREAM_RECORDS.get(_stream_key()) if _STREAM_RECORDS else None
    with _COUNT_LOCK:
        wrapper.launches += n
        if record is not None:
            record.launches[wrapper] = record.launches.get(wrapper, 0) + n
    tally = _tally()
    tally[wrapper] = tally.get(wrapper, 0) + n


class LaunchRecord:
    """The kernel launches counted inside a ``with`` block, by wrapper;
    :meth:`add` counts them again, ``times`` over (negative takes them
    back).

    With no ``stream``: the calling thread's launches (a snapshot of its
    tally at entry and at exit, so the launches of other threads are not
    mixed in). With ``stream`` (a ``cuda_stream`` handle): every launch
    counted while that stream is the counting thread's current one,
    whatever the thread; launches on other streams stay out."""

    def __init__(self, stream: Optional[int] = None):
        self.stream = stream
        self.launches: Dict[Callable, int] = {}

    def __enter__(self) -> "LaunchRecord":
        if self.stream is None:
            self._before = dict(_tally())
        else:
            with _COUNT_LOCK:
                if self.stream in _STREAM_RECORDS:
                    raise RuntimeError(f"stream {self.stream:#x} already has a launch record")
                _STREAM_RECORDS[self.stream] = self
        return self

    def __exit__(self, *exc) -> None:
        if self.stream is not None:
            with _COUNT_LOCK:
                del _STREAM_RECORDS[self.stream]
            return
        after = _tally()
        self.launches = {w: n - self._before.get(w, 0) for w, n in after.items()
                         if n != self._before.get(w, 0)}

    def add(self, times: int = 1) -> None:
        for wrapper, n in self.launches.items():
            count(wrapper, n * times)
