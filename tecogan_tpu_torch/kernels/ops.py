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
``launches`` integer and in the calling thread's tally. A captured CUDA
graph replays launches without running any Python, so the captured program
(``utils/cuda_graphs.py``) reads the launches its capture made in a
:class:`LaunchRecord` and adds them again on every replay: ``launches``
counts the kernels that ran.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

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


def _tally() -> Dict[Callable, int]:
    """This thread's launches by wrapper, since the thread started."""
    tally = getattr(_THREAD, "tally", None)
    if tally is None:
        tally = _THREAD.tally = {}
    return tally


def count(wrapper: Callable, n: int = 1) -> None:
    """Add ``n`` kernel launches to ``wrapper.launches`` and to the calling
    thread's tally."""
    with _COUNT_LOCK:
        wrapper.launches += n
    tally = _tally()
    tally[wrapper] = tally.get(wrapper, 0) + n


class LaunchRecord:
    """The kernel launches the calling thread counts inside a ``with``
    block, by wrapper (a snapshot of its tally at entry and at exit, so the
    launches of other threads are not mixed in); :meth:`add` counts them
    again, ``times`` over (negative takes them back)."""

    def __init__(self):
        self.launches: Dict[Callable, int] = {}

    def __enter__(self) -> "LaunchRecord":
        self._before = dict(_tally())
        return self

    def __exit__(self, *exc) -> None:
        after = _tally()
        self.launches = {w: n - self._before.get(w, 0) for w, n in after.items()
                         if n != self._before.get(w, 0)}

    def add(self, times: int = 1) -> None:
        for wrapper, n in self.launches.items():
            count(wrapper, n * times)
