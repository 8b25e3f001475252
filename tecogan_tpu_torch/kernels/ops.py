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
"""

from __future__ import annotations

from typing import Callable

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
