"""Console logging helpers (counterpart of ``tecogan_tpu/utils/logging.py``).

- :class:`Tee`: duplicate stdout into a logfile (reference main.py:126-136).
- :func:`param_summary`: per-module parameter name/shape/size dump
  (reference ``printVariable``, main.py:138-146).
"""

from __future__ import annotations

import sys

import torch.nn as nn


class Tee:
    """Duplicate writes to stdout and a logfile."""

    def __init__(self, path: str, mode: str = "a"):
        self.terminal = sys.stdout
        self.log = open(path, mode)

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def install(self):
        sys.stdout = self
        return self

    def uninstall(self):
        sys.stdout = self.terminal
        self.log.close()


def param_summary(name: str, module: nn.Module, print_fn=print) -> int:
    """Print every parameter's path, shape and size under ``name``; return
    the total count."""
    total = 0
    print_fn(f"Scope {name}:")
    for path, p in module.named_parameters():
        total += p.numel()
        print_fn(f"   Variable: {name}/{path.replace('.', '/')}, "
                 f"Shape: {tuple(p.shape)}, Size: {p.numel()}")
    print_fn(f"total size: {total}")
    return total
