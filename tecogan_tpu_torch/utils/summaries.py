"""Scalar summaries (counterpart of ``tecogan_tpu/utils/summaries.py``):
one JSON row per call in ``<log_dir>/scalars.jsonl`` (reference scalar
summaries of the learning rate and every loss EMA, main.py:290-304).

TensorBoard event files and the animated-GIF sequence summaries need
``tensorboardX`` and PIL, which the GPU machine lacks; they are ROADMAP
queue 1 item 10.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class SummaryLogger:
    """Appends ``{"step": s, name: value, ...}`` rows to ``scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        row = {"step": int(step)}
        for k, v in values.items():
            row[prefix + k] = float(v)  # a number, numpy or torch scalar
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
