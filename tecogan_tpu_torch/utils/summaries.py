"""Scalar, image and animated-GIF summaries (counterpart of
``tecogan_tpu/utils/summaries.py``).

Replaces the reference's TensorBoard pipeline: scalar summaries for lr +
every loss EMA (reference main.py:290-297, Teco.py:433-435), ``val_*`` raw
scalars (main.py:299-304), and animated GIF summaries of LR/HR/Generated
sequences (reference ``gif_summary`` ops.py:399-517: an ffmpeg subprocess
inside ``tf.py_func``, PIL its fallback). The JAX package writes them with
tensorboardX and PIL, which the GPU machine lacks; here the GIFs come from
the port's own writer (``utils/gif.py``, with the same optional ffmpeg pipe)
and the TensorBoard event file from ``utils/tb_events.py``. Every scalar
also goes to ``<log_dir>/scalars.jsonl``, one JSON row per call.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict

import numpy as np

from tecogan_tpu_torch.utils import tb_events
from tecogan_tpu_torch.utils.gif import write_gif


def _to_uint8(x: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 as the JAX package converts: clip and truncate."""
    x = np.asarray(x)
    return x if x.dtype == np.uint8 else np.clip(x * 255.0, 0, 255).astype(np.uint8)


def encode_gif(frames: np.ndarray, path: str, fps: int = 3,
               use_ffmpeg: bool = False) -> None:
    """Write (T, H, W, 3) uint8 (or float [0, 1]) frames as an animated GIF.

    ``use_ffmpeg`` pipes raw frames through ffmpeg exactly like reference
    ops.py:399-431, falling through to the port's writer when the pipe
    fails (where the JAX package falls through to PIL); the writer shows
    each frame ``int(1000 / fps)`` ms, PIL's ``duration``."""
    frames = _to_uint8(frames)
    t, h, w, c = frames.shape
    if use_ffmpeg:
        cmd = [
            "ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
            "-r", f"{fps:.02f}", "-s", f"{w}x{h}", "-pix_fmt", "rgb24",
            "-i", "-", "-filter_complex",
            "[0:v]split[x][z];[z]palettegen[y];[x]paletteuse",
            "-r", f"{fps:.02f}", path,
        ]
        try:
            proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
            proc.communicate(frames.tobytes())
            if proc.returncode == 0:
                return
        except OSError:  # no ffmpeg binary
            pass
    write_gif(path, frames, int(1000 / fps))


class SummaryLogger:
    """Scalars to TensorBoard and ``scalars.jsonl``; GIF sequence dumps with
    their first frame as a TensorBoard image."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = tb_events.EventWriter(log_dir)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        row = {"step": int(step)}
        for k, v in values.items():
            row[prefix + k] = float(v)  # a number, numpy or torch scalar
        if values:
            self._tb.add(step, [tb_events.scalar_value(k, v)
                                for k, v in row.items() if k != "step"])
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def gif(self, step: int, tag: str, sequence: np.ndarray, fps: int = 3,
            max_outputs: int = 1) -> None:
        """(B, T, H, W, 3) float [0,1] or uint8 -> ``{tag}_{b}_step{step}.gif``
        files + their first frames as TensorBoard images ``{tag}/{b}``
        (reference gif_summary ops.py:489-517)."""
        seq = np.asarray(sequence)[:max_outputs]
        for b in range(seq.shape[0]):
            path = os.path.join(self.log_dir, f"{tag}_{b}_step{step}.gif")
            encode_gif(seq[b], path, fps=fps)
            self._tb.add(step, [tb_events.image_value(f"{tag}/{b}", _to_uint8(seq[b][0]))])

    def close(self) -> None:
        self._tb.close()
        self._jsonl.close()
