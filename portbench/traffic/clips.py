"""Offline streaming: whole clips through ``StreamingSR.run``, back to back.

Traffic parameters (``traffic/<name>.json``, ``"kind": "clips"``):
``metric`` (the name of the cell's rate in ``BENCHMARK.json``), ``lr_height``, ``lr_width``, ``clip_frames`` (delivered frames a clip),
``warmup`` (reversed frames prepended and dropped, the reference's
protocol), ``chunk``, ``distinct_clips`` (clips drawn from the seed and
run in turn), ``max_speed`` / ``sway`` (motion in LR pixels a frame),
``trace_items`` (clips the traced run profiles), ``check_frames`` (the
delivered frames of a clip the check may sample, from its first) and
``limits``.

The window runs clips until ``--seconds`` have passed (and at least until
the checked clip has run); ``frames_per_s`` is every HR frame handed to
``on_chunk`` over the window's wall time. The check compares frames of one
clip, drawn from the seed among the window's second and third, with the
plain reference run over the same clip from its first frame: the last
frame of the first chunk and the first of the second (the state across a
chunk boundary), the last frame the check may sample (the state through
the clip, from the zero state the run starts from after an earlier clip)
and one more drawn from the seed.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import frames as FR
from portbench.harness import program
from portbench.harness.flops import frame_flops
from portbench.harness.runner import Check
from portbench.harness.seeds import derive
from portbench.harness.trace import span
from portbench.reference import model as R
from portbench.reference.compare import compare_frames


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 chips: int):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = traffic
        self.h, self.w, self.n = t["lr_height"], t["lr_width"], t["clip_frames"]
        self.warmup, self.chunk = t["warmup"], t["chunk"]
        rng = random.Random(derive(seed, "sample"))
        self.check_run = 1 + rng.randrange(2)
        boundary = self.chunk - self.warmup  # delivered index of chunk 2's first frame
        upto = t["check_frames"]
        self.keep = sorted({boundary - 1, boundary, upto - 1, rng.randrange(upto)})
        self.sampled: Dict[int, np.ndarray] = {}
        self.end_to_end: Dict[str, float] = {}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from tecogan_tpu_torch.recurrent.inference import StreamingSR

        cfg, t = self.config, self.traffic
        self.weights = R.make_weights(cfg["num_resblock"], derive(self.seed, "weights"),
                                      self.device, cfg["weights"]["resblock_conv2_gain"])
        gen, fnet = program.models(cfg, self.weights)
        self.sr = StreamingSR(program.teco_config(cfg, infer_chunk=self.chunk), gen, fnet,
                              output="uint8", device=self.device)
        g = torch.Generator(self.device).manual_seed(derive(self.seed, "clips"))
        self.clips = [FR.with_warmup(FR.make_clip(g, self.n, self.h, self.w, self.device,
                                                  t["max_speed"], t["sway"]),
                                     self.warmup).cpu().numpy()
                      for _ in range(t["distinct_clips"])]
        # Warm-up: the chunk shape's static buffers and captured graph, the
        # pinned staging and output buffers.
        self.sr.run(self.clips[-1], warmup=self.warmup, chunk=self.chunk,
                    on_chunk=lambda hr, start: None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _run(self, clip: np.ndarray, keep: List[int]) -> int:
        delivered = 0

        def on_chunk(hr: np.ndarray, start: int) -> None:
            nonlocal delivered
            first = start - self.warmup
            for k in keep:
                if first <= k < first + len(hr):
                    self.sampled[k] = np.array(hr[k - first])
            delivered += len(hr)

        self.sr.run(clip, warmup=self.warmup, chunk=self.chunk, on_chunk=on_chunk)
        return delivered

    def window(self, seconds: float, tracer) -> None:
        runs = delivered = 0
        t0 = time.perf_counter()
        tracer.start()
        while True:
            keep = self.keep if runs == self.check_run else []
            with span("clip"):
                delivered += self._run(self.clips[runs % len(self.clips)], keep)
            runs += 1
            if runs == self.traffic["trace_items"]:
                tracer.stop()
            if time.perf_counter() - t0 >= seconds and runs > self.check_run:
                break
        tracer.stop()
        elapsed = time.perf_counter() - t0
        self.runs = runs
        self.attempted = runs * self.n
        self.failed = self.attempted - delivered
        self.end_to_end = {self.traffic["metric"]: delivered / elapsed}

    def counters(self) -> Dict:
        traced = min(self.runs, self.traffic["trace_items"])
        processed = traced * (self.n + self.warmup)
        return {
            "capture_s": self.sr.capture_s,
            "frames_processed": processed,
            "model_flops": processed * frame_flops(self.h, self.w, self.config["num_resblock"]),
            "compute_dtype": self.config["compute_dtype"],
            "chain_shape": (1, self.h, self.w),
            "chain_itemsize": 2 if self.config["compute_dtype"] == "bfloat16" else 4,
        }

    def release(self) -> None:
        self.sr = None

    def reference(self, precision: str = "float32") -> Dict[int, np.ndarray]:
        """The plain reference's (or, in ``fp8``, the control's) frames at the
        sampled indices of the checked clip."""
        frames = torch.from_numpy(self.clips[self.check_run % len(self.clips)])
        with R.float32_math():
            out = R.stream(self.weights, frames, [k + self.warmup for k in self.keep],
                           R.Precision(precision))
        return {k - self.warmup: v.numpy() for k, v in out.items()}

    def check(self, got: Dict[int, np.ndarray] = None) -> List[Check]:
        """The sampled frames (the program's, or ``got`` in their place)
        against the reference."""
        nums = compare_frames(self.sampled if got is None else got, self.reference())
        limits = self.traffic["limits"]
        return [Check("mad_levels", nums["mad_levels"], limits["mad_levels"]),
                Check("frames_missing", float(self.failed), 0.0)]
