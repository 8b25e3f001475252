"""Live serving: K streams at a fixed frame rate into one ``VSRServer``.

Traffic parameters (``"kind": "live"``): ``lr_height``, ``lr_width``,
``streams`` (K, the pool's slots too), ``fps`` (each stream's arrivals),
``clip_frames`` (each stream loops its own clip forward and back),
``check_upto`` (the latest stream frame the check may sample),
``trace_items`` (ticks the traced run profiles) and ``limits``.

Arrivals are an open loop: stream k's frame j is due at ``t0 + phase_k +
j / fps``, the phases drawn from the seed over one frame period, whatever
the server is doing. Each tick takes the oldest pending frame of every
stream that has one and calls ``step(fetch=False)``; a frame's latency runs
from when it was due to when its HR frame is on the host (the tick's copy
has landed). Frames due after the window's end are not sent; those due
before it are all served, the queue drained after the end. A frame never
delivered (a drain cut after 60 s) counts as failed and as late as the cut.
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

DRAIN_LIMIT_S = 60.0


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 chips: int):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t = traffic
        self.h, self.w, self.k = t["lr_height"], t["lr_width"], t["streams"]
        self.n, self.period = t["clip_frames"], 1.0 / t["fps"]
        rng = random.Random(derive(seed, "sample"))
        upto = t["check_upto"]
        self.check_streams = sorted(rng.sample(range(self.k), min(2, self.k)))
        half = max(3, upto // 2)
        self.check_idx = sorted({0, 1, rng.randrange(2, half), rng.randrange(half, upto)})
        prng = random.Random(derive(seed, "phases"))
        self.phases = [prng.uniform(0.0, self.period) for _ in range(self.k)]
        self.sampled: Dict[int, Dict[int, np.ndarray]] = {s: {} for s in self.check_streams}
        self.end_to_end: Dict[str, float] = {}
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from tecogan_tpu_torch.serve import VSRServer

        cfg, t = self.config, self.traffic
        self.weights = R.make_weights(cfg["num_resblock"], derive(self.seed, "weights"),
                                      self.device, cfg["weights"]["resblock_conv2_gain"])
        gen, fnet = program.models(cfg, self.weights)
        self.server = VSRServer(program.teco_config(cfg), gen, fnet, self.h, self.w,
                                max_streams=self.k, output="uint8", device=self.device)
        g = torch.Generator(self.device).manual_seed(derive(self.seed, "clips"))
        self.clips = [FR.make_clip(g, self.n, self.h, self.w, self.device, t["max_speed"],
                                   t["sway"]).cpu().numpy() for _ in range(self.k)]
        for s in range(self.k):
            self.server.open(s)
        t0 = time.perf_counter()
        self.server.prewarm(np.uint8)
        self.prewarm_s = time.perf_counter() - t0

    def _due(self, s: int, until: float) -> int:
        """Frames of stream ``s`` due before ``until`` (on the window's clock)."""
        first = self.t0 + self.phases[s]
        return 0 if until <= first else int((until - first) / self.period - 1e-12) + 1

    def window(self, seconds: float, tracer) -> None:
        tracer.start()
        self.t0 = t0 = time.perf_counter()
        end = t0 + seconds
        due_total = [self._due(s, end) for s in range(self.k)]
        sent = [0] * self.k
        lat: List[float] = []
        self.ticks: List[tuple] = []  # (frames, host seconds in step)
        while True:
            now = time.perf_counter()
            limit = min(now, end)
            pend = [s for s in range(self.k) if sent[s] < min(self._due(s, limit), due_total[s])]
            if not pend:
                if all(sent[s] >= due_total[s] for s in range(self.k)):
                    break
                nxt = min(t0 + self.phases[s] + sent[s] * self.period
                          for s in range(self.k) if sent[s] < due_total[s])
                time.sleep(max(0.0, nxt - time.perf_counter()))
                continue
            if now > end + DRAIN_LIMIT_S:
                break
            frames = {s: self.clips[s][FR.pingpong_index(sent[s], self.n)] for s in pend}
            with span("tick"):
                th = time.perf_counter()
                handles = self.server.step(frames, fetch=False)
                host = time.perf_counter() - th
                outs = {s: np.asarray(handles[s]) for s in pend}
            done = time.perf_counter()
            for s in pend:
                lat.append(done - (t0 + self.phases[s] + sent[s] * self.period))
                if s in self.sampled and sent[s] in self.check_idx:
                    self.sampled[s][sent[s]] = np.array(outs[s])
                sent[s] += 1
            self.ticks.append((len(pend), host))
            if len(self.ticks) == self.traffic["trace_items"]:
                tracer.stop()
        tracer.stop()
        self.attempted = sum(due_total)
        self.failed = self.attempted - len(lat)
        cut = end + DRAIN_LIMIT_S
        lat += [cut - (t0 + self.phases[s] + j * self.period)
                for s in range(self.k) for j in range(sent[s], due_total[s])]
        self.latencies = np.array(lat)
        self.end_to_end = {"frame_p95_ms": float(np.percentile(self.latencies, 95) * 1e3)}

    def counters(self) -> Dict:
        traced = self.ticks[:self.traffic["trace_items"]]
        frames = sum(f for f, _ in traced)
        return {
            "capture_s": self.prewarm_s,
            "serve_host_ms": sum(h for _, h in traced) / max(len(traced), 1) * 1e3,
            "slot_use_pct": frames / max(len(traced) * self.k, 1) * 100.0,
            "frames_processed": frames,
            "model_flops": frames * frame_flops(self.h, self.w, self.config["num_resblock"]),
            "compute_dtype": self.config["compute_dtype"],
            "chain_shape": (self.k, self.h, self.w),
            "chain_itemsize": 2 if self.config["compute_dtype"] == "bfloat16" else 4,
        }

    def release(self) -> None:
        self.server.release()
        self.server = None

    def reference(self, precision: str = "float32") -> Dict[int, Dict[int, np.ndarray]]:
        """Each checked stream run alone through the plain reference (or the
        control), from its first frame to its last sampled one."""
        out = {}
        with R.float32_math():
            for s in self.check_streams:
                seq = np.stack([self.clips[s][FR.pingpong_index(j, self.n)]
                                for j in range(max(self.check_idx) + 1)])
                got = R.stream(self.weights, torch.from_numpy(seq), self.check_idx,
                               R.Precision(precision))
                out[s] = {j: v.numpy() for j, v in got.items()}
        return out

    def check(self, got: Dict[int, Dict[int, np.ndarray]] = None) -> List[Check]:
        got = self.sampled if got is None else got
        ref = self.reference()
        worst = max(compare_frames(got.get(s, {}), ref[s])["mad_levels"] for s in ref)
        return [Check("mad_levels", worst, self.traffic["limits"]["mad_levels"]),
                Check("frames_missing", float(self.failed), 0.0)]
