"""The live cell's open-loop scheduler against fake servers: a stall shows
in the 95th percentile, frames never delivered count as failed, and the
ticks take the oldest pending frame of every stream."""

import time

import numpy as np
import torch

from portbench.harness.manifest import Manifest
from portbench.traffic import live


class _NoTrace:
    def start(self):
        pass

    def stop(self):
        pass


class FakeServer:
    """Returns each frame's mean as its 'HR frame' at once, except that the
    tick numbered ``stall_at`` sleeps ``stall_s`` first; ``every_s`` delays
    every tick."""

    def __init__(self, stall_at=-1, stall_s=0.0, every_s=0.0):
        self.stall_at, self.stall_s, self.every_s = stall_at, stall_s, every_s
        self.calls = []

    def step(self, frames, fetch=True):
        if len(self.calls) == self.stall_at:
            time.sleep(self.stall_s)
        time.sleep(self.every_s)
        self.calls.append(sorted(frames))
        return {s: np.full((1,), f.mean()) for s, f in frames.items()}

    def release(self):
        pass


def _cell(server, streams=2, fps=30.0):
    traffic = dict(Manifest().traffic("live_1080p"), streams=streams, fps=fps,
                   lr_height=4, lr_width=4, clip_frames=8, check_upto=8)
    cell = live.Cell({"num_resblock": 1, "compute_dtype": "float32"}, traffic, 5,
                     torch.device("cpu"), 1)
    cell.server, cell.prewarm_s = server, 0.0
    rng = np.random.default_rng(0)
    cell.clips = [rng.integers(0, 255, (8, 4, 4, 3), dtype=np.uint8) for _ in range(streams)]
    return cell


def test_steady_server_keeps_up():
    cell = _cell(FakeServer())
    cell.window(1.0, _NoTrace())
    assert cell.failed == 0
    assert cell.attempted == 60
    assert cell.end_to_end["frame_p95_ms"] < 20.0
    # Each stream's frames go in order, one per tick at most.
    assert all(len(set(c)) == len(c) for c in cell.server.calls)


def test_stall_shows_in_the_tail():
    steady = _cell(FakeServer())
    steady.window(1.0, _NoTrace())
    stalled = _cell(FakeServer(stall_at=3, stall_s=0.4))
    stalled.window(1.0, _NoTrace())
    assert stalled.failed == 0
    # The stall delays the frames due while it lasts, about 12 a stream.
    assert stalled.end_to_end["frame_p95_ms"] > 250.0
    assert stalled.end_to_end["frame_p95_ms"] > 10 * steady.end_to_end["frame_p95_ms"]
    # Frames that waited are served together once the stall ends.
    assert max(len(c) for c in stalled.server.calls) == 2


def test_undelivered_frames_fail(monkeypatch):
    monkeypatch.setattr(live, "DRAIN_LIMIT_S", 0.2)
    cell = _cell(FakeServer(every_s=0.1), streams=2, fps=30.0)
    cell.window(0.6, _NoTrace())
    assert cell.attempted == 36
    assert cell.failed > 0
    assert len(cell.latencies) == cell.attempted
    # An undelivered frame counts as late as the cut, past the window.
    assert cell.end_to_end["frame_p95_ms"] > 200.0


def test_slot_use_counts_real_frames():
    cell = _cell(FakeServer(), streams=3, fps=20.0)
    cell.window(0.5, _NoTrace())
    frames = sum(f for f, _ in cell.ticks)
    assert frames == cell.attempted
    c = cell.counters()
    assert c["slot_use_pct"] == frames / (len(cell.ticks) * 3) * 100.0
