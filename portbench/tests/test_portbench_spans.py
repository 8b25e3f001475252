"""The per-layer readers of the port's spans (``harness/spans.py`` and their
files in ``metrics/``): their arithmetic on made-up span lists, None where
the port recorded nothing or keeps no spans, ``BENCHMARK.json``'s entries
for them, and the readers over the spans of a tiny cell's window run under
a CPU profiler."""

import json

import pytest
import torch

from portbench.harness import spans
from portbench.harness.manifest import ROOT, Manifest
from portbench.harness.trace import Tracer
from tecogan_tpu_torch.utils import profiling
from tecogan_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000  # ns

NEW = {
    "stream_host_ms.stream": ("program_span", "streaming engine", "frames_per_s",
                              "stream_2160p"),
    "stream_host_ms.vid4": ("program_span", "streaming engine", "frames_per_s.vid4",
                            "stream_vid4"),
    "serve_step_ms": ("program_span", "server", "frame_p95_ms", "serve_1080p_live"),
    "serve_fetch_wait_ms": ("program_span", "server", "frame_p95_ms", "serve_1080p_live"),
    "train_host_ms": ("program_span", "training step", "step_ms", "train_frvsr_resident"),
    "loader_get_ms": ("program_span", "data loader", "step_ms", "train_frvsr_resident"),
    "loader_produce_ms": ("program_counter", "data loader", "step_ms", "train_frvsr_resident"),
    "replay_launch_ms.serve": ("program_span", "captured programs", "frame_p95_ms",
                               "serve_1080p_live"),
    "replay_launch_ms.vid4": ("program_span", "captured programs", "frames_per_s.vid4",
                              "stream_vid4"),
    "replay_launch_ms.train": ("program_span", "captured programs", "step_ms",
                               "train_frvsr_resident"),
    "capture_s.serve": ("program_counter", "captured programs", "setup_s", "serve_1080p_live"),
}


class _Spans:
    """Builds made-up records: ``add(name, start_ms, end_ms, parent=...)``."""

    def __init__(self):
        self.records = []

    def add(self, name, start, end, parent=None, item=None, **attrs):
        r = SpanRecord(len(self.records) + 1, name, int(start * MS), int(end * MS),
                       None if parent is None else parent.id, item, 0, attrs)
        self.records.append(r)
        return r


def _read(name, ctx=None):
    return Manifest().reader(name)(ctx or {"trace": None, "counters": {}, "cell": None})


@pytest.fixture
def made_up(monkeypatch):
    s = _Spans()
    monkeypatch.setattr(profiling, "spans", lambda: list(s.records))
    return s


def test_stream_host_less_waits_and_delivery(made_up):
    """A clip's ``stream.run`` less its upload and fetch waits (the upload
    wait counted once, inside the upload) and its deliveries; two clips
    averaged."""
    for base, extra in ((0, 0.0), (100, 4.0)):
        run = made_up.add("stream.run", base, base + 50 + extra, item=base)
        made_up.add("stream.reset", base, base + 1, run)
        up = made_up.add("stream.upload", base + 1, base + 6, run)
        made_up.add("stream.upload_wait", base + 1, base + 3, up)
        made_up.add("graph.replay", base + 6, base + 7, run)
        made_up.add("stream.fetch_wait", base + 10, base + 30, run)
        made_up.add("stream.deliver", base + 30, base + 40, run)
    assert _read("stream_host_ms.vid4") == pytest.approx((18 + 22) / 2)
    assert _read("stream_host_ms.stream") == pytest.approx(20.0)


def test_serve_step_fetch_and_replay(made_up):
    """``serve.step`` less ``serve.stage_wait``; the frames' fetch waits
    summed a tick, over the ticks; the mean replay."""
    for tick, (wait, fetches) in enumerate(((0.5, (20.0, 0.1)), (0.0, (15.0,)))):
        t0 = tick * 100
        step = made_up.add("serve.step", t0, t0 + 3, item=tick, frames=2, slots=5)
        if wait:
            made_up.add("serve.stage_wait", t0, t0 + wait, step)
        made_up.add("graph.replay", t0 + 1, t0 + 1 + 0.05 * (tick + 1), step)
        start = t0 + 3
        for f in fetches:
            made_up.add("serve.fetch_wait", start, start + f, item=tick)
            start += f
    made_up.add("serve.fetch_wait", 500, 530, item=99)  # a tick outside the window
    assert _read("serve_step_ms") == pytest.approx((2.5 + 3.0) / 2)
    assert _read("serve_fetch_wait_ms") == pytest.approx((20.1 + 15.0) / 2)
    assert _read("replay_launch_ms.serve") == pytest.approx(0.075)


def test_train_and_loader(made_up):
    """``train.step`` less ``train.upload_wait``; ``loader.wait`` and the
    producer's stamps, a step on average."""
    for step, (wait, got, made) in enumerate(((1.0, 0.2, 3.0), (0.0, 0.4, 5.0))):
        t0 = step * 30
        made_up.add("loader.wait", t0, t0 + got, depth=2, produce_ms=made)
        top = made_up.add("train.step", t0 + 1, t0 + 3, item=step)
        made_up.add("train.upload_wait", t0 + 1, t0 + 1 + wait, top)
        made_up.add("train.upload", t0 + 1 + wait, t0 + 2.5, top)
        made_up.add("graph.replay", t0 + 2.5, t0 + 2.6, top)
        made_up.add("train.clone", t0 + 2.6, t0 + 2.7, top)
    assert _read("train_host_ms") == pytest.approx((1.0 + 2.0) / 2)
    assert _read("loader_get_ms") == pytest.approx(0.3)
    assert _read("loader_produce_ms") == pytest.approx(4.0)
    assert _read("replay_launch_ms.train") == pytest.approx(0.1)


@pytest.mark.parametrize("name", sorted(n for n in NEW if n != "capture_s.serve"))
def test_nothing_recorded_reads_none(made_up, monkeypatch, name):
    """No span of the metric's (a cell that does not cross the boundary), or
    a port that keeps no spans at all (the parent of this change): None,
    nothing raised."""
    made_up.add("unrelated", 0, 1)
    assert _read(name) is None
    monkeypatch.delattr(profiling, "spans")
    assert spans.records() == [] and _read(name) is None


def test_server_capture_seconds():
    class Server:
        capture_s = 1.25

    class Cell:
        server = Server()

    assert _read("capture_s.serve", {"cell": Cell()}) == 1.25
    Cell.server = object()  # a server that does not count them
    assert _read("capture_s.serve", {"cell": Cell()}) is None
    assert _read("capture_s.serve", {"cell": None}) is None


def test_manifest_entries():
    """The eleven metrics, each listed for its one cell and read by a file
    found by name."""
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in data["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    names = [m["name"] for m in data["per_layer"]]
    assert names[-len(NEW):] == list(NEW)  # appended after the accepted entries
    manifest = Manifest()
    for name, (source, layer, moves, cell) in NEW.items():
        m = got[name]
        assert (m["unit"], m["better"]) == ("s" if name == "capture_s.serve" else "ms", "lower")
        assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
            source, layer, moves, [cell])
        assert name in [p["name"] for p in manifest.per_layer(cell)]
        assert callable(manifest.reader(name))


@pytest.mark.parametrize("workload, metrics", [
    ("stream_vid4", ["stream_host_ms.vid4"]),
    ("serve_1080p_live", ["serve_step_ms", "serve_fetch_wait_ms", "capture_s.serve"]),
    ("train_frvsr_resident", ["train_host_ms", "loader_get_ms", "loader_produce_ms"]),
])
def test_readers_over_a_profiled_window(tiny_manifest, workload, metrics):
    """A tiny cell's window on the CPU under a CPU profiler: the port's
    spans are recorded and every reader of the cell's that does not need a
    CUDA graph reads a number (the replays' need the card: None here)."""
    traffic = tiny_manifest.traffic(tiny_manifest.workload(workload)["traffic"])
    cfg = tiny_manifest.config(tiny_manifest.workload(workload)["config"])
    cell = tiny_manifest.kind(traffic["kind"]).Cell(cfg, dict(traffic, trace_items=2), 7,
                                                    torch.device("cpu"), 1)
    cell.setup()
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            cell.window(0.5, Tracer(False))
        ctx = {"trace": None, "counters": cell.counters(), "cell": cell}
        for name in metrics:
            value = tiny_manifest.reader(name)(ctx)
            assert value is not None and value >= 0, name
        replay = [m for m in tiny_manifest.per_layer(workload)
                  if m["name"].startswith("replay_launch_ms")]
        assert replay and all(tiny_manifest.reader(m["name"])(ctx) is None for m in replay)
    finally:
        cell.release()
        profiling.clear()
