"""The port's spans (``tecogan_tpu_torch/utils/profiling.py:span``) on the
CPU: off, and recording nothing, unless a profiler runs on the calling
thread; under ``torch.profiler.profile`` the spans of ``StreamingSR.run``,
``VSRServer.step`` with its ``HostFrame`` reads, ``Trainer.train_step``
and ``BatchLoader.next_batch``, with their parents, items and counts a
chunk, tick or step, each one a ``tecogan.<name>`` range of the profiler's
trace that starts where the record says on the profiler's clock; the
bounded ring. ``graph.capture`` and ``graph.replay`` need a CUDA graph:
the card test ``test_captured_program_spans`` checks them."""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.config import TECOGAN_PRESET, TecoConfig
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset
from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
from tecogan_tpu_torch.models import FNet, Generator
from tecogan_tpu_torch.models.vgg19 import random_vgg19
from tecogan_tpu_torch.recurrent import StreamingSR
from tecogan_tpu_torch.serve import VSRServer
from tecogan_tpu_torch.train import trainer as trainer_module
from tecogan_tpu_torch.train.trainer import Trainer
from tecogan_tpu_torch.utils import profiling
from tecogan_tpu_torch.utils.profiling import clear, dropped_spans, span, spans

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]
START_TOLERANCE_NS = 1_000_000


def _models():
    torch.manual_seed(0)
    return Generator(num_resblock=1, channels=8), FNet()


def _clip(t, h=16, w=16):
    return (np.random.RandomState(3).rand(t, h, w, 3) * 255).astype(np.uint8)


def _profiled(fn):
    """Run ``fn`` under a CPU profiler from an empty ring; returns the
    profiler and the ring's records."""
    clear()
    with torch.profiler.profile(activities=CPU) as prof:
        fn()
    return prof, spans()


def _check_in_trace(prof, records):
    """Every record is a ``tecogan.<name>`` range of the trace, one range
    a record, starting within a millisecond of the record's start on the
    profiler's clock (``trace_start_ns`` plus the event's start)."""
    base = prof.profiler.kineto_results.trace_start_ns()
    starts = {}
    for evt in prof.events():
        if evt.name.startswith(profiling.SPAN_PREFIX):
            name = evt.name[len(profiling.SPAN_PREFIX):]
            starts.setdefault(name, []).append(base + evt.time_range.start * 1000)
    assert Counter({k: len(v) for k, v in starts.items()}) == Counter(r.name for r in records)
    for r in records:
        assert min(abs(t - r.start_ns) for t in starts[r.name]) < START_TOLERANCE_NS, r
        assert r.end_ns >= r.start_ns


def _by_id(records):
    return {r.id: r for r in records}


def _root(records, record):
    ids = _by_id(records)
    while record.parent is not None:
        record = ids[record.parent]
    return record


def test_span_off_without_a_profiler(monkeypatch):
    """No profiler on the calling thread: no ``record_function`` is
    entered (it raises here) and nothing is recorded, by a bare span or by
    a whole run; a thread other than the profiler's records nothing
    either."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    clear()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("x", item=1, a=2) as s:
        s.set(b=3)
    cfg = TecoConfig(num_resblock=1, gen_channels=8, infer_chunk=3)
    sr = StreamingSR(cfg, *_models(), output="uint8", device="cpu")
    sr.run(_clip(5))
    assert spans() == [] and dropped_spans() == 0
    monkeypatch.undo()

    seen = []
    with torch.profiler.profile(activities=CPU):
        worker = threading.Thread(target=lambda: seen.append(span("y") is span("z")))
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive() and seen == [True]  # the shared no-op
    assert spans() == []


def test_streaming_run_spans():
    """One eager run of 7 frames in chunks of 3: one ``stream.run`` (the
    run's number, its frames and chunk), one ``stream.reset``, and a chunk
    each of upload (its wait inside), copy-out, fetch wait and delivery,
    all under the run and carrying its number."""
    cfg = TecoConfig(num_resblock=1, gen_channels=8, infer_chunk=3)
    sr = StreamingSR(cfg, *_models(), output="uint8", device="cpu")
    sr.run(_clip(7))
    got = []
    prof, records = _profiled(lambda: sr.run(_clip(7), on_chunk=lambda hr, s: got.append(s)))
    assert got == [0, 3, 6] and sr.runs == 2
    assert Counter(r.name for r in records) == Counter({
        "stream.run": 1, "stream.reset": 1, "stream.upload": 3, "stream.upload_wait": 3,
        "stream.copy_out": 3, "stream.fetch_wait": 3, "stream.deliver": 3})
    (run,) = [r for r in records if r.name == "stream.run"]
    assert run.parent is None and run.item == 2
    assert run.attrs == {"frames": 7, "chunk": 3}
    ids = _by_id(records)
    for r in records:
        assert r.item == 2 and _root(records, r) == run
        assert run.start_ns <= r.start_ns and r.end_ns <= run.end_ns
        if r.name == "stream.upload_wait":
            assert ids[r.parent].name == "stream.upload"
        elif r is not run:
            assert r.parent == run.id
    _check_in_trace(prof, records)


def test_server_step_spans():
    """Three ticks of a 3-slot server with 2 streams, read through
    ``HostFrame``: a ``serve.step`` a tick (its number, real frames, slots)
    with its staging, upload and copy-out inside (no stage wait on the
    CPU, where nothing is in flight), and a ``serve.fetch_wait`` a frame
    read, outside the step, carrying the number of the frame's tick."""
    server = VSRServer(TecoConfig(num_resblock=1, gen_channels=8), *_models(), 8, 8,
                       max_streams=3, device="cpu")
    assert server.capture_s == 0.0
    for s in ("a", "b"):
        server.open(s)
    frames = {s: np.full((8, 8, 3), 9, np.uint8) for s in ("a", "b")}
    server.step(frames)

    def ticks():
        for n in (2, 1, 2):
            handles = server.step(dict(list(frames.items())[:n]), fetch=False)
            for h in handles.values():
                assert np.asarray(h).shape == (32, 32, 3)

    prof, records = _profiled(ticks)
    assert Counter(r.name for r in records) == Counter({
        "serve.step": 3, "serve.stage": 3, "serve.upload": 3, "serve.copy_out": 3,
        "serve.fetch_wait": 5})
    steps = [r for r in records if r.name == "serve.step"]
    assert [(r.item, r.attrs) for r in steps] == [
        (1, {"frames": 2, "slots": 3}), (2, {"frames": 1, "slots": 3}),
        (3, {"frames": 2, "slots": 3})]
    by_item = {r.item: r for r in steps}
    for r in records:
        if r.name == "serve.fetch_wait":
            assert r.parent is None and r.start_ns >= by_item[r.item].end_ns
        elif r.name != "serve.step":
            assert r.parent == by_item[r.item].id
    assert Counter(r.item for r in records if r.name == "serve.fetch_wait") == {1: 2, 2: 1, 3: 2}
    _check_in_trace(prof, records)


class _EagerProgram:
    """A stand-in for ``CapturedProgram`` on the CPU: the warm-up runs the
    body, each call runs it again (a replay). A replay runs no Python, so
    the body's spans (the trainer's stages) record nothing in it: the call
    runs the body as a capture sees it."""

    def __init__(self, body, inputs, name):
        body()
        self.body = body

    def __call__(self):
        capturing = profiling._capturing
        profiling._capturing = lambda: True
        try:
            return self.body()
        finally:
            profiling._capturing = capturing

    def close(self):
        self.body = None


def test_train_step_spans(monkeypatch):
    """Two steps of the capturing path, the graph stood in for: a
    ``train.step`` a step (the state's step before it), with the upload's
    wait, the upload and the output's clone inside."""
    monkeypatch.setattr(trainer_module, "CapturedProgram", _EagerProgram)
    cfg = TecoConfig(num_resblock=1, crop_size=8, batch_size=2, rnn_n=3,
                     remat_generator=False, vgg_scaling=-0.002, ratio=-0.01)
    trainer = Trainer(cfg, "cpu")
    trainer.capture = True
    state = trainer.init_state(5)
    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, 3, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
               for _ in range(3)]
    trainer.train_step(state, batches[0])

    def steps():
        for b in batches[1:]:
            trainer.train_step(state, b)

    prof, records = _profiled(steps)
    assert Counter(r.name for r in records) == Counter({
        "train.step": 2, "train.upload_wait": 2, "train.upload": 2, "train.clone": 2})
    top = {r.item: r for r in records if r.name == "train.step"}
    assert sorted(top) == [1, 2] and all(r.parent is None for r in top.values())
    for r in records:
        if r.name != "train.step":
            assert r.parent == top[r.item].id
    _check_in_trace(prof, records)


STAGES = ("train.unroll", "train.vgg", "train.dst", "train.backward", "train.adam",
          "train.d_step")


def _gan_trainer():
    """An eager TecoGAN trainer on the CPU at a tiny size (VGG19 at its real
    widths on 32 x 32 frames) and its batches."""
    cfg = TECOGAN_PRESET.replace(num_resblock=1, gen_channels=8, crop_size=8, batch_size=1,
                                 rnn_n=3)
    trainer = Trainer(cfg, "cpu", vgg=random_vgg19(3))
    rng = np.random.RandomState(1)
    batches = [(rng.rand(1, 3, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
               for _ in range(5)]
    return trainer, trainer.init_state(4), batches


def test_gan_step_stage_spans():
    """An eager TecoGAN step records its stages, once each and in the
    body's order, nested under its ``train.step`` and carrying its item;
    each is a ``tecogan.<name>`` range of the profiler's trace. Without a
    profiler the same step records nothing."""
    trainer, state, batches = _gan_trainer()
    clear()
    trainer.train_step(state, batches[0])
    assert spans() == []
    prof, records = _profiled(lambda: trainer.train_step(state, batches[1]))
    names = Counter(r.name for r in records)
    assert names == Counter({"train.step": 1, "train.upload_wait": 1, "train.upload": 1,
                             **{s: 1 for s in STAGES}})
    (top,) = [r for r in records if r.name == "train.step"]
    assert top.item == 1 and top.parent is None
    stages = sorted((r for r in records if r.name in STAGES), key=lambda r: r.start_ns)
    assert [r.name for r in stages] == list(STAGES)
    for before, after in zip(stages, stages[1:]):
        assert before.end_ns <= after.start_ns
    for r in stages:
        assert r.parent == top.id and r.item == 1
        assert top.start_ns <= r.start_ns and r.end_ns <= top.end_ns
    _check_in_trace(prof, records)


def test_spans_off_while_capturing(monkeypatch):
    """While the current stream captures a graph, a span is the shared
    no-op, profiler or not: a replay runs no Python, so a span in a
    captured body records only when the body runs eagerly. Here no CUDA
    context exists, so nothing captures."""
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    clear()
    with torch.profiler.profile(activities=CPU):
        assert span("train.unroll") is span("train.vgg")
        with span("train.vgg"):
            pass
    assert spans() == []
    monkeypatch.undo()
    assert profiling._capturing() is False


@pytest.mark.parametrize("opened, closed", [(2, 3), (0, 2), (3, 0)])
def test_gate_counts_as_read(opened, closed):
    """The gate's counters, the state's ``counter_with_d`` and
    ``counter_wo_d`` as the benchmark reads them after a run of steps,
    count the steps whose gate was open (the discriminator's update
    applied) and closed: ``opened`` steps with the EMA held under
    ``d_balance``, then ``closed`` above it; FRVSR's state has none."""
    trainer, state, batches = _gan_trainer()
    for i in range(opened + closed):
        state.ema_tbalance.fill_(-100.0 if i < opened else 100.0)
        trainer.train_step(state, batches[i % len(batches)])
    assert (int(state.counter_with_d), int(state.counter_wo_d)) == (opened, closed)
    assert int(state.d_opt.count) == opened
    frvsr = Trainer(TecoConfig(num_resblock=1, crop_size=8, ratio=-0.01, vgg_scaling=-1.0),
                    "cpu")
    assert frvsr.init_state(0).counter_with_d is None


def test_loader_wait_carries_the_producers_stamp(tmp_path):
    """``BatchLoader.next_batch`` (python executor): a ``loader.wait`` a
    batch, with the queue's depth on entry and the batch's production
    milliseconds, stamped by the producer thread, which the profiler does
    not see."""
    root = str(tmp_path / "scenes")
    write_synthetic_scenes(root, 2, 8, 60, 64, start_index=2000)
    cfg = TecoConfig(input_video_dir=root, crop_size=8, rnn_n=4, batch_size=2, max_frm=7,
                     str_dir=2000, end_dir=2001, queue_thread=2)
    with BatchLoader(SceneDataset(cfg), seed=4) as loader:
        first = loader.next_batch()
        prof, records = _profiled(lambda: [loader.next_batch() for _ in range(3)])
    assert first.shape == (2, 4, 40, 40, 3)
    assert [r.name for r in records] == ["loader.wait"] * 3
    for r in records:
        assert r.parent is None and set(r.attrs) == {"depth", "produce_ms"}
        assert 0 <= r.attrs["depth"] <= loader.prefetch
        assert np.isfinite(r.attrs["produce_ms"]) and r.attrs["produce_ms"] > 0
    _check_in_trace(prof, records)


def test_ring_drops_the_oldest_and_counts(monkeypatch):
    """Past its bound the ring drops its oldest records and counts them;
    ``clear`` empties both."""
    monkeypatch.setattr(profiling, "_RING", profiling._SpanRing(4))

    def six():
        for i in range(6):
            with span("s", item=i):
                pass

    _, records = _profiled(six)
    assert [r.item for r in records] == [2, 3, 4, 5] and dropped_spans() == 2
    clear()
    assert spans() == [] and dropped_spans() == 0


@pytest.mark.parametrize("depth", [1, 3])
def test_nested_spans_take_the_items_and_parents_of_their_stack(depth):
    """A span without an item takes its enclosing span's; ``set`` adds
    attributes inside the block; records close innermost first."""
    def nest():
        with span("outer", item="clip-7", k=1) as outer:
            opened = []
            for level in range(depth):
                opened.append(span(f"inner{level}"))
                opened[-1].__enter__()
            for s in reversed(opened):
                s.__exit__(None, None, None)
            outer.set(done=True)

    _, records = _profiled(nest)
    assert [r.name for r in records] == [f"inner{i}" for i in reversed(range(depth))] + ["outer"]
    assert all(r.item == "clip-7" for r in records)
    assert records[-1].attrs == {"k": 1, "done": True}
    chain = {r.name: r for r in records}
    for level in range(depth):
        parent = "outer" if level == 0 else f"inner{level - 1}"
        assert chain[f"inner{level}"].parent == chain[parent].id
