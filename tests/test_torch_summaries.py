"""The port's summaries against the JAX package's on the CPU: the GIF
writer against PIL's (through the JAX ``encode_gif``), the TensorBoard event
file against tensorboardX's (read with its protobufs and CRC), the JSONL
rows, the loop's four sequence GIFs, ``Trainer.generate`` as a program
against the direct body and the JAX ``_generate_impl``, and the profiling
utilities."""

import collections
import io
import json
import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from tensorboardX.proto import event_pb2
from tensorboardX.record_writer import masked_crc32c

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.train import Trainer as JaxTrainer
from tecogan_tpu.utils.summaries import SummaryLogger as JaxSummaryLogger
from tecogan_tpu.utils.summaries import encode_gif as jax_encode_gif
from tecogan_tpu_torch.config import FRVSR_PRESET, TecoConfig
from tecogan_tpu_torch.data.png import read_png
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.train.loop import SUMMARY_TAGS, train
from tecogan_tpu_torch.train.trainer import _generate_body
from tecogan_tpu_torch.utils import SummaryLogger, encode_gif, tb_events
from tecogan_tpu_torch.utils.profiling import (
    device_time,
    device_time_samples,
    sync,
    trace,
)
from tecogan_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

# The port's GIF may lose at most this much PSNR a frame against PIL's on
# the same frames (its palette is one median cut over all frames, PIL's one
# a frame).
GIF_PSNR_SLACK_DB = 1.0
# generate against the JAX package's: test_torch_train.py's tolerance.
GENERATE_ATOL = 1e-5


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else np.inf


def _read_gif(path):
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return np.stack(frames), durations, im.info.get("loop"), im.size


@pytest.mark.parametrize("content", ["natural", "grating", "few colours"])
@pytest.mark.parametrize("as_float", [False, True])
def test_gif_matches_pil(tmp_path, content, as_float):
    if content == "few colours":
        rng = np.random.RandomState(1)
        clip = rng.randint(0, 4, (10, 24, 40, 3)).astype(np.float32) / 3.0
    else:
        clip = synthetic_clip(10, 64, 80, seed=3, content=content)
    source = np.clip(clip * 255.0, 0, 255).astype(np.uint8)  # the float route's truncation
    frames = clip if as_float else source
    ours, pils = str(tmp_path / "ours.gif"), str(tmp_path / "pil.gif")
    encode_gif(frames, ours, fps=3)
    jax_encode_gif(frames, pils, fps=3)
    got, got_dur, got_loop, got_size = _read_gif(ours)
    want, want_dur, want_loop, want_size = _read_gif(pils)
    assert got.shape == want.shape == source.shape
    assert (got_dur, got_loop, got_size) == (want_dur, want_loop, want_size)
    assert got_dur == [330] * 10 and got_loop == 0
    for t in range(len(source)):
        assert _psnr(got[t], source[t]) >= _psnr(want[t], source[t]) - GIF_PSNR_SLACK_DB, t
    if content == "few colours":  # at most 256 colours: exact
        np.testing.assert_array_equal(got, source)


def test_gif_ffmpeg_falls_through(tmp_path, monkeypatch):
    """Without an ffmpeg binary the pipe fails and the port's writer runs."""
    monkeypatch.setenv("PATH", str(tmp_path))
    path = str(tmp_path / "x.gif")
    clip = (synthetic_clip(3, 16, 16, seed=0) * 255).astype(np.uint8)
    encode_gif(clip, path, fps=5, use_ffmpeg=True)
    frames, durations, _, _ = _read_gif(path)
    assert frames.shape == clip.shape and durations == [200] * 3


def _events(path):
    """Every Event of a TFRecord file, each CRC checked with tensorboardX's."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == masked_crc32c(header)
        body = data[pos + 12:pos + 12 + length]
        assert struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0] \
            == masked_crc32c(body)
        event = event_pb2.Event()
        event.ParseFromString(body)
        out.append(event)
        pos += 16 + length
    return out


def _summaries(log_dir):
    """The (tag, step, value) multiset of a log dir's one event file: scalar
    values, images as (height, width, colorspace, pixels)."""
    files = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents.")]
    assert len(files) == 1, files
    events = _events(os.path.join(log_dir, files[0]))
    assert events[0].file_version == "brain.Event:2"
    items = collections.Counter()
    for e in events[1:]:
        for v in e.summary.value:
            if v.HasField("image"):
                img = v.image
                pixels = np.asarray(Image.open(io.BytesIO(img.encoded_image_string)).convert("RGB"))
                items[(v.tag, e.step, (img.height, img.width, img.colorspace,
                                       pixels.tobytes()))] += 1
            else:
                items[(v.tag, e.step, v.simple_value)] += 1
    return items


def _log_calls(logger, seq_float, seq_u8):
    logger.scalars(1, {"l2_content_loss": 0.5, "learning_rate": np.float32(1e-4)})
    logger.scalars(2, {"l2_content_loss": torch.tensor(0.25)}, prefix="val_")
    logger.scalars(3, {"withD_counter": 3, "t_balance_EMA": -0.125})
    logger.gif(4, "GeneratedHR", seq_float, max_outputs=1)
    logger.gif(4, "InputLR", seq_u8, max_outputs=2)
    logger.close()


def test_summary_logger_matches_tensorboardx(tmp_path):
    rng = np.random.RandomState(0)
    seq_float = rng.rand(2, 4, 16, 20, 3).astype(np.float32)
    seq_u8 = (rng.rand(3, 4, 8, 8, 3) * 255).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "jax")
    _log_calls(SummaryLogger(ours), seq_float, seq_u8)
    _log_calls(JaxSummaryLogger(theirs), seq_float, seq_u8)
    got, want = _summaries(ours), _summaries(theirs)
    assert got == want
    assert sum(1 for k in got if k[0] in ("GeneratedHR/0", "InputLR/0", "InputLR/1")) == 3
    # The image summary is the first frame, as the port's PNG reader reads it.
    (tag_event,) = [e for e in _events(os.path.join(ours, next(
        f for f in os.listdir(ours) if f.startswith("events"))))
        if any(v.tag == "GeneratedHR/0" for v in e.summary.value)]
    png = tag_event.summary.value[0].image.encoded_image_string
    path = str(tmp_path / "first.png")
    with open(path, "wb") as f:
        f.write(png)
    np.testing.assert_array_equal(read_png(path),
                                  np.clip(seq_float[0, 0] * 255, 0, 255).astype(np.uint8))
    # JSONL rows and GIF names as the JAX package's.
    for d in (ours, theirs):
        assert sorted(f for f in os.listdir(d) if f.endswith(".gif")) == [
            "GeneratedHR_0_step4.gif", "InputLR_0_step4.gif", "InputLR_1_step4.gif"]
    rows = [[json.loads(line) for line in open(os.path.join(d, "scalars.jsonl"))]
            for d in (ours, theirs)]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert tb_events.read_records(os.path.join(ours, next(
        f for f in os.listdir(ours) if f.startswith("events"))))


def test_train_writes_sequence_gifs(tmp_path):
    """A tiny CPU train() whose save_freq is hit writes the four tags' GIFs
    of the batch just stepped, and their first frames as images."""
    scenes = str(tmp_path / "scenes")
    write_synthetic_scenes(scenes, 2, 6, 60, 64, start_index=2000)
    cfg = FRVSR_PRESET.replace(input_video_dir=scenes, num_resblock=2, crop_size=8,
                               batch_size=2, rnn_n=4, max_frm=5, queue_thread=2,
                               summary_freq=2, save_freq=2)
    out = str(tmp_path / "run")
    train(cfg, out, "cpu", max_steps=3, test_while_train=False)
    log = os.path.join(out, "log")
    gifs = sorted(f for f in os.listdir(log) if f.endswith(".gif"))
    assert gifs == sorted(f"{tag}_0_step{s}.gif" for tag in SUMMARY_TAGS for s in (2, 3))
    frames, durations, loop, size = _read_gif(os.path.join(log, "GeneratedHR_0_step2.gif"))
    assert frames.shape == (4, 32, 32, 3) and loop == 0 and size == (32, 32)
    assert _read_gif(os.path.join(log, "WarpPreGen_0_step3.gif"))[0].shape == (3, 32, 32, 3)
    items = _summaries(log)
    assert {(k[0], k[1]) for k in items if k[0].endswith("/0")} == {
        (f"{tag}/0", s) for tag in SUMMARY_TAGS for s in (2, 3)}
    assert ("learning_rate", 2) in {(k[0], k[1]) for k in items}


TINY = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, ratio=-0.01,
            vgg_scaling=-0.002, learning_rate=1e-3, remat_generator=False)


@pytest.fixture(scope="module")
def jax_generated():
    """The port's init as JAX parameters, a uint8 batch, and the JAX
    package's ``_generate_impl`` on them (only the two parameter trees of
    its state are read)."""
    cfg = JaxConfig(**TINY)
    state = Trainer(TecoConfig(**TINY), "cpu").init_state(0)
    init = to_jax_params(state.generator, state.fnet)
    rng = np.random.RandomState(5)
    batch = (rng.rand(2, 4, cfg.hr_load_size, cfg.hr_load_size, 3) * 255).astype(np.uint8)
    impl = JaxTrainer(cfg)._generate_impl
    out = jax.jit(lambda g, f, b: impl(types.SimpleNamespace(gen_params=g, fnet_params=f), b))(
        *init, jnp.asarray(batch))
    return init, batch, [np.asarray(x) for x in jax.device_get(out)]


def test_generate_program_matches_direct_and_jax(jax_generated):
    init, batch, want = jax_generated
    trainer = Trainer(TecoConfig(**TINY), "cpu", capture=False)
    state = trainer.state_from_modules(*from_jax_params(*init))
    got = trainer.generate(state, batch)
    again = trainer.generate(state, batch)  # the same program, replayed
    direct = _generate_body(trainer, state, torch.from_numpy(batch))
    assert [k[0] for k in trainer._programs] == ["generate"]
    for g, a, d, w in zip(got, again, direct, want):
        assert g.shape == w.shape
        assert torch.equal(g, d) and torch.equal(a, d)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GENERATE_ATOL)


def test_generate_leaves_the_train_program_alone(jax_generated):
    """A generate between two steps changes neither step: the same state as
    two steps with none between, and one train program."""
    init, batch, _ = jax_generated
    rng = np.random.RandomState(9)
    other = (rng.rand(*batch.shape) * 255).astype(np.uint8)
    finals = []
    for with_generate in (False, True):
        trainer = Trainer(TecoConfig(**TINY), "cpu")
        state = trainer.state_from_modules(*from_jax_params(*init))
        trainer.train_step(state, batch)
        if with_generate:
            trainer.generate(state, other)
        trainer.train_step(state, batch)
        assert trainer.recaptures == 0
        assert sum(k[0] == "train" for k in trainer._programs) == 1
        finals.append([p.detach().clone() for p in state.generator.parameters()]
                      + [t.clone() for t in state.ema_losses.values()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))


def test_profiling_utils(tmp_path):
    """As the JAX package's (tests/test_cli.py's profiler test), on the CPU."""
    def f(x):
        return x * 2 + 1

    x = torch.ones(8, 8)
    assert device_time(f, x, iters=3, warmup=1) > 0
    samples = device_time_samples(f, x, iters=2, warmup=1, passes=3)
    assert len(samples) == 3 and all(s > 0 for s in samples)
    assert sync({"a": f(x)}) == 192.0 and sync([]) == 0.0
    with trace(str(tmp_path / "tr")):
        float(f(torch.ones(())).sum())
    assert any((tmp_path / "tr").rglob("*"))
