"""Each cell's run, the look for a card skipped, with the timed path broken
underneath: ``correct`` has to come out false. The faults a cell can have
(the cells run on one chip, so no exchange between chips can be left out):

- a step that returns its state unchanged;
- half of the batch left out (training: the mean taken over the rest;
  serving: half of the pool's slots never computed);
- an answer altered where it is produced.
"""

import pytest
import torch

from portbench.harness.runner import run_cell

SEED = 2**31 + 101


def _run(manifest, workload, **traffic):
    return run_cell(manifest, workload, SEED, 0.5, False, device="cpu",
                    traffic_overrides=traffic or None)


def _shifted(u8: torch.Tensor) -> torch.Tensor:
    return (u8.int() + 16).clamp(0, 255).to(torch.uint8)


def test_sound_runs_are_correct(tiny_manifest):
    for workload in ("stream_vid4", "stream_2160p", "serve_1080p_live", "train_frvsr_resident"):
        assert _run(tiny_manifest, workload)["correct"], workload


@pytest.mark.parametrize("workload", ["stream_vid4", "stream_2160p"])
def test_stream_state_unchanged(tiny_manifest, monkeypatch, workload):
    from tecogan_tpu_torch.recurrent import inference

    step = inference.generator_step
    monkeypatch.setattr(inference, "generator_step",
                        lambda g, state, lr, flow: (state, step(g, state, lr, flow)[1]))
    assert not _run(tiny_manifest, workload)["correct"]


@pytest.mark.parametrize("workload", ["stream_vid4", "stream_2160p"])
def test_stream_answer_altered(tiny_manifest, monkeypatch, workload):
    from tecogan_tpu_torch.recurrent import inference

    as_output = inference.as_output
    monkeypatch.setattr(inference, "as_output", lambda hr, out: _shifted(as_output(hr, out)))
    assert not _run(tiny_manifest, workload)["correct"]


def test_serve_state_unchanged(tiny_manifest, monkeypatch):
    from tecogan_tpu_torch.serve import engine

    step = engine.frame_step
    monkeypatch.setattr(engine, "frame_step",
                        lambda g, f, state, lr: (state, step(g, f, state, lr)[1]))
    assert not _run(tiny_manifest, "serve_1080p_live")["correct"]


def test_serve_half_the_slots_left_out(tiny_manifest, monkeypatch):
    from tecogan_tpu_torch.serve import engine

    tick = engine.server_tick

    def half(frame_fn, generator, fnet, masks, state, lr):
        keep = lr.shape[0] // 2
        out = tick(frame_fn, generator, fnet, masks, state, lr).clone()
        out[keep:] = 0
        return out

    monkeypatch.setattr(engine, "server_tick", half)
    assert not _run(tiny_manifest, "serve_1080p_live", streams=2)["correct"]


def test_serve_answer_altered(tiny_manifest, monkeypatch):
    from tecogan_tpu_torch.serve import engine

    build = engine.build_frame_fn

    def altered(config, output="uint8"):
        fn = build(config, output)

        def frame_fn(*args):
            state, out = fn(*args)
            return state, _shifted(out)
        return frame_fn

    monkeypatch.setattr(engine, "build_frame_fn", altered)
    assert not _run(tiny_manifest, "serve_1080p_live")["correct"]


def test_train_state_unchanged(tiny_manifest, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = _run(tiny_manifest, "train_frvsr_resident")
    assert not result["correct"]
    assert result["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(tiny_manifest, monkeypatch):
    from tecogan_tpu_torch.train import trainer

    prepare = trainer.prepare_batch
    monkeypatch.setattr(trainer, "prepare_batch",
                        lambda hr, config: prepare(hr[: hr.shape[0] // 2], config))
    assert not _run(tiny_manifest, "train_frvsr_resident")["correct"]


def test_train_loss_altered(tiny_manifest, monkeypatch):
    from tecogan_tpu_torch.train import losses

    content = losses.content_loss
    monkeypatch.setattr(losses, "content_loss", lambda a, b: content(a, b) * 1.5)
    assert not _run(tiny_manifest, "train_frvsr_resident")["correct"]
