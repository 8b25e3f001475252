"""The port's training loop and CLI on the CPU at a tiny size: a run, its
resume, the summaries and checkpoints it leaves, and the CLI's guards."""

import json
import os

import pytest
import torch

from tecogan_tpu_torch.cli.main import build_parser, config_from_args, main
from tecogan_tpu_torch.config import FRVSR_PRESET
from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
from tecogan_tpu_torch.train.checkpoint import latest_step
from tecogan_tpu_torch.train.loop import train

torch.set_num_threads(1)

TINY = dict(num_resblock=2, crop_size=8, batch_size=2, rnn_n=4, max_frm=5,
            queue_thread=2, display_freq=1, summary_freq=2, save_freq=2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two training scenes and one validation scene of 6 frames, 60x64."""
    root = str(tmp_path_factory.mktemp("scenes"))
    write_synthetic_scenes(root, 2, 6, 60, 64, start_index=2000)
    write_synthetic_scenes(root, 1, 6, 60, 64, start_index=2251, seed=7)
    return root


def test_train_then_resume(scenes, tmp_path, capsys):
    cfg = FRVSR_PRESET.replace(input_video_dir=scenes, **TINY)
    out = str(tmp_path / "run")
    state = train(cfg, out, "cpu", max_steps=3)
    assert state.step == 3
    ckpt = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["2", "3"]
    first = {k: float(v) for k, v in state.ema_losses.items()}
    state = train(cfg, out, "cpu", max_steps=5)
    printed = capsys.readouterr().out
    assert "Resumed from step 3" in printed
    assert "step 5: image/sec*frames" in printed
    assert state.step == 5 and latest_step(ckpt) == 5
    assert {k: float(v) for k, v in state.ema_losses.items()} != first
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "learning_rate" in r] == [2, 4]
    assert any("val_l2_content_loss" in r for r in rows)  # scene_2251
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["num_resblock"] == 2


def _argv(scenes, out, *extra):
    return ["--mode", "train", "--preset", "frvsr", "--input_video_dir", scenes,
            "--output_dir", out, "--max_iter", "2", "--num_resblock", "2",
            "--crop_size", "8", "--batch_size", "2", "--rnn_n", "4",
            "--max_frm", "5", "--queue_thread", "2", "--save_freq", "2", *extra]


def test_cli_trains_on_cpu(scenes, tmp_path):
    out = str(tmp_path / "cli")
    main(_argv(scenes, out, "--device", "cpu"))
    assert latest_step(os.path.join(out, "checkpoints")) == 2
    with open(os.path.join(out, "logfile.txt")) as f:
        assert "End of configuration" in f.read()


def test_cli_preset_keeps_its_depth():
    args = build_parser().parse_args(["--mode", "train", "--preset", "frvsr",
                                      "--output_dir", "x"])
    cfg = config_from_args(args)
    assert cfg == FRVSR_PRESET and cfg.num_resblock == 10


def test_cli_guards(scenes, tmp_path, monkeypatch):
    out = str(tmp_path / "guards")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_argv(scenes, out))  # --device defaults to cuda
    with pytest.raises(NotImplementedError, match="item 8"):
        main(_argv(scenes, out, "--device", "cpu", "--ratio", "0.01"))
    with pytest.raises(NotImplementedError, match="item 8"):
        main(_argv(scenes, out, "--device", "cpu", "--vgg_npz", "vgg.npz"))
    # Inference, as the JAX CLI: no weight source exits; video input is
    # not ported yet and names its ROADMAP item.
    with pytest.raises(SystemExit, match="inference needs --checkpoint"):
        main(["--mode", "inference", "--device", "cpu", "--input_dir_LR", scenes,
              "--output_dir", out])
    with pytest.raises(NotImplementedError, match="item 12"):
        main(["--mode", "inference", "--device", "cpu", "--input_video", "clip.mp4",
              "--output_dir", out, "--allow_random_weights"])
    assert latest_step(os.path.join(out, "checkpoints")) is None
