"""The port's training loop and CLI on the CPU at a tiny size: a run, its
resume, the summaries and checkpoints it leaves, TecoGAN training through
the CLI, and the CLI's guards."""

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
    # A compute dtype other than float32 and bfloat16 is refused, and the
    # VGG term needs weights, as in the JAX CLI.
    with pytest.raises(ValueError, match="compute_dtype"):
        main(_argv(scenes, out, "--device", "cpu", "--ratio", "0.01",
                   "--compute_dtype", "float16"))
    with pytest.raises(SystemExit, match="--vgg_npz"):
        main(_argv(scenes, out, "--device", "cpu", "--vgg_scaling", "0.2"))
    # Inference, as the JAX CLI: no weight source exits; a missing video
    # input raises FileNotFoundError.
    with pytest.raises(SystemExit, match="inference needs --checkpoint"):
        main(["--mode", "inference", "--device", "cpu", "--input_dir_LR", scenes,
              "--output_dir", out])
    with pytest.raises(FileNotFoundError, match="clip.mp4"):
        main(["--mode", "inference", "--device", "cpu", "--input_video", "clip.mp4",
              "--output_dir", out, "--allow_random_weights"])
    assert latest_step(os.path.join(out, "checkpoints")) is None


def _mini_argv(scenes, out, *extra):
    return ["--mode", "train", "--preset", "mini", "--device", "cpu",
            "--input_video_dir", scenes, "--output_dir", out, "--max_iter", "2",
            "--num_resblock", "2", "--crop_size", "8", "--batch_size", "2",
            "--rnn_n", "3", "--max_frm", "5", "--queue_thread", "2", "--save_freq", "2",
            "--summary_freq", "1", "--display_freq", "1", "--no_test_while_train", *extra]


def test_cli_trains_tecogan_with_random_vgg(scenes, tmp_path, capsys):
    """--preset mini (TecoGAN, 10 blocks cut to 2 here) with random VGG19
    weights: the run warns, trains the discriminator and writes the gate's
    scalars and the GAN losses' EMAs to scalars.jsonl, every summary_freq."""
    out = str(tmp_path / "mini")
    main(_mini_argv(scenes, out, "--allow_random_weights"))
    printed = capsys.readouterr().out
    assert "WARNING: random VGG19 weights" in printed
    assert "Scope tdiscriminator:" in printed
    assert latest_step(os.path.join(out, "checkpoints")) == 2
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    gate = [r for r in rows if "t_balance_EMA" in r]
    assert [r["step"] for r in gate] == [1, 2]
    assert gate[-1]["withD_counter"] + gate[-1]["w_o_D_counter"] == 2
    keys = set().union(*rows)
    for k in ("vgg_all", "t_adversarial_loss", "t_discrim_loss", "D_layer_loss_sum",
              "PingPang", "Dst_ratio", "val_t_discrim_loss"):
        assert k in keys, k


def test_cli_vgg_npz_missing_exits(scenes, tmp_path):
    """vgg_scaling > 0 without --vgg_npz or --allow_random_weights exits
    with the JAX CLI's message before training; a --vgg_npz that is not
    there raises."""
    out = str(tmp_path / "novgg")
    with pytest.raises(SystemExit, match="--vgg_npz .or --allow_random_weights. required"):
        main(_mini_argv(scenes, out))
    with pytest.raises(FileNotFoundError):
        main(_mini_argv(scenes, out, "--vgg_npz", str(tmp_path / "absent.npz")))
    assert latest_step(os.path.join(out, "checkpoints")) is None
