"""The port's run-case CLI against the JAX package's on the CPU: the
parity gate's CSV reader and comparison, its refusal without a model, the
case-3 wiring and FRVSR discovery, case 0's recipe, and cases 4 -> 3 and
1 -> 2 end to end through ``run.main`` with ``--device cpu``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import run as jax_run
from tecogan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tecogan_tpu_torch.cli import run
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.png import write_png
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes
from tecogan_tpu_torch.eval.suite import write_csv
from tecogan_tpu_torch.models.vgg19 import random_vgg19
from tecogan_tpu_torch.train import Trainer
from tecogan_tpu_torch.train.checkpoint import latest_step, save_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_text(text: str) -> str:
    return text.replace("tecogan_tpu.cli", "tecogan_tpu_torch.cli")


def test_frameavg_csv_and_compare_parity(tmp_path, capsys):
    """The stacked-block metrics.csv as the port's suite writes it (and the
    reference's metrics.py): both readers and both gates agree."""
    csv = str(tmp_path / "metrics.csv")
    write_csv(csv, {"PSNR_00": np.array([25.0, 26.0])})
    write_csv(csv, {"Avg_PSNR": np.array([25.5])}, mode="a")
    write_csv(csv, {"FolderAvg_PSNR": np.array([25.5]), "FolderAvg_tOF": np.array([2.2])},
              mode="a")
    write_csv(csv, {"FrameAvg_PSNR": np.array([25.5]), "FrameAvg_tOF": np.array([2.2])},
              mode="a")
    ref = run.read_frameavg_csv(csv)
    assert ref == jax_run.read_frameavg_csv(csv) == {"FrameAvg_PSNR": 25.5, "FrameAvg_tOF": 2.2}
    for ours in ({"FrameAvg_PSNR": 25.45, "FrameAvg_tOF": 2.23},
                 {"FrameAvg_PSNR": 25.29, "FrameAvg_tOF": 2.2},
                 {"FrameAvg_PSNR": 25.5, "FrameAvg_tOF": 2.35}):
        for r in (ref, {"FrameAvg_PSNR": 25.5}, {}):
            got = run.compare_parity(ours, r)
            got_out = capsys.readouterr().out
            assert got == jax_run.compare_parity(ours, r)
            assert got_out == capsys.readouterr().out


def test_parity_gate_requires_model(tmp_path, capsys):
    assert run.case_parity(str(tmp_path), ["calendar"], []) == 2
    got = capsys.readouterr().out
    assert jax_run.case_parity(str(tmp_path), ["calendar"], []) == 2
    assert got == _port_text(capsys.readouterr().out)
    assert "tecogan_tpu_torch.cli.run 0" in got


def _both(capsys, fn_name, *args, **kw):
    got = getattr(run, fn_name)(*args, **kw)
    got_out = capsys.readouterr().out
    want = getattr(jax_run, fn_name)(*args, **kw)
    assert got_out == _port_text(capsys.readouterr().out)
    return got, want


def test_case3_chain_flags_match_jax(tmp_path, capsys):
    root = str(tmp_path)
    layouts = []
    vgg = os.path.join(root, "model", "vgg_19.npz")
    frvsr = os.path.join(root, "model", "ourFRVSR.npz")
    calls = [([], False), ([], True), (["--allow_random_weights"], False),
             (["--vgg_npz", "v", "--pre_trained_dir", "d"], False),
             (["--allow_random_weights"], True), (["--checkpoint", "c"], False)]
    for step in ("nothing", "vgg", "frvsr", "no vgg"):
        if step == "vgg":
            os.makedirs(os.path.dirname(vgg))
            open(vgg, "wb").close()
        elif step == "frvsr":
            open(frvsr, "wb").close()
        elif step == "no vgg":
            os.remove(vgg)
        for extra, scratch in calls:
            got, want = _both(capsys, "_case3_chain_flags", root, extra, from_scratch=scratch)
            assert got == want
            layouts.append(got)
    assert layouts[0] is None and ["--vgg_npz", vgg, "--pre_trained_dir", frvsr] in layouts


def test_find_frvsr_weights_matches_jax(tmp_path, capsys):
    """The same layouts, each package's own checkpoints: none, an empty
    ``ex_FRVSR*`` dir, a case-4 run's checkpoints, the converted npz."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    for root in (ours, theirs):
        os.makedirs(os.path.join(root, "ex_FRVSR_old", "checkpoints"))
    assert run._find_frvsr_weights(ours) is None is jax_run._find_frvsr_weights(theirs)
    cfg = TecoConfig(num_resblock=2, crop_size=8, batch_size=2, rnn_n=3,
                     ratio=-0.01, vgg_scaling=-0.002, remat_generator=False)
    state = Trainer(cfg, "cpu").init_state(0)
    state.step = 2
    save_checkpoint(os.path.join(ours, "ex_FRVSRmm-dd-hh", "checkpoints"), state)
    jax_save_checkpoint(os.path.join(theirs, "ex_FRVSRmm-dd-hh", "checkpoints"),
                        {"w": jnp.zeros(2)}, 2)
    for root, fn in ((ours, run._find_frvsr_weights), (theirs, jax_run._find_frvsr_weights)):
        assert fn(root) == os.path.join(root, "ex_FRVSRmm-dd-hh", "checkpoints")
        npz = os.path.join(root, "model", "ourFRVSR.npz")
        os.makedirs(os.path.dirname(npz))
        open(npz, "wb").close()
        assert fn(root) == npz


def test_case0_prints_the_recipe(tmp_path, capsys):
    run.main(["0", "--root", str(tmp_path)])
    got = capsys.readouterr().out
    jax_run.main(["0", "--root", str(tmp_path)])
    assert got == _port_text(capsys.readouterr().out)
    assert "Network downloads disabled" in got and "np.savez('model/vgg_19.npz'" in got
    assert all(url in got for url, _ in run.PRETRAINED_URLS)
    assert not os.listdir(tmp_path)  # nothing fetched, nothing made


def _write_vgg_npz(path):
    """Random VGG19 weights under the TF-slim names case 0's recipe writes."""
    flat = {}
    for name, conv in random_vgg19(3).convs.items():
        flat[f"vgg_19/conv{name[4]}/{name}/weights"] = conv.weight.detach().permute(
            2, 3, 1, 0).numpy()
        flat[f"vgg_19/conv{name[4]}/{name}/biases"] = conv.bias.detach().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


@pytest.fixture
def children(monkeypatch):
    """The children find the port from any directory."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.chdir(REPO)


def test_run_case4_then_case3_end_to_end(tmp_path, children):
    """The published recipe through the CLI on synthetic scenes (JAX:
    tests/test_cli.py's case 4 -> 3 test): case 4 trains FRVSR; case 3 finds
    its checkpoints and the converted VGG npz by itself and warm-starts one
    block deeper (the partial restore)."""
    root = str(tmp_path)
    write_synthetic_scenes(os.path.join(root, "TrainingDataPath"), num_scenes=3,
                           num_frames=12, height=96, width=112, start_index=2000)
    _write_vgg_npz(os.path.join(root, "model", "vgg_19.npz"))
    tiny = ["--num_resblock", "2", "--crop_size", "8", "--batch_size", "2",
            "--rnn_n", "3", "--max_iter", "2", "--str_dir", "2000",
            "--end_dir", "2001", "--end_dir_val", "2002", "--max_frm", "11",
            "--queue_thread", "2", "--no_test_while_train", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        run.main(["4", "--root", root] + tiny)
    assert e.value.code == 0
    ck = os.path.join(root, "ex_FRVSRmm-dd-hh", "checkpoints")
    assert latest_step(ck) == 2
    tiny3 = list(tiny)
    tiny3[tiny3.index("--num_resblock") + 1] = "3"
    with pytest.raises(SystemExit) as e:
        run.main(["3", "--root", root] + tiny3)
    assert e.value.code == 0
    with open(os.path.join(root, "ex_TecoGANmm-dd-hh", "log", "logfile.txt")) as f:
        text = f.read()
    assert f"Warm-started weights from {ck}" in text
    assert "warm_start: partial generator restore" in text and "zero-filled" in text
    assert "vgg_npz: " + os.path.join(root, "model", "vgg_19.npz") in text
    assert latest_step(os.path.join(root, "ex_TecoGANmm-dd-hh", "checkpoints")) == 2
    log = os.path.join(root, "ex_TecoGANmm-dd-hh", "log")
    assert any(f.startswith("GeneratedHR_0_step2") for f in os.listdir(log))


def test_run_case1_then_case2_end_to_end(tmp_path, children, capsys):
    """Case 1 (random weights, 16 blocks) on a tiny LR scene, then case 2
    scores it against the HR scene; the parity reader reads its CSV."""
    root = str(tmp_path)
    hr = (synthetic_clip(8, 64, 80, seed=4, content="natural") * 255).astype(np.uint8)
    for sub, frames in (("HR", hr), ("LR", hr[:, ::4, ::4])):
        d = os.path.join(root, sub, "calendar")
        os.makedirs(d)
        for i, f in enumerate(frames):
            write_png(os.path.join(d, f"col_high_{i:04d}.png"), np.ascontiguousarray(f))
    with pytest.raises(SystemExit) as e:
        run.main(["1", "--root", root, "--device", "cpu"])
    assert e.value.code == 0
    out = sorted(os.listdir(os.path.join(root, "results", "calendar")))
    assert out == [f"output_{i:04d}.png" for i in range(8)]
    run.main(["2", "--root", root, "--device", "cpu"])
    assert "missing -> random-weight smoke run" in capsys.readouterr().out
    metrics = os.path.join(root, "results", "metric_log")
    got = run.read_frameavg_csv(os.path.join(metrics, "metrics.csv"))
    assert set(got) == {"FrameAvg_PSNR", "FrameAvg_SSIM", "FrameAvg_tOF"}
    assert all(np.isfinite(v) for v in got.values())
    with open(os.path.join(metrics, "metricsfile.txt")) as f:
        assert "tOF" in f.read()
