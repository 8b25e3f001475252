"""The port's inference CLI and its host I/O against the JAX package's on
the CPU: the TF npz name map, the PNG listing, the HR -> LR blur, the frame
loader and reader, the writer, every weight source, the CLI end to end
(PNG dir -> HR PNGs) and test-while-train."""

import os
import subprocess

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.cli import main as jax_cli
from tecogan_tpu.data.inference import load_inference_frames as jax_load_inference_frames
from tecogan_tpu.models import FNet as JaxFNet
from tecogan_tpu.models import Generator as JaxGenerator
from tecogan_tpu.ops.image import list_png_in_dir as jax_list_png_in_dir
from tecogan_tpu.train.checkpoint import convert_tf_npz as jax_convert_tf_npz
from tecogan_tpu.train.checkpoint import params_to_npz as jax_params_to_npz
from tecogan_tpu_torch.cli.main import main
from tecogan_tpu_torch.config import FRVSR_PRESET
from tecogan_tpu_torch.data.inference import (
    FrameWriter,
    load_inference_frames,
    read_rgb,
)
from tecogan_tpu_torch.data.png import write_png
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes
from tecogan_tpu_torch.models import FNet, Generator
from tecogan_tpu_torch.models.layers import glorot_init_
from tecogan_tpu_torch.ops import gaussian_blur_reflect101, list_png_in_dir
from tecogan_tpu_torch.train import Trainer, loop
from tecogan_tpu_torch.train.checkpoint import save_checkpoint
from tecogan_tpu_torch.weights import convert_tf_npz, from_jax_params, to_jax_params

torch.set_num_threads(1)

# The HR -> LR route against cv2.GaussianBlur, after / 255: OpenCV's
# vectorised filter fuses multiply-adds the port does one by one (measured
# 2.4e-7).
BLUR_ATOL = 1e-6
# The CLI's PNGs against the JAX CLI's: float32 convs in another order, so
# a value may land across a uint8 truncation step (as in
# test_torch_streaming.py): at most one level, on at most 0.1% of pixels.
U8_MAX_FLIPPED = 1e-3


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _tf_npz(path, num_resblock, flat, seed=0):
    """A TF-named npz of a random generator and FNet (slim ``.../Conv/``
    scopes, or the flat spelling), with Adam slots and a global step that
    the converters skip and read."""
    gen_tree, fnet_tree = to_jax_params(
        glorot_init_(Generator(num_resblock, 8), torch.Generator().manual_seed(seed)),
        glorot_init_(FNet((4, 8, 8), (8, 8, 4)), torch.Generator().manual_seed(seed + 1)))
    g, f = "generator/generator_unit", "fnet/autoencode_unit"
    scopes = {"input_stage_conv": f"{g}/input_stage/conv",
              "conv_tran1": f"{g}/conv_tran2highres/conv_tran1",
              "conv_tran2": f"{g}/conv_tran2highres/conv_tran2",
              "output_stage_conv": f"{g}/output_stage/conv"}
    scopes.update({f"resblock_{i}_conv_{j}": f"{g}/resblock_{i}/conv_{j}"
                   for i in range(1, num_resblock + 1) for j in (1, 2)})
    fscopes = {f"{p}_{i}_conv_{j}": f"{f}/{p}_{i}/conv_{j}"
               for p in ("encoder", "decoder") for i in (1, 2, 3) for j in (1, 2)}
    fscopes.update({"output_conv1": f"{f}/output_stage/conv1",
                    "output_conv2": f"{f}/output_stage/conv2"})
    data = {"global_step": np.int64(1234)}
    for tree, names in ((gen_tree, scopes), (fnet_tree, fscopes)):
        for name, scope in names.items():
            inner = "" if flat else ("Conv2d_transpose/" if "conv_tran" in name else "Conv/")
            data[f"{scope}/{inner}weights"] = tree[name]["kernel"]
            data[f"{scope}/{inner}biases"] = tree[name]["bias"]
            data[f"{scope}/{inner}weights/Adam"] = np.zeros_like(tree[name]["kernel"])
    np.savez(path, **data)
    return gen_tree, fnet_tree


@pytest.mark.parametrize("flat", [False, True], ids=["slim", "flat"])
def test_convert_tf_npz_matches_jax(tmp_path, flat):
    path = str(tmp_path / "tf.npz")
    gen_tree, fnet_tree = _tf_npz(path, 16, flat)
    got, want = convert_tf_npz(path), jax_convert_tf_npz(path)
    assert got.keys() == want.keys() == {"generator", "fnet", "global_step"}
    assert got["global_step"] == want["global_step"] == 1234
    for name in ("generator", "fnet"):
        assert _tree_equal(got[name], want[name])
    assert _tree_equal(got["generator"], gen_tree) and _tree_equal(got["fnet"], fnet_tree)
    gen, fnet = from_jax_params(got["generator"], got["fnet"])
    assert len(gen.resblocks) == 16 and _tree_equal(to_jax_params(gen, fnet)[1], fnet_tree)


def test_convert_tf_npz_depth_from_the_npz(tmp_path):
    """A 10-block (FRVSR) npz: None reads the depth from its names, as the
    JAX converter does; the default 16 raises in both; no block raises in
    the port (where the JAX converter returns a generator without trunk)."""
    path = str(tmp_path / "frvsr.npz")
    _tf_npz(path, 10, flat=False)
    got, want = convert_tf_npz(path, num_resblock=None), jax_convert_tf_npz(path, None)
    assert _tree_equal(got["generator"], want["generator"])
    assert sum(k.endswith("_conv_1") for k in got["generator"]) == 10
    with pytest.raises(KeyError):
        convert_tf_npz(path)
    with pytest.raises(KeyError):
        jax_convert_tf_npz(path)
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, global_step=np.int64(0))
    with pytest.raises(ValueError, match="without its trunk"):
        convert_tf_npz(empty, num_resblock=None)


@pytest.mark.parametrize("prefix_skip", ["IB", "\x00"])
def test_list_png_in_dir_matches_jax(tmp_path, prefix_skip):
    for name in ("frame_10.png", "frame_9.png", "frame_100.png", "IB_0001.png",
                 "a.png", "b2.png", "notes.txt", "frame_010.png"):
        (tmp_path / name).write_bytes(b"")
    got = list_png_in_dir(str(tmp_path), prefix_skip)
    assert got == jax_list_png_in_dir(str(tmp_path), prefix_skip)
    assert ("IB_0001.png" in " ".join(got)) == (prefix_skip == "\x00")


@pytest.mark.parametrize("shape", [(64, 80, 3), (37, 51, 3), (13, 13, 3)])
def test_blur_matches_opencv(shape):
    rng = np.random.default_rng(sum(shape))
    im = (rng.random(shape) * 255).astype(np.uint8).astype(np.float32)
    want = cv2.GaussianBlur(im, (0, 0), sigmaX=1.5)[::4, ::4] / 255.0
    got = (gaussian_blur_reflect101(torch.from_numpy(im), 1.5)[::4, ::4] / 255.0).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= BLUR_ATOL


def _clip_dir(root, name, t=8, h=32, w=40, seed=0):
    """``t`` PNG frames of a synthetic clip, written by OpenCV."""
    d = os.path.join(root, name)
    os.makedirs(d)
    clip = (synthetic_clip(t, h, w, seed=seed, content="natural") * 255).astype(np.uint8)
    for i, frame in enumerate(clip):
        cv2.imwrite(os.path.join(d, f"im{i + 1}.png"), frame[:, :, ::-1])
    return d, clip


@pytest.mark.parametrize("route", ["lr_uint8", "lr_float", "hr", "max_frames"])
def test_load_inference_frames_matches_jax(tmp_path, route):
    d, _ = _clip_dir(str(tmp_path), "frames", t=9, h=36, w=44)
    kw = {"lr_uint8": dict(input_dir_lr=d, as_uint8=True),
          "lr_float": dict(input_dir_lr=d),
          "hr": dict(input_dir_hr=d, as_uint8=True),
          "max_frames": dict(input_dir_lr=str(tmp_path / "missing"), input_dir_hr=d,
                             max_frames=7)}[route]
    got, want = load_inference_frames(**kw, device="cpu"), jax_load_inference_frames(**kw)
    assert got.paths_lr == want.paths_lr
    assert got.inputs.dtype == want.inputs.dtype and got.inputs.shape == want.inputs.shape
    if route in ("hr", "max_frames"):
        assert got.inputs.shape[1:3] == (9, 11)
        assert np.abs(got.inputs - want.inputs).max() <= BLUR_ATOL
    else:
        np.testing.assert_array_equal(got.inputs, want.inputs)


def test_load_inference_frames_needs_a_directory(tmp_path):
    with pytest.raises(ValueError, match="not found"):
        load_inference_frames(input_dir_lr=str(tmp_path / "nope"))


@pytest.mark.parametrize("kind", ["gray", "rgba", "rgb"])
def test_read_rgb_matches_opencv(tmp_path, kind):
    rng = np.random.default_rng(3)
    shape = {"gray": (21, 17), "rgba": (21, 17, 4), "rgb": (21, 17, 3)}[kind]
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for writer in ("port", "cv2"):
        path = str(tmp_path / f"{kind}_{writer}.png")
        if writer == "port":
            write_png(path, img)
        else:  # OpenCV's own filters, BGR(A) order
            cv2.imwrite(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]])
        got = read_rgb(path)
        assert got.shape == (21, 17, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.imread(path, 3)[..., ::-1])


def test_frame_writer_names_and_formats(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    w = FrameWriter(str(tmp_path / "out"), name="hr", warmup=5, num_threads=2)
    w.submit(frames[:2], 5)
    w.submit(frames[2:], 7)
    assert w.close() == 3
    assert sorted(os.listdir(tmp_path / "out")) == ["hr_0000.png", "hr_0001.png", "hr_0002.png"]
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "out" / "hr_0002.png")), frames[2])
    with pytest.raises(ValueError, match="only png"):
        FrameWriter(str(tmp_path / "jpg"), ext="jpg")


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A 2-block, 64-channel JAX generator and FNet (flax init plus seeded
    noise on every parameter, so no bias is zero) in the npz interchange."""
    rng = np.random.RandomState(0)
    gp = jax.jit(JaxGenerator(num_resblock=2).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 51)))["params"]
    fp = jax.jit(JaxFNet().init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 6)))["params"]
    gp, fp = (jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (rng.randn(*p.shape) * 0.01).astype(np.float32),
        jax.device_get(tree)) for tree in (gp, fp))
    path = str(tmp_path_factory.mktemp("weights") / "params.npz")
    jax_params_to_npz(path, generator=gp, fnet=fp)
    return path, gp, fp


def _read_dir(d):
    return {f: cv2.imread(os.path.join(d, f))[..., ::-1] for f in sorted(os.listdir(d))
            if f.endswith(".png")}


def test_cli_matches_jax_cli(tmp_path, jax_weights, capsys, monkeypatch):
    """PNG dir -> HR PNGs: the port's CLI on the CPU against the JAX CLI,
    the same 10 frames of 32x40 and the same 2-block weights, float32."""
    monkeypatch.setenv("TECOGAN_NO_COMPILE_CACHE", "1")
    npz = jax_weights[0]
    lr, _ = _clip_dir(str(tmp_path), "lr", t=10)
    jax_cli.main(["--mode", "inference", "--input_dir_LR", lr, "--output_dir",
                  str(tmp_path / "jax"), "--params_npz", npz, "--num_resblock", "2"])
    capsys.readouterr()
    stats = main(["--mode", "inference", "--device", "cpu", "--input_dir_LR", lr,
                  "--output_dir", str(tmp_path / "port"), "--params_npz", npz,
                  "--queue_thread", "2"])
    out = capsys.readouterr().out
    assert "NOTE: " in out and "has 2 resblocks; overriding --num_resblock 16" in out
    assert "total time " in out and ", frame number 15" in out
    assert f"Wrote 10 frames to {tmp_path / 'port'}" in out
    assert stats["written"] == 10 and stats["frames"] == 15 and stats["threads"] == 2

    got, want = _read_dir(tmp_path / "port"), _read_dir(tmp_path / "jax")
    names = [f"output_{i:04d}.png" for i in range(10)]
    assert list(got) == list(want) == names
    stack = lambda d: np.stack([d[f] for f in names]).astype(np.int16)  # noqa: E731
    diff = np.abs(stack(got) - stack(want))
    assert stack(got).shape == (10, 128, 160, 3)
    assert diff.max() <= 1 and (diff != 0).mean() <= U8_MAX_FLIPPED, (diff != 0).mean()
    assert stack(got).std() > 1.0
    with open(tmp_path / "port" / "logfile.txt") as f:
        assert "End of configuration" in f.read()


def test_cli_weight_sources(tmp_path, jax_weights, capsys):
    """--checkpoint (the port's trainer's, depth from it with the NOTE),
    --tf_npz, --params_npz and --allow_random_weights give the same frames
    for the same weights, and the HR route writes the LR route's count."""
    npz, gp, fp = jax_weights
    lr, clip = _clip_dir(str(tmp_path), "lr", t=7, h=16, w=24, seed=4)
    hr = os.path.join(str(tmp_path), "hr")
    os.makedirs(hr)
    for i, frame in enumerate(clip):
        write_png(os.path.join(hr, f"{i:03d}.png"),
                  cv2.resize(frame, (96, 64), interpolation=cv2.INTER_CUBIC))

    # A trainer checkpoint of the same weights.
    trainer = Trainer(FRVSR_PRESET.replace(num_resblock=2), "cpu")
    state = trainer.state_from_modules(*from_jax_params(gp, fp))
    state.step = 7
    save_checkpoint(str(tmp_path / "ckpt"), state)
    # And a TF npz of them.
    tf = {}
    for name, p in gp.items():
        scope = {"input_stage_conv": "input_stage/conv", "output_stage_conv": "output_stage/conv",
                 "conv_tran1": "conv_tran2highres/conv_tran1",
                 "conv_tran2": "conv_tran2highres/conv_tran2"}.get(
            name, name.replace("_conv_", "/conv_"))
        for leaf, key in (("kernel", "weights"), ("bias", "biases")):
            tf[f"generator/generator_unit/{scope}/{key}"] = p[leaf]
    for name, p in fp.items():
        scope = {"output_conv1": "output_stage/conv1", "output_conv2": "output_stage/conv2"}.get(
            name, name.replace("_conv_", "/conv_"))
        for leaf, key in (("kernel", "weights"), ("bias", "biases")):
            tf[f"fnet/autoencode_unit/{scope}/{key}"] = p[leaf]
    np.savez(tmp_path / "tf.npz", **tf)

    runs = {}
    base = ["--mode", "inference", "--device", "cpu", "--input_dir_LR", lr,
            "--queue_thread", "1", "--infer_chunk", "4"]
    for source, extra in (("params", ["--params_npz", npz]),
                          ("ckpt", ["--checkpoint", str(tmp_path / "ckpt")]),
                          ("tf", ["--tf_npz", str(tmp_path / "tf.npz")])):
        main(base + ["--output_dir", str(tmp_path / source)] + extra)
        out = capsys.readouterr().out
        assert "has 2 resblocks; overriding --num_resblock 16 (the checkpoint defines" in out
        assert ("Loaded checkpoint step 7 from" in out) == (source == "ckpt")
        runs[source] = _read_dir(tmp_path / source)
    for source in ("ckpt", "tf"):
        assert runs[source].keys() == runs["params"].keys()
        for f, img in runs["params"].items():
            np.testing.assert_array_equal(runs[source][f], img)

    main(base + ["--output_dir", str(tmp_path / "rand"), "--allow_random_weights",
                 "--num_resblock", "1", "--max_frames", "6"])
    assert "WARNING: random weights" in capsys.readouterr().out
    assert len([f for f in os.listdir(tmp_path / "rand") if f.endswith(".png")]) == 6

    stats = main(["--mode", "inference", "--device", "cpu", "--input_dir_HR", hr,
                  "--output_dir", str(tmp_path / "fromhr"), "--params_npz", npz,
                  "--output_pre", "scene", "--output_name", "sr"])
    assert stats["written"] == 7
    assert read_rgb(str(tmp_path / "fromhr" / "scene" / "sr_0006.png")).shape == (64, 96, 3)


def test_cli_checkpoint_note(tmp_path, jax_weights, capsys):
    _, gp, fp = jax_weights
    lr, _ = _clip_dir(str(tmp_path), "lr", t=6, h=16, w=16)
    trainer = Trainer(FRVSR_PRESET.replace(num_resblock=2), "cpu")
    state = trainer.state_from_modules(*from_jax_params(gp, fp))
    state.step = 3
    save_checkpoint(str(tmp_path / "ckpt"), state)
    main(["--mode", "inference", "--device", "cpu", "--input_dir_LR", lr,
          "--output_dir", str(tmp_path / "o"), "--checkpoint", str(tmp_path / "ckpt"),
          "--num_resblock", "5"])
    out = capsys.readouterr().out
    assert f"Loaded checkpoint step 3 from {tmp_path / 'ckpt'}" in out
    assert ("NOTE: checkpoint has 2 resblocks; overriding --num_resblock 5 (the "
            "checkpoint defines the model)") in out


def test_cli_inference_guards(tmp_path, monkeypatch):
    lr, _ = _clip_dir(str(tmp_path), "lr", t=6, h=8, w=8)
    base = ["--mode", "inference", "--device", "cpu", "--input_dir_LR", lr,
            "--output_dir", str(tmp_path / "o")]
    with pytest.raises(SystemExit, match="inference needs --checkpoint"):
        main(base)
    with pytest.raises(ValueError, match="only png"):
        main(base + ["--allow_random_weights", "--output_ext", "jpg"])
    with pytest.raises(ValueError, match="extension"):  # before any decode
        main(base + ["--allow_random_weights", "--output_video", "x.webm"])
    # The parallel flags: 8-row frames give no 2 shards of FNet's 8 rows,
    # and the two strategies are exclusive (before any decode).
    with pytest.raises(ValueError, match="at most 1 shards"):
        main(base + ["--allow_random_weights", "--spatial_shards", "2"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(base + ["--allow_random_weights", "--spatial_shards", "2", "--pipeline"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(base[:2] + base[4:] + ["--allow_random_weights"])  # --device cuda


def test_test_while_train_spawns_the_cli(tmp_path, monkeypatch):
    """After its save, train() starts the port's inference CLI on the
    checkpoint over <scenes>/../LR/calendar; the child writes
    train_out_*.png and exits 0."""
    scenes = str(tmp_path / "data" / "scenes")
    write_synthetic_scenes(scenes, 2, 6, 60, 64, start_index=2000)
    calendar, _ = _clip_dir(str(tmp_path / "data" / "LR"), "calendar", t=7, h=12, w=16)
    spawned = []
    spawn = loop._spawn_test_while_train
    monkeypatch.setattr(loop, "_spawn_test_while_train",
                        lambda *a: spawned.append(spawn(*a)) or spawned[-1])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = FRVSR_PRESET.replace(input_video_dir=scenes, num_resblock=2, crop_size=8,
                               batch_size=2, rnn_n=4, max_frm=5, queue_thread=2,
                               display_freq=1, summary_freq=2, save_freq=2)
    out = str(tmp_path / "run")
    loop.train(cfg, out, "cpu", max_steps=2)
    assert len(spawned) == 1 and isinstance(spawned[0], subprocess.Popen)
    assert spawned[0].wait(timeout=300) == 0, open(os.path.join(out, "train",
                                                                "test_while_train.log")).read()
    written = sorted(f for f in os.listdir(os.path.join(out, "train"))
                     if f.startswith("train_out_"))
    assert written == [f"train_out_{i:04d}.png" for i in range(7)]
    log = open(os.path.join(out, "train", "test_while_train.log")).read()
    assert "Loaded checkpoint step 2" in log and f"input_dir_LR: {calendar}" in log

    spawned.clear()
    loop.train(cfg, str(tmp_path / "quiet"), "cpu", max_steps=2, test_while_train=False)
    assert spawned == []
