"""The port's metrics suite against the JAX package's on the CPU: the
quality metrics, LPIPS, OpenCV's Farneback flow and grey conversion, the
CSV writer (against pandas) and ``evaluate_folders`` end to end."""

import os
import re

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from tecogan_tpu.eval import evaluate_folders as jax_evaluate_folders
from tecogan_tpu.eval import quality as jax_quality
from tecogan_tpu.eval.lpips import LPIPS as JaxLPIPS
from tecogan_tpu.eval.suite import FARNEBACK_ARGS
from tecogan_tpu_torch.data.synthetic import synthetic_clip
from tecogan_tpu_torch.eval import (
    LPIPS,
    crop_8x8,
    evaluate_folders,
    farneback_flow,
    psnr,
    random_alexnet_params,
    rgb_to_gray,
    ssim,
    write_csv,
)

torch.set_num_threads(1)

LIN_CHANNELS = (64, 192, 384, 256, 256)
# Farneback against OpenCV 5.0, float32 both: the port sums each filter tap
# by tap where OpenCV's vectorised loops fuse multiply-adds, so the flows
# differ by float32 rounding (measured: mean 1.2e-16 to 7.0e-8 px, max
# 2.1e-6 px on these pairs).
FLOW_MEAN_ATOL, FLOW_MAX_ATOL = 1e-6, 2e-5
TOF_RTOL = 1e-5
# LPIPS: float32 convolutions in another summation order than XLA's.
LPIPS_RTOL, LPIPS_ATOL = 2e-4, 1e-5


def _lin(seed):
    rng = np.random.RandomState(seed)
    return [np.abs(rng.randn(c)).astype(np.float32) for c in LIN_CHANNELS]


def _flow_pairs():
    """Three (prev, cur) uint8 grey pairs of 96x128: a smooth pan of a
    synthetic frame, a random texture shifted 2 px, a flat field with an
    edge that moves 3 px."""
    clip = (synthetic_clip(3, 96, 136, seed=3, content="natural") * 255).astype(np.uint8)
    g = cv2.cvtColor(clip[0], cv2.COLOR_RGB2GRAY)
    rng = np.random.default_rng(0)
    tex = (rng.random((96, 128)) * 255).astype(np.uint8)
    flat0 = np.full((96, 128), 80, np.uint8)
    flat0[:, 60:] = 200
    flat1 = np.full((96, 128), 80, np.uint8)
    flat1[:, 63:] = 200
    return {"pan": (g[:, 3:131], g[:, :128]), "texture": (tex, np.roll(tex, 2, axis=1)),
            "edge": (flat0, flat1)}


@pytest.mark.parametrize("case", ["pan", "texture", "edge"])
def test_farneback_matches_opencv(case):
    prev, cur = _flow_pairs()[case]
    want = cv2.calcOpticalFlowFarneback(prev, cur, None, **FARNEBACK_ARGS)
    got = farneback_flow(torch.from_numpy(prev), torch.from_numpy(cur)).numpy()
    assert got.shape == want.shape == (96, 128, 2) and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.mean() <= FLOW_MEAN_ATOL and diff.max() <= FLOW_MAX_ATOL, \
        (diff.mean(), diff.max())
    if case != "edge":
        assert np.abs(want).max() > 0.5  # the flow is not trivially zero

    # tOF of this pair against a zero-motion pair, as the suite forms it.
    still = cv2.calcOpticalFlowFarneback(prev, prev, None, **FARNEBACK_ARGS)
    still_got = farneback_flow(torch.from_numpy(prev), torch.from_numpy(prev)).numpy()

    def tof(a, b):
        d = crop_8x8(a)[0] - crop_8x8(b)[0]
        return np.sqrt(np.sum(np.square(d), axis=-1)).mean()

    np.testing.assert_allclose(tof(got, still_got), tof(want, still), rtol=TOF_RTOL, atol=1e-7)


def test_farneback_rejects_mismatched_frames():
    with pytest.raises(ValueError):
        farneback_flow(torch.zeros(32, 40, dtype=torch.uint8),
                       torch.zeros(32, 41, dtype=torch.uint8))


def test_rgb_to_gray_matches_opencv():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (300, 300, 3), dtype=np.uint8)
    img[0, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 0]]
    np.testing.assert_array_equal(rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("shape", [(48, 48, 3), (576, 720, 3), (70, 95, 3)])
def test_quality_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    a = (rng.rand(*shape) * 255).astype(np.float32)
    b = np.clip(a + rng.randn(*shape) * 8, 0, 255).astype(np.float32)
    ca, y, x = crop_8x8(a)
    ja, jy, jx = jax_quality.crop_8x8(a)
    assert (y, x) == (jy, jx)
    np.testing.assert_array_equal(ca, ja)
    assert psnr(a, b) == jax_quality.psnr(a, b)
    assert ssim(a, b) == jax_quality.ssim(a, b)
    assert psnr(a, a) == jax_quality.psnr(a, a) == float("inf")


def test_lpips_matches_jax():
    alex, lin = random_alexnet_params(7), _lin(3)
    rng = np.random.RandomState(5)
    img0 = (rng.rand(2, 64, 96, 3) * 2 - 1).astype(np.float32)
    img1 = (rng.rand(2, 64, 96, 3) * 2 - 1).astype(np.float32)
    want = JaxLPIPS(alex, lin)(img0, img1)
    model = LPIPS(alex, lin, "cpu")
    got = model(img0, img1)
    assert isinstance(got, torch.Tensor) and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=LPIPS_RTOL, atol=LPIPS_ATOL)
    assert LPIPS.im2tensor(np.uint8([[[0, 255, 128]]])).tolist() == \
        JaxLPIPS.im2tensor(np.uint8([[[0, 255, 128]]])).tolist()


@pytest.mark.parametrize("table", ["temporal", "summary", "odd"])
def test_write_csv_matches_pandas(tmp_path, table):
    third = np.float32(1) / np.float32(3)
    blocks = {
        "temporal": [{"PSNR_00": np.float32([31.123455, 29.5, 0.1, np.inf]),
                      "tOF_00": np.float32([0.25, third])}],
        "summary": [{"Avg_PSNR": np.float32([30.5, 31.25])},
                    {"FolderAvg_PSNR": np.asarray([third])},
                    {"FrameAvg_PSNR": np.asarray([np.float32(1e20)])}],
        "odd": [{"a": np.float32([1e-7, 123456789.0, -0.0, 5e-5]),
                 "b": np.asarray([0.1 + 0.2]), "c": np.float32([])}],
    }[table]
    got, want = str(tmp_path / "got.csv"), str(tmp_path / "want.csv")
    for i, block in enumerate(blocks):
        mode = "w" if i == 0 else "a"
        write_csv(got, block, mode)
        pd.DataFrame({k: pd.Series(v) for k, v in block.items()}).to_csv(want, mode=mode)
    assert open(got).read() == open(want).read()


def _write_folders(root):
    """Two result/target folder pairs of 8 frames at 96x128 (written by
    OpenCV, so the reader meets its filters): the targets pan, the results
    are noisy copies, and one result frame equals its target (PSNR inf)."""
    rng = np.random.RandomState(11)
    pairs = []
    for f in range(2):
        base = (synthetic_clip(1, 96, 160, seed=20 + f, content="natural")[0] * 255)
        res, tar = os.path.join(root, f"res{f}"), os.path.join(root, f"tar{f}")
        os.makedirs(res), os.makedirs(tar)
        for i in range(8):
            frame = np.ascontiguousarray(base[:, 2 * i:2 * i + 128]).astype(np.uint8)
            noisy = np.clip(frame + rng.randint(-6, 7, frame.shape), 0, 255).astype(np.uint8)
            if f == 1 and i == 4:
                noisy = frame
            cv2.imwrite(os.path.join(tar, f"frame_{i:04d}.png"), frame[:, :, ::-1])
            cv2.imwrite(os.path.join(res, f"output_{i:04d}.png"), noisy[:, :, ::-1])
        cv2.imwrite(os.path.join(tar, "IB_0000.png"), frame[:, :, ::-1])  # skipped
        pairs.append((res, tar))
    return pairs


_LOOSE = re.compile(r"((?:lpips|tLPx100|tOF) )[-0-9.inf]+|^((?:LPIPS|tLP100|tOF)_?\d*, .*)$")


def _mask(line):
    """A log line with the LPIPS, tLP100 and tOF numbers blanked."""
    return _LOOSE.sub(lambda m: (m.group(1) or m.group(2).split(",")[0]) + "#", line)


def test_evaluate_folders_matches_jax(tmp_path, capsys):
    pairs = _write_folders(str(tmp_path))
    alex, lin = random_alexnet_params(2), _lin(4)
    res, tar = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jax_evaluate_folders(res, tar, str(tmp_path / "jax"),
                                lpips_model=JaxLPIPS(alex, lin))
    jax_out = capsys.readouterr().out
    timings = {}
    got = evaluate_folders(res, tar, str(tmp_path / "port"),
                           lpips_model=LPIPS(alex, lin, "cpu"), timings=timings)
    port_out = capsys.readouterr().out

    assert got.keys() == want.keys() == {f"FrameAvg_{k}" for k in
                                         ("PSNR", "SSIM", "LPIPS", "tOF", "tLP100")}
    for k, v in want.items():
        if k in ("FrameAvg_PSNR", "FrameAvg_SSIM"):
            assert got[k] == v, k
        elif k == "FrameAvg_tOF":
            np.testing.assert_allclose(got[k], v, rtol=TOF_RTOL)
        else:
            np.testing.assert_allclose(got[k], v, rtol=LPIPS_RTOL, atol=LPIPS_ATOL)
    assert [_mask(s) for s in port_out.splitlines()] == \
        [_mask(s) for s in jax_out.splitlines()]
    assert "psnr inf" in port_out
    assert set(timings) == {"read", "psnr_ssim", "farneback", "lpips"}

    # metrics.csv: the same rows and headers; PSNR and SSIM cells byte-equal,
    # tOF within TOF_RTOL, LPIPS and tLP100 within the LPIPS tolerance.
    got_rows = open(tmp_path / "port" / "metrics.csv").read().splitlines()
    want_rows = open(tmp_path / "jax" / "metrics.csv").read().splitlines()
    assert len(got_rows) == len(want_rows)
    header = None
    for g, w in zip(got_rows, want_rows):
        gc, wc = g.split(","), w.split(",")
        assert len(gc) == len(wc)
        if wc[0] == "":
            assert g == w
            header = wc
            continue
        for name, a, b in zip(header, gc, wc):
            if name == "" or re.search(r"(PSNR|SSIM)", name) or b == "":
                assert a == b, (name, a, b)
            elif "tOF" in name:
                np.testing.assert_allclose(float(a), float(b), rtol=TOF_RTOL)
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=LPIPS_RTOL,
                                           atol=LPIPS_ATOL)


def test_evaluate_folders_without_lpips_skips_its_keys(tmp_path, capsys):
    res, tar = _write_folders(str(tmp_path))[0]
    got = evaluate_folders([res], [tar], str(tmp_path / "out"), keys=["PSNR", "tLP100"])
    assert list(got) == ["FrameAvg_PSNR"]
    assert "no LPIPS weights available; skipping ['tLP100']" in capsys.readouterr().out


def test_default_lpips_needs_its_weights(tmp_path, monkeypatch):
    from tecogan_tpu_torch.eval import default_lpips

    monkeypatch.delenv("TECOGAN_REFERENCE_ROOT", raising=False)
    monkeypatch.delenv("TECOGAN_LPIPS_BACKBONE", raising=False)
    assert default_lpips() is None
    assert default_lpips(str(tmp_path), str(tmp_path / "alex.npz")) is None

    alex = random_alexnet_params(1)
    np.savez(tmp_path / "alex.npz", **{f"conv{i}_{p}": alex[f"conv{i}"][p]
                                       for i in range(5) for p in ("w", "b")})
    lin_dir = tmp_path / "LPIPSmodels" / "v0.1"
    lin_dir.mkdir(parents=True)
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(w).view(1, -1, 1, 1)
                for i, w in enumerate(_lin(2))}, lin_dir / "alex.pth")
    monkeypatch.setenv("TECOGAN_REFERENCE_ROOT", str(tmp_path))
    model = default_lpips(backbone_path=str(tmp_path / "alex.npz"))
    img = np.zeros((1, 64, 64, 3), np.float32)
    assert isinstance(model, LPIPS) and float(model(img, img)[0]) == 0.0
    np.testing.assert_array_equal(model.convs[1].weight.detach().permute(2, 3, 1, 0).numpy(),
                                  alex["conv1"]["w"])


def test_lpips_random_params_are_seeded():
    a, b = random_alexnet_params(3), random_alexnet_params(3)
    assert all(np.array_equal(a[k]["w"], b[k]["w"]) for k in a)
    assert a["conv0"]["w"].shape == (11, 11, 3, 64)
    assert not np.array_equal(a["conv0"]["w"], random_alexnet_params(4)["conv0"]["w"])
