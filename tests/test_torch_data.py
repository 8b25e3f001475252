"""The port's training data: the PNG codec against OpenCV, the synthetic
clips and the scene loader against the JAX package (same files, same seed,
same batches)."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from tecogan_tpu.config import TecoConfig as JaxConfig
from tecogan_tpu.data.loader import BatchLoader as JaxBatchLoader
from tecogan_tpu.data.loader import SceneDataset as JaxSceneDataset
from tecogan_tpu.data.synthetic import synthetic_clip as jax_synthetic_clip
from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.data.loader import BatchLoader, SceneDataset, png_dims
from tecogan_tpu_torch.data import png
from tecogan_tpu_torch.data.png import SIGNATURE, read_png, write_png
from tecogan_tpu_torch.data.synthetic import synthetic_clip, write_synthetic_scenes


def _images(rng, h=13, w=21):
    """Structured content (so every PNG row filter is worth choosing) plus
    noise: gray, RGB, RGBA."""
    yy, xx = np.mgrid[:h, :w]
    base = (128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
            + rng.randint(-20, 20, (h, w))).clip(0, 255).astype(np.uint8)
    rgb = np.stack([base, base[::-1], base[:, ::-1]], axis=-1)
    rgba = np.concatenate([rgb, (255 - base)[..., None]], axis=-1)
    return {"gray": base, "rgb": rgb, "rgba": rgba}


def test_png_round_trip(rng, tmp_path):
    for name, img in _images(rng).items():
        path = str(tmp_path / f"{name}.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)
        assert png_dims(path) == img.shape[:2]
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "f.png"), np.zeros((4, 4, 3), np.float32))


def test_read_png_matches_cv2(rng, tmp_path):
    """OpenCV writes with libpng's adaptive per-row filters."""
    for name, img in _images(rng, 37, 53).items():
        path = str(tmp_path / f"{name}.png")
        cv2_img = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[-1]]]
        assert cv2.imwrite(path, cv2_img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want, cv2_img)
        np.testing.assert_array_equal(read_png(path), img)
        # cv2 reads the port's files too.
        write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), cv2_img)


def _filter_row(kind, row, prev, bpp):
    """PNG's forward filters (the encoder's side), written out per byte."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _write_filtered(path, img, kinds):
    """A PNG of uint8 gray/RGB/RGBA ``img`` whose row y is filtered with
    ``kinds(y)``."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    prev, raw = bytes(w * bpp), b""
    for y in range(h):
        row = img[y].tobytes()
        raw += bytes([kinds(y)]) + _filter_row(kinds(y), row, prev, bpp)
        prev = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    color = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return raw


def _python_unfilter(raw, h, stride, bpp):
    """The plain version: the codec's Python loops for Average and Paeth
    rows, numpy for the others."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out, prev = np.empty((h, stride), np.uint8), bytes(stride)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].tobytes()
        if kind == 3:
            out[y] = np.frombuffer(png._unfilter_average(line, prev, bpp), np.uint8)
        elif kind == 4:
            out[y] = np.frombuffer(png._unfilter_paeth(line, prev, bpp), np.uint8)
        else:
            out[y] = np.frombuffer(line, np.uint8) + (np.frombuffer(prev, np.uint8)
                                                      if kind == 2 else 0)
        prev = out[y].tobytes()
    return out


def test_read_png_every_filter(rng, tmp_path):
    """Rows filtered with each of the five filter types in turn; Average
    and Paeth rows (the C unfilter) also against the Python loops, at an
    odd width and at the calendar geometry 144x180."""
    img = _images(rng, 15, 11)["rgb"]
    path = str(tmp_path / "filters.png")
    _write_filtered(path, img, lambda y: y % 5)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    for h, w in ((9, 37), (144, 180)):
        img = _images(rng, h, w)["rgb"]
        for kind in (3, 4):
            path = str(tmp_path / f"k{kind}_{h}x{w}.png")
            raw = _write_filtered(path, img, lambda y: kind if y % 7 else 2)
            got = read_png(path)
            np.testing.assert_array_equal(got.reshape(h, -1), _python_unfilter(raw, h, w * 3, 3))
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", [3, 4], ids=["average", "paeth"])
@pytest.mark.parametrize("channels", ["gray", "rgb", "rgba"])
def test_png_unfilter_native_matches_python(rng, kind, channels):
    """The C unfilter of one row against the Python loop: random rows and
    previous rows (every wrap-around and every Paeth tie-break), at odd
    widths, 1, 3 and 4 bytes a pixel."""
    bpp = {"gray": 1, "rgb": 3, "rgba": 4}[channels]
    native = png._native()
    fn = native.tt_unfilter_average if kind == 3 else native.tt_unfilter_paeth
    plain = png._unfilter_average if kind == 3 else png._unfilter_paeth
    for width in (1, 2, 13, 181):
        n = width * bpp
        line = rng.randint(0, 256, n).astype(np.uint8)
        prev = rng.randint(0, 256, n).astype(np.uint8)
        if width == 13:  # equal neighbours: the predictor's ties
            prev[:] = line[:] = rng.randint(0, 2, n) * 255
        out = np.empty(n, np.uint8)
        fn(line.ctypes.data, prev.ctypes.data, out.ctypes.data, n, bpp)
        want = np.frombuffer(plain(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        np.testing.assert_array_equal(out, want)


def test_png_unfilter_needs_a_compiler(rng, tmp_path, monkeypatch):
    """No C compiler raises; the codec never falls back to the byte loops."""
    monkeypatch.setenv("CC", "")
    monkeypatch.setattr(png.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C compiler"):
        png._c_compiler()

    def no_native():
        raise RuntimeError("no unfilter")

    monkeypatch.setattr(png, "_native", no_native)
    path = str(tmp_path / "paeth.png")
    _write_filtered(path, _images(rng, 5, 7)["rgb"], lambda y: 4)
    with pytest.raises(RuntimeError, match="no unfilter"):
        read_png(path)
    _write_filtered(path, _images(rng, 5, 7)["rgb"], lambda y: y % 3)  # None, Sub, Up
    assert read_png(path).shape == (5, 7, 3)


def test_read_png_rejects_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 5, 3), np.uint16))
    with pytest.raises(ValueError, match="unsupported"):
        read_png(path)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(bad)


@pytest.mark.parametrize("content", ["grating", "natural"])
def test_synthetic_clip_matches_jax(content):
    got = synthetic_clip(5, 30, 41, seed=3, content=content)
    np.testing.assert_array_equal(got, jax_synthetic_clip(5, 30, 41, seed=3, content=content))


LOADER = dict(crop_size=8, rnn_n=4, batch_size=2, max_frm=7, str_dir=2000,
              end_dir=2001, end_dir_val=2002, queue_thread=2, rand_seed=4)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Three scenes of 8 frames, 60x64 (over the 40-px HR crop plus the
    12-px camera-pan margin of rnn_n 4)."""
    root = str(tmp_path_factory.mktemp("scenes"))
    write_synthetic_scenes(root, 3, 8, 60, 64, start_index=2000)
    return root


def test_scene_dataset_matches_jax(scenes):
    cfg = TecoConfig(input_video_dir=scenes, **LOADER)
    ours, theirs = SceneDataset(cfg), JaxSceneDataset(JaxConfig(input_video_dir=scenes, **LOADER))
    assert ours.scenes == theirs.scenes and len(ours) == len(theirs) == 8
    moving = 0
    for index in range(len(ours)):
        for seed in range(6):
            a = ours.plan_sequence(index, np.random.RandomState(seed))
            b = theirs.plan_sequence(index, np.random.RandomState(seed))
            assert a.paths == b.paths and a.flip == b.flip
            np.testing.assert_array_equal(a.oy, b.oy)
            np.testing.assert_array_equal(a.ox, b.ox)
            moving += len(set(a.paths)) == 1
            if seed < 2:
                for as_uint8 in (False, True):
                    np.testing.assert_array_equal(ours.load_plan(a, as_uint8),
                                                  theirs.load_plan(b, as_uint8))
    assert moving > 0  # the camera-pan branch was taken


def test_batch_loader_matches_jax(scenes):
    cfg = TecoConfig(input_video_dir=scenes, **LOADER)
    with BatchLoader(SceneDataset(cfg)) as ours, JaxBatchLoader(
            JaxSceneDataset(JaxConfig(input_video_dir=scenes, **LOADER)),
            executor="python") as theirs:
        for _ in range(3):
            a, b = ours.next_batch(), theirs.next_batch()
            assert a.dtype == np.uint8 and a.shape == (2, 4, 40, 40, 3)
            np.testing.assert_array_equal(a, b)
    val = SceneDataset(cfg, validation=True)
    assert [os.path.basename(s) for s in val.scenes] == ["scene_2002"]


def test_loader_reraises_producer_errors(scenes):
    """A scene too small for the crop fails in the producer thread;
    next_batch() raises instead of waiting forever (c7d1830)."""
    cfg = TecoConfig(input_video_dir=scenes, **{**LOADER, "crop_size": 16})
    loader = BatchLoader(SceneDataset(cfg))
    try:
        with pytest.raises(RuntimeError, match="producer") as info:
            loader.next_batch()
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        loader.stop()
