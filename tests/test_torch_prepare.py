"""The port's dataset preparation against the JAX package's on the CPU: the
curated video list, ``--synthetic`` scenes (tree, pixels, log), the offline
skip path, the missing decoder, and the 0.5x INTER_AREA resize against
OpenCV."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from tecogan_tpu.data import prepare as jax_prepare
from tecogan_tpu_torch.data import prepare
from tecogan_tpu_torch.data.png import read_png
from tecogan_tpu_torch.ops.resize import resize_area

torch.set_num_threads(1)


def test_video_data_dict_equals_jax():
    assert prepare.VIDEO_DATA_DICT == jax_prepare.VIDEO_DATA_DICT
    assert list(prepare.VIDEO_DATA_DICT) == list(jax_prepare.VIDEO_DATA_DICT)


def _config_lines(path, out_dir):
    """The configuration block, the output dir's own path replaced."""
    with open(path) as f:
        lines = f.read().replace(out_dir, "<out>").splitlines()
    return lines[lines.index("[Configurations]:"):lines.index("End of configuration") + 1]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_synthetic_main_matches_jax(tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--synthetic", "2", "--duration", "3", "--start_id", "2100"]
    prepare.main(argv + ["--output_dir", port_dir])
    stdout = sys.stdout
    try:  # the JAX main leaves its Tee installed
        jax_prepare.main(argv + ["--output_dir", jax_dir])
    finally:
        sys.stdout = stdout
    assert _tree(port_dir) == _tree(jax_dir)
    pngs = [p for p in _tree(port_dir) if p.endswith(".png")]
    assert len(pngs) == 6 and pngs[0] == os.path.join("scene_2100", "col_high_0000.png")
    for rel in pngs:
        got = read_png(os.path.join(port_dir, rel))
        want = cv2.imread(os.path.join(jax_dir, rel))[:, :, ::-1]
        assert got.shape == (288, 352, 3)
        np.testing.assert_array_equal(got, want, err_msg=rel)
    port_log = os.path.join(port_dir, "logfile.txt")
    want = _config_lines(os.path.join(jax_dir, "logfile.txt"), jax_dir)
    assert _config_lines(port_log, port_dir) == want and "\toutput_dir: <out>" in want
    with open(port_log) as f:
        assert f"Wrote 2 synthetic scenes to {port_dir}" in f.read()


def test_prepare_offline_skips_like_jax(tmp_path, capsys):
    out, videos = str(tmp_path / "scenes"), str(tmp_path / "videos")
    assert prepare.prepare(out, videos, download=False) == 0
    got = capsys.readouterr().out
    assert jax_prepare.prepare(out, videos, download=False) == 0
    want = capsys.readouterr().out
    assert got == want
    assert got.count("Skipping video") == len(prepare.VIDEO_DATA_DICT)


def test_local_video_needs_a_decoder(tmp_path):
    """A local file that is no video fails to open in both packages
    (FileNotFoundError) before a scene directory is made; a missing one
    too. Decoding real files: tests/test_torch_video_io.py."""
    videos = tmp_path / "videos"
    videos.mkdir()
    (videos / "121649159.mp4").write_bytes(b"\x00" * 64)
    out = tmp_path / "scenes"
    with pytest.raises(FileNotFoundError):
        prepare.prepare(str(out), str(videos), download=False)
    with pytest.raises(FileNotFoundError):
        jax_prepare.prepare(str(tmp_path / "jax"), str(videos), download=False)
    assert not (out / "scene_2000").exists()
    with pytest.raises(FileNotFoundError):
        prepare.extract_scene(str(videos / "missing.mp4"), 0, str(out / "x"))


@pytest.mark.parametrize("shape", [(8, 8), (9, 8), (8, 9), (11, 13), (13, 11), (5, 7),
                                   (15, 17), (2, 3), (3, 2), (121, 161), (288, 352)])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_area_matches_opencv(shape, channels):
    """Bit for bit, sizes OpenCV rounds up or down (half to even) included."""
    rng = np.random.RandomState(shape[0] * 100 + shape[1])
    img = rng.randint(0, 256, shape + ((3,) if channels == 3 else ())).astype(np.uint8)
    want = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
    got = resize_area(img, 0.5)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_area_guards():
    with pytest.raises(ValueError, match="0.5"):
        resize_area(np.zeros((8, 8, 3), np.uint8), 0.25)
    with pytest.raises(ValueError, match="uint8"):
        resize_area(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="no 0.5x size"):
        resize_area(np.zeros((1, 1, 3), np.uint8))
