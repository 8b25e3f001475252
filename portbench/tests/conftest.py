"""Shared fixtures of the benchmark's tests: a manifest cut to tiny sizes
for CPU runs of the harness, and the card's fixture for ``cuda`` tests."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.manifest import BENCH_DIR, Manifest  # noqa: E402

__all__ = ["ROOT", "BENCH_DIR"]

TINY_STREAM = {"num_resblock": 2, "compute_dtype": "float32"}
TINY_TRAFFIC = {
    "clips_2160p": {"lr_height": 32, "lr_width": 48, "clip_frames": 12, "chunk": 7,
                    "check_frames": 12, "distinct_clips": 2},
    "clips_vid4": {"lr_height": 24, "lr_width": 40, "clip_frames": 10, "chunk": 8,
                   "check_frames": 10, "distinct_clips": 2},
    "live_1080p": {"lr_height": 32, "lr_width": 48, "clip_frames": 12, "streams": 3,
                   "check_upto": 4, "fps": 10},
    "frvsr_resident": {"scenes": 2, "scene_frames": 12, "height": 48, "width": 64,
                       "cache_batches": 2},
}
TINY_TRAIN = {"num_resblock": 2, "crop_size": 8, "rnn_n": 3, "batch_size": 2, "max_frm": 11,
              "end_dir": 2001, "queue_thread": 2}


@pytest.fixture
def tiny_manifest(tmp_path):
    """The repository's benchmark with every configuration and traffic mix
    cut to a size the CPU runs in seconds, in a directory of its own."""
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    manifest = Manifest(root, bench)
    for c in manifest.data["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY_TRAIN if "batch_size" in cfg else TINY_STREAM)
        path.write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        path = bench / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **over)))
    return Manifest(root, bench)


@pytest.fixture
def card():
    """Skips a test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
