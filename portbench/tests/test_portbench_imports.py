"""Nothing the benchmark runs loads JAX or the JAX package: each loaded
module's top-level name is compared whole, so ``tecogan_tpu_torch``
passes and ``tecogan_tpu`` does not. A run that finds no card fails and
prints no result."""

import json
import os
import subprocess
import sys

from portbench.harness.manifest import ROOT
from portbench.harness.runner import FORBIDDEN, forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules(["tecogan_tpu_torch", "tecogan_tpu_torch.serve", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["tecogan_tpu.config", "jax.numpy", "jaxlib", "flax.linen",
                              "tecogan_tpu"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                  "tecogan_tpu", "tecogan_tpu.config"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "tecogan_tpu"}


_DRIVE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from conftest import TINY_STREAM, TINY_TRAFFIC, TINY_TRAIN
from portbench.harness.manifest import Manifest
from portbench.harness.runner import run_cell
m = Manifest()
configs = {n: m.config(n) for n in ("tecogan16_bf16", "frvsr10_f32_resident")}
configs = {n: dict(c, **(TINY_TRAIN if "batch_size" in c else TINY_STREAM))
           for n, c in configs.items()}
m.config = configs.__getitem__
for w in ("stream_vid4", "serve_1080p_live", "train_frvsr_resident"):
    traffic = TINY_TRAFFIC[m.workload(w)["traffic"]]
    assert run_cell(m, w, 7, 0.5, False, device="cpu", traffic_overrides=traffic)["correct"]
import portbench.calibrate, portbench.sweep_serve
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _DRIVE, str(ROOT),
                          os.path.dirname(__file__)],
                         capture_output=True, text=True, env=env, timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tecogan_tpu_torch" in tops and "torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "stream_vid4",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
