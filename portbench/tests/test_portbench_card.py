"""On the card: each cell's control has to come out as not correct, while
the program's sound runs are correct (``python -m pytest portbench/tests
-m cuda`` on the chip). The controls, each in the program's place:

- the streaming and serving cells (bfloat16): the plain reference computed
  in fp8, each convolution's inputs and weights rounded to float8 e4m3;
- the training cell (float32 with TF32): the program's own bfloat16 path.

Sizes: the Vid4 geometry stands for both streaming cells (``calibrate.py``
reads the control at 2160p itself); the serving and training cells run at
their own sizes with a short window.
"""

import gc

import pytest
import torch

from portbench.harness.manifest import Manifest
from portbench.harness.trace import Tracer

pytestmark = pytest.mark.cuda


def _cell(workload, seed, config_overrides=None, seconds=1.0):
    m = Manifest()
    spec = m.workload(workload)
    traffic = m.traffic(spec["traffic"])
    config = dict(m.config(spec["config"]), **(config_overrides or {}))
    cell = m.kind(traffic["kind"]).Cell(config, traffic, seed, torch.device("cuda"), 1)
    cell.setup()
    cell.window(seconds, Tracer(False))
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    return cell


def _correct(checks):
    return all(c.ok for c in checks)


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("workload", ["stream_vid4", "serve_1080p_live"])
def test_frames_control_fails(card, workload, seed):
    # A serving check samples stream frames up to 120: 4 s at 30 frames/s.
    cell = _cell(workload, seed, seconds=5.0 if workload.startswith("serve") else 1.0)
    assert _correct(cell.check())
    assert not _correct(cell.check(got=cell.reference("fp8")))


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_train_control_fails(card, seed):
    assert _correct(_cell("train_frvsr_resident", seed).check())
    assert not _correct(_cell("train_frvsr_resident", seed, {"compute_dtype": "bfloat16"}).check())
