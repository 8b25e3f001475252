"""The plain reference (``portbench/reference``) against the port,
``tecogan_tpu_torch``, at tiny sizes on the CPU: operation by operation,
a stream, a serving pool's streams each run alone, and three FRVSR steps.
The test may import both; the reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from portbench.harness import frames as FR
from portbench.harness import program
from portbench.harness.runner import run_cell
from portbench.reference import model as R
from tecogan_tpu_torch.kernels.upsample4 import upsample4_plain
from tecogan_tpu_torch.models.fnet import pad_flow_to
from tecogan_tpu_torch.ops.space_to_depth import space_to_depth
from tecogan_tpu_torch.ops.warp import dense_image_warp

CFG = {"num_resblock": 3, "gen_channels": 64, "fnet_channels": [32, 64, 128],
       "fnet_up_channels": [256, 128, 64], "flow_max_velocity": 24.0,
       "compute_dtype": "float32"}


def test_resizes_warp_and_packing():
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 9, 11, 3, generator=g)
    assert torch.allclose(R.upsample(x, "bicubic4"), upsample4_plain(x, "bicubic"), atol=1e-6)
    f = torch.randn(2, 9, 11, 2, generator=g)
    assert torch.allclose(R.upsample(4.0 * f, "bilinear4"), upsample4_plain(f, "bilinear", 4.0),
                          atol=1e-5)
    assert torch.equal(R.pad_symmetric(f[:, :8, :8], 9, 11), pad_flow_to(f[:, :8, :8], 9, 11))
    img = torch.rand(2, 12, 16, 3, generator=g)
    flow = torch.randn(2, 12, 16, 2, generator=g) * 5
    assert torch.allclose(R.warp(img, flow), dense_image_warp(img, flow), atol=1e-6)
    assert torch.equal(R.space_to_depth4(img), space_to_depth(img, 4))


def test_models_match():
    w = R.make_weights(3, 7, "cpu", 0.5)
    gen, fnet = program.models(CFG, w)
    g = torch.Generator().manual_seed(4)
    pair = torch.rand(2, 24, 32, 6, generator=g)
    assert torch.allclose(R.fnet(w, pair), fnet(pair), atol=1e-4)
    x = torch.rand(2, 8, 12, 51, generator=g)
    assert torch.allclose(R.generator(w, x, x[..., :3].contiguous()), gen(x), atol=1e-4)


def test_stream_matches_streaming_sr():
    from tecogan_tpu_torch.recurrent.inference import StreamingSR

    w = R.make_weights(3, 11, "cpu", 0.5)
    gen, fnet = program.models(CFG, w)
    clip = FR.with_warmup(FR.make_clip(torch.Generator().manual_seed(2), 14, 24, 40, "cpu"))
    sr = StreamingSR(program.teco_config(CFG, infer_chunk=6), gen, fnet, output="uint8",
                     device="cpu")
    got, _ = sr.run(clip.numpy(), warmup=0, chunk=6)
    ref = R.stream(w, clip, list(range(len(clip))))
    diffs = [np.abs(got[t].astype(int) - ref[t].numpy().astype(int)) for t in ref]
    assert max(d.max() for d in diffs) <= 1  # float32 on both sides: rounding at .5
    assert max(d.mean() for d in diffs) < 1e-3


def test_reference_is_float32_and_independent():
    import ast
    from pathlib import Path

    for path in (Path(R.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        assert not [m for m in mods if m and m.split(".")[0] in
                    ("tecogan_tpu", "tecogan_tpu_torch", "jax", "flax")], path
    with R.float32_math():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("workload", ["stream_vid4", "serve_1080p_live", "train_frvsr_resident"])
def test_cells_correct_on_the_cpu(tiny_manifest, workload):
    """Each cell's whole run at a tiny size (the look for a card skipped):
    the port's outputs agree with the reference, and the check says so."""
    result = run_cell(tiny_manifest, workload, 2**31 + 17, 0.5, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert list(result)[-1] == "checks"
