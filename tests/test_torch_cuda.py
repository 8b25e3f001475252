"""The port's CUDA kernels against their plain PyTorch versions, and its
autograd Functions and training step against the same on the CPU, on the
card.

Skipped without an NVIDIA GPU (the kernels have no CPU mode). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import chain_oracle_bf16
from tecogan_tpu_torch.config import FRVSR_PRESET
from tecogan_tpu_torch.data.synthetic import synthetic_clip
from tecogan_tpu_torch.kernels import (
    resblock_chain,
    resblock_chain_plain,
    upsample4,
    upsample4_bwd,
    upsample4_bwd_plain,
    upsample4_plain,
)
from tecogan_tpu_torch.train import Trainer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tensor(rng, shape, scale, device):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_upsample4_kernel_matches_plain(cuda_device, filt):
    """float32 at a ragged shape; tolerance: FMA contraction in the kernel,
    a few float32 ulps of values up to ~20."""
    rng = np.random.RandomState(0)
    x = _tensor(rng, (2, 37, 53, 3), 1.0, cuda_device)
    torch.testing.assert_close(upsample4(x, filt, alpha=4.0),
                               upsample4_plain(x, filt, alpha=4.0),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_resblock_chain_kernel_matches_plain(cuda_device):
    """float32 at a ragged shape (partial tiles on both axes), 3 blocks,
    batch 2; tolerance: float32 sums in another order over 6 convs."""
    rng = np.random.RandomState(1)
    c, n = 64, 3
    x = _tensor(rng, (2, 37, 53, c), 0.5, cuda_device)
    w1 = _tensor(rng, (n, 3, 3, c, c), 0.04, cuda_device)
    w2 = _tensor(rng, (n, 3, 3, c, c), 0.04, cuda_device)
    b1 = _tensor(rng, (n, c), 0.1, cuda_device)
    b2 = _tensor(rng, (n, c), 0.1, cuda_device)
    before = x.clone()
    got = resblock_chain(x, w1, b1, w2, b2)
    torch.testing.assert_close(got, resblock_chain_plain(x, w1, b1, w2, b2),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(x, before, rtol=0, atol=0)  # input untouched


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 53), (3, 20, 33), (1, 5, 7)],
                         ids=["ragged", "batch3", "tiny"])
def test_resblock_chain_bf16_matches_its_rounding_points(cuda_device, shape):
    """The bfloat16 tensor-core kernel, one block, against its rounding
    points repeated in float32 (chain_oracle_bf16): partial tiles on both
    axes, B = 3 on grid.z, a frame smaller than one tile. Tolerance 8e-3 of
    the output's scale, ~2 bfloat16 ulps: float32 sums in another order may
    flip a rounding of y or of the output."""
    rng = np.random.RandomState(5)
    c = 64
    lim = 0.5 * (6.0 / (2 * 9 * c)) ** 0.5
    x = torch.relu(_tensor(rng, (*shape, c), 1.0, cuda_device)).bfloat16()
    weights = [_tensor(rng, s, k, cuda_device).bfloat16()
               for s, k in (((1, 3, 3, c, c), lim), ((1, c), 0.1),
                            ((1, 3, 3, c, c), lim), ((1, c), 0.1))]
    before, launches = x.clone(), resblock_chain.launches
    got = resblock_chain(x, *weights)
    want = chain_oracle_bf16(x, *weights)
    assert resblock_chain.launches == launches + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max() <= 8e-3 * max(1.0, want.float().abs().max())
    torch.testing.assert_close(x, before, rtol=0, atol=0)  # input untouched


@pytest.mark.cuda
def test_resblock_chain_bf16_matches_plain(cuda_device):
    """Three bfloat16 blocks at a ragged shape with B = 2 against the plain
    chain, which rounds after every op: 5e-2 of the output's scale, as in
    chip_smoke.py."""
    rng = np.random.RandomState(6)
    c, n = 64, 3
    lim = 0.5 * (6.0 / (2 * 9 * c)) ** 0.5
    args = [torch.relu(_tensor(rng, (2, 37, 53, c), 1.0, cuda_device))] + [
        _tensor(rng, s, k, cuda_device) for s, k in (
            ((n, 3, 3, c, c), lim), ((n, c), 0.1), ((n, 3, 3, c, c), lim), ((n, c), 0.1))]
    args = [t.bfloat16() for t in args]
    got, want = resblock_chain(*args).float(), resblock_chain_plain(*args).float()
    assert (got - want).abs().max() <= 5e-2 * max(1.0, want.abs().max())


@pytest.mark.cuda
def test_resblock_chain_rejects_other_widths(cuda_device):
    x = torch.zeros(1, 8, 8, 32, device=cuda_device)
    w = torch.zeros(1, 3, 3, 32, 32, device=cuda_device)
    b = torch.zeros(1, 32, device=cuda_device)
    with pytest.raises(ValueError):
        resblock_chain(x, w, b, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
def test_upsample4_bwd_kernel_matches_plain(cuda_device, filt):
    """K2, float32, at a ragged shape whose edge rows and columns collect
    the clamped taps; tolerance: float32 sums of up to 256 products in
    another order, values up to ~40."""
    rng = np.random.RandomState(2)
    g = _tensor(rng, (2, 148, 212, 3), 1.0, cuda_device)
    before = upsample4_bwd.launches
    torch.testing.assert_close(upsample4_bwd(g, filt, 4.0),
                               upsample4_bwd_plain(g, filt, 4.0), rtol=0, atol=1e-4)
    assert upsample4_bwd.launches == before + 1


def _grads(fn, inputs, device):
    xs = [t.to(device, copy=True).requires_grad_() for t in inputs]
    out = fn(*xs)
    assert out.grad_fn is not None
    cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                           .astype(np.float32)).to(device)
    return [g.cpu() for g in torch.autograd.grad(out, xs, cot)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bilinear", "bicubic", "chain"])
def test_function_grads_match_cpu(cuda_device, case):
    """Each autograd Function's gradients on the card (K1 forward, K2
    backward; chain kernel forward, cuDNN replay backward) against the same
    Function on the CPU, float32, TF32 off; tolerance relative to each
    gradient's largest entry: K2 vs its plain version, or cuDNN vs the CPU's
    convolutions through 3 blocks."""
    rng = np.random.RandomState(4)

    def arr(shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    c, n = 64, 3
    fn, inputs, tol = {
        "bilinear": (lambda x: upsample4(x, "bilinear", 4.0), [arr((2, 37, 53, 2), 2.0)], 1e-5),
        "bicubic": (lambda x: upsample4(x, "bicubic"), [arr((2, 37, 53, 3), 1.0)], 1e-5),
        "chain": (resblock_chain, [arr((2, 37, 53, c), 0.5), arr((n, 3, 3, c, c), 0.04),
                                   arr((n, c), 0.1), arr((n, 3, 3, c, c), 0.04),
                                   arr((n, c), 0.1)], 1e-4),
    }[case]
    for got, want in zip(_grads(fn, inputs, cuda_device), _grads(fn, inputs, "cpu")):
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_train_step_reaches_every_parameter(cuda_device):
    """One FRVSR step on the card (2 blocks, 64 channels, real FNet): every
    parameter of the generator and FNet gets a non-zero gradient, equal to
    the CPU's within 1e-3 of its largest entry, and K2 ran once."""
    cfg = FRVSR_PRESET.replace(num_resblock=2, batch_size=2, rnn_n=3, crop_size=16)
    tar = cfg.hr_load_size
    batch = (np.stack([synthetic_clip(3, tar, tar, seed=s, content="natural")
                       for s in (5, 6)]) * 255).astype(np.uint8)
    grads, losses = [], []
    for device in (cuda_device, torch.device("cpu")):
        trainer = Trainer(cfg, device)
        state = trainer.init_state(3)
        with torch.no_grad():  # flows mid-cell (see chip_smoke.py)
            state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
            state.fnet.output_conv2.weight.mul_(0.1)
        before = upsample4_bwd.launches
        _, metrics = trainer.train_step(state, batch)
        assert upsample4_bwd.launches == before + (device.type == "cuda")
        losses.append(float(metrics["All_loss_Gen"]))
        grads.append({f"{prefix}.{name}": p.grad.detach().cpu()
                      for prefix, module in (("g", state.generator), ("f", state.fnet))
                      for name, p in module.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-4 * losses[1]
    assert grads[0].keys() == grads[1].keys()
    for name, want in grads[1].items():
        got = grads[0][name]
        assert got.abs().max() > 0, name
        assert (got - want).abs().max() <= 1e-3 * want.abs().max(), name


@pytest.mark.cuda
def test_blur_matches_cpu(cuda_device):
    """The inference CLI's HR -> LR blur on the card against the CPU: the
    same taps in the same order, float32."""
    from tecogan_tpu_torch.data.inference import hr_to_lr

    frames = np.random.RandomState(10).randint(0, 256, (2, 96, 120, 3)).astype(np.uint8)
    got, want = hr_to_lr(frames, cuda_device), hr_to_lr(frames, "cpu")
    assert got.shape == (2, 24, 30, 3) and np.abs(got - want).max() <= 1e-6


@pytest.mark.cuda
def test_farneback_matches_cpu(cuda_device):
    """tOF's Farneback flow on the card against the CPU (elementwise ops
    and gathers in one order on both): within 1e-4 px."""
    from tecogan_tpu_torch.eval import farneback_flow, rgb_to_gray

    clip = (synthetic_clip(2, 96, 128, seed=7, content="natural") * 255).astype(np.uint8)
    prev, cur = (torch.from_numpy(rgb_to_gray(f)) for f in clip)
    got = farneback_flow(prev.to(cuda_device), cur.to(cuda_device))
    assert got.device.type == "cuda" and got.shape == (96, 128, 2)
    want = farneback_flow(prev, cur)
    assert (got.cpu() - want).abs().max() <= 1e-4
    assert want.abs().max() > 0.1


@pytest.mark.cuda
def test_lpips_matches_cpu(cuda_device):
    """LPIPS with seeded random weights on the card (cuDNN, TF32 off inside
    the module) against the CPU: rtol 1e-4."""
    from tecogan_tpu_torch.eval import LPIPS, random_alexnet_params

    rng = np.random.RandomState(11)
    alex = random_alexnet_params(3)
    lin = [np.abs(rng.randn(c)).astype(np.float32) for c in (64, 192, 384, 256, 256)]
    img0 = (rng.rand(2, 96, 128, 3) * 2 - 1).astype(np.float32)
    img1 = (rng.rand(2, 96, 128, 3) * 2 - 1).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True  # the module switches it off itself
    try:
        got = LPIPS(alex, lin, cuda_device)(img0, img1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = LPIPS(alex, lin, "cpu")(img0, img1)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_inference_cli_matches_streaming(cuda_device, tmp_path, monkeypatch):
    """cli.main --mode inference on the card, 10 LR PNGs at 2 resblocks,
    float32: the HR PNGs equal StreamingSR.run on the same frames and
    weights, and the kernels ran. Both runs use cuDNN's deterministic
    algorithms: a transposed conv may otherwise sum with atomics, and one
    float ulp can flip a uint8 level."""
    from tecogan_tpu_torch.cli.main import main
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.inference import load_inference_frames, read_frames
    from tecogan_tpu_torch.data.png import write_png
    from tecogan_tpu_torch.models import FNet, Generator
    from tecogan_tpu_torch.models.layers import glorot_init_
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.weights import params_to_npz, to_jax_params

    lr_dir = tmp_path / "lr"
    lr_dir.mkdir()
    clip = (synthetic_clip(10, 36, 44, seed=8, content="natural") * 255).astype(np.uint8)
    for i, frame in enumerate(clip):
        write_png(str(lr_dir / f"f{i}.png"), frame)
    gen = torch.Generator().manual_seed(9)
    models = (glorot_init_(Generator(2, 64), gen), glorot_init_(FNet(), gen))
    gtree, ftree = to_jax_params(*models)
    params_to_npz(str(tmp_path / "w.npz"), generator=gtree, fnet=ftree)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    before =(upsample4.launches, resblock_chain.launches)
    stats = main(["--mode", "inference", "--device", "cuda", "--input_dir_LR", str(lr_dir),
                  "--output_dir", str(tmp_path / "out"), "--params_npz", str(tmp_path / "w.npz"),
                  "--infer_chunk", "6", "--num_resblock", "2"])
    assert stats["written"] == 10
    assert upsample4.launches - before[0] >= 15 + 3
    assert resblock_chain.launches - before[1] >= 2 * 15
    names = [f"output_{i:04d}.png" for i in range(10)]
    assert sorted(p.name for p in (tmp_path / "out").glob("*.png")) == names
    got = read_frames([str(tmp_path / "out" / n) for n in names])

    sr = StreamingSR(TecoConfig(num_resblock=2, infer_chunk=6), *models,
                     output="uint8", device=cuda_device)
    want, _ = sr.run(load_inference_frames(input_dir_lr=str(lr_dir), as_uint8=True).inputs,
                     warmup=5)
    np.testing.assert_array_equal(got, want)
