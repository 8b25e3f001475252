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

from chip_smoke import (
    BF16_D_LOSS_RTOL,
    BF16_ENTRIES,
    chain_oracle_bf16,
    entries_called,
    loss_scale,
    step_launch_want,
)
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


# K1 and K2 at the edges of their tile plans: one pixel (every tap clamps
# to it), H and W below the bicubic taps, a ragged B = 2 frame whose
# bfloat16 output rows are not a multiple of 16 bytes (4 x 53 x 3 x 2 B),
# and a W that is not a multiple of K1's 32-pixel tile.
EDGE_SHAPES = [(1, 1, 1, 2), (1, 2, 3, 3), (2, 37, 53, 3), (3, 9, 70, 2)]
EDGE_IDS = ["1x1", "2x3", "ragged", "w70"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_upsample4_kernel_matches_plain(cuda_device, shape, filt, dtype):
    """K1 against its plain version, alpha = 4: bit-equal in bfloat16 (each
    product of a bfloat16 value and a dyadic tap weight is exact in
    float32, so FMA contraction cannot change a sum); in float32 within
    2e-5, a few float32 ulps of values up to ~20 (FMA contraction)."""
    rng = np.random.RandomState(0)
    x = _tensor(rng, shape, 1.0, cuda_device).to(dtype)
    before = upsample4.launches
    got, want = upsample4(x, filt, alpha=4.0), upsample4_plain(x, filt, alpha=4.0)
    assert upsample4.launches == before + 1
    assert got.shape == want.shape == (shape[0], 4 * shape[1], 4 * shape[2], shape[3])
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


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
@pytest.mark.parametrize("shape,n", [((4, 32, 32), 10), ((1, 144, 180), 2), ((2, 37, 53), 3),
                                     ((1, 5, 7), 1)],
                         ids=["training", "calendar", "ragged", "tiny"])
def test_resblock_chain_f32_matches_plain(cuda_device, shape, n):
    """The float32 kernel (3xTF32 tensor-core products, clusters of 4 CTAs)
    against the plain chain with TF32 off: the training shape at its depth,
    the streaming frame, partial tiles on both axes with B = 2, and a frame
    smaller than one tile (most of each cluster's tile lies outside it).
    Tolerance 1e-4 of the output's scale, as chip_smoke.py: float32 sums in
    another order, and the ~2^-22 relative product the split drops."""
    rng = np.random.RandomState(7)
    c = 64
    lim = 0.5 * (6.0 / (2 * 9 * c)) ** 0.5
    args = [torch.relu(_tensor(rng, (*shape, c), 1.0, cuda_device))] + [
        _tensor(rng, s, k, cuda_device) for s, k in (
            ((n, 3, 3, c, c), lim), ((n, c), 0.1), ((n, 3, 3, c, c), lim), ((n, c), 0.1))]
    before, launches = args[0].clone(), resblock_chain.launches
    got, want = resblock_chain(*args), resblock_chain_plain(*args)
    assert resblock_chain.launches == launches + n
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    torch.testing.assert_close(args[0], before, rtol=0, atol=0)  # input untouched


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
def test_upsample4_bwd_rejects_too_many_channels(cuda_device):
    """K2 keeps a tile's channels in shared memory, as K1 does."""
    from tecogan_tpu_torch.kernels.upsample4 import MAX_CHANNELS

    g = torch.zeros(1, 8, 8, MAX_CHANNELS + 1, device=cuda_device)
    with pytest.raises(ValueError):
        upsample4_bwd(g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_upsample4_bwd_kernel_matches_plain(cuda_device, shape, filt, dtype):
    """K2 onto dx of the edge shapes, whose edge rows and columns collect
    the clamped taps, alpha = 4: float32 within 1e-4 (sums of up to 256
    products in another order, values up to ~40); bfloat16 within 1e-2 of
    the scale, as chip_smoke.py (both round after the H pass and at the
    end)."""
    rng = np.random.RandomState(2)
    b, h, w, c = shape
    g = _tensor(rng, (b, 4 * h, 4 * w, c), 1.0, cuda_device).to(dtype)
    before = upsample4_bwd.launches
    got, want = upsample4_bwd(g, filt, 4.0), upsample4_bwd_plain(g, filt, 4.0)
    assert upsample4_bwd.launches == before + 1
    assert got.shape == want.shape == shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        scale = max(1.0, want.float().abs().max())
        assert (got.float() - want.float()).abs().max() <= 1e-2 * scale


def _grads(fn, inputs, device):
    xs = [t.to(device, copy=True).requires_grad_() for t in inputs]
    out = fn(*xs)
    assert out.grad_fn is not None
    cot = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                           .astype(np.float32)).to(device)
    return [g.cpu() for g in torch.autograd.grad(out, xs, cot)]


@pytest.mark.cuda
@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=EDGE_IDS)
def test_upsample4_grad_edge_shapes_match_cpu(cuda_device, shape, filt):
    """The gradient of upsample4 (K1 forward, K2 backward) on the card
    against the CPU's plain versions, float32: within 1e-5 of the largest
    gradient entry."""
    rng = np.random.RandomState(14)
    x = torch.from_numpy((rng.randn(*shape) * 2.0).astype(np.float32))
    fn = lambda t: upsample4(t, filt, 4.0)  # noqa: E731
    (got,), (want,) = _grads(fn, [x], cuda_device), _grads(fn, [x], "cpu")
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
    """One FRVSR step on the card (2 blocks, 64 channels, real FNet), the
    captured step: every parameter of the generator and FNet gets a
    non-zero gradient, equal to the CPU's within 1e-3 of its largest entry,
    and K2 ran twice (the program's eager warm-up and one replay)."""
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
        assert upsample4_bwd.launches == before + 2 * (device.type == "cuda")
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(24, 32, 32, 9), (2, 37, 53, 9)], ids=["dst", "ragged"])
def test_upsample4_nine_channels_matches_plain(cuda_device, shape, dtype):
    """K1's generic-channel path at the discriminator's LR triplets (9
    channels, alpha 1) and at a ragged shape: bit-equal in bfloat16, float32
    within 2e-6 (values in [0, 1])."""
    x = torch.from_numpy(np.random.RandomState(15).rand(*shape).astype(np.float32))
    x = x.to(cuda_device, dtype)
    before = upsample4.launches
    got, want = upsample4(x, "bilinear"), upsample4_plain(x, "bilinear")
    assert upsample4.launches == before + 1
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("channels,size", [(27, 32), (9, 22)], ids=["dst", "odd"])
def test_discriminator_matches_cpu(cuda_device, channels, size):
    """The discriminator on the card (cuDNN, TF32 off, channels_last) against
    the CPU with the same weights: outputs and block activations within
    1e-4 of their scale, the running statistics after an update, and the
    gradient of every parameter within 1e-3 of its largest entry. 22 px
    reaches the odd sizes that TF SAME pads asymmetrically. An lrelu whose
    input (a batch norm's output, dense near 0) lies within rounding of 0
    takes different slopes on the two devices: at 128 px, with 1.3M such
    inputs, that moved one input-gradient entry by 4% of the largest and a
    block's kernel gradient by 0.5%. So the sizes stay small, and the input
    gradient, whose entries each see few activations, is not compared;
    chip_smoke.py phase 10 holds the discriminator at 128 px inside a
    TecoGAN step."""
    from tecogan_tpu_torch.models import Discriminator
    from tecogan_tpu_torch.models.layers import glorot_init_

    disc = glorot_init_(Discriminator(channels), torch.Generator().manual_seed(16))
    x = torch.from_numpy(np.random.RandomState(17).rand(4, size, size, channels)
                         .astype(np.float32))
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        d = Discriminator(channels).to(device, memory_format=torch.channels_last)
        d.load_state_dict(disc.state_dict())
        out, layers = d(x.to(device), update_stats=True)
        loss = out.mean() + sum(layer.square().mean() for layer in layers)
        grads = torch.autograd.grad(loss, list(d.parameters()))
        runs.append(([t.detach().cpu() for t in (out, *layers)], [g.cpu() for g in grads],
                     [b.cpu() for b in d.buffers()]))
    (acts, grads, stats), (acts_c, grads_c, stats_c) = runs
    for got, want in zip(acts + stats, acts_c + stats_c):
        assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    for got, want in zip(grads, grads_c):
        assert want.abs().max() > 0
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
def test_gan_step_matches_cpu(cuda_device):
    """One TecoGAN step on the card (2 blocks, the merged Dst, VGG19 random
    weights, ping-pong) against the CPU: the losses within 1e-4, every
    gradient of G, FNet and D within 1e-3 of its largest entry; the
    discriminator's update applied (gate open) and the kernels ran: K1 for
    the flow, the skips and the Dst's LR triplets, K2 once, each twice in
    this first, capturing call (the eager warm-up and one replay)."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19

    cfg = TECOGAN_PRESET.replace(num_resblock=2, batch_size=1, rnn_n=3, crop_size=16)
    tar = cfg.hr_load_size
    batch = (synthetic_clip(3, tar, tar, seed=18, content="natural")[None] * 255).astype(np.uint8)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        trainer = Trainer(cfg, device, vgg=random_vgg19(19))
        state = trainer.init_state(20)
        with torch.no_grad():  # flows mid-cell (see chip_smoke.py)
            state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
            state.fnet.output_conv2.weight.mul_(0.1)
        before = (upsample4.launches, upsample4_bwd.launches, resblock_chain.launches)
        _, metrics = trainer.train_step(state, batch)
        after = (upsample4.launches, upsample4_bwd.launches, resblock_chain.launches)
        if device.type == "cuda":
            assert [a - b for a, b in zip(after, before)] == [
                2 * (cfg.unroll_frames + 2), 2, 4 * cfg.unroll_frames]
        assert int(state.counter_with_d) == 1 and int(state.d_opt.count) == 1
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {f"{prefix}.{name}": p.grad.detach().cpu()
                      for prefix, module in (("g", state.generator), ("f", state.fnet),
                                             ("d", state.discriminator))
                      for name, p in module.named_parameters()}))
    (losses, grads), (losses_c, grads_c) = runs
    for k, want in losses_c.items():
        scale = abs(losses_c["t_adversarial_loss"]) if k == "t_balance" else abs(want)
        assert abs(losses[k] - want) <= 1e-4 * scale, k
    for name, want in grads_c.items():
        assert grads[name].abs().max() > 0, name
        assert (grads[name] - want).abs().max() <= 1e-3 * want.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["frvsr", "tecogan"])
def test_training_captured_matches_eager(cuda_device, mode):
    """Four steps of the captured training step (the default on the card)
    against four with capture=False from the same initial state, under
    torch.use_deterministic_algorithms and cuDNN's deterministic
    algorithms (2 blocks, the real FNet; TecoGAN with the merged Dst and
    VGG19 random weights): every state tensor bit-equal, the metrics of
    every step too. Then K2 counts once a replay, and a rebound state
    tensor makes the next step capture again."""
    _captured_matches_eager(cuda_device, mode, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["frvsr", "tecogan"])
def test_bf16_training_captured_matches_eager(cuda_device, mode):
    """As test_training_captured_matches_eager, in bfloat16 (float32 master
    weights): the bfloat16 warps' index_add backward is deterministic
    under torch.use_deterministic_algorithms too, so bit-equal."""
    _captured_matches_eager(cuda_device, mode, "bfloat16")


def _captured_matches_eager(cuda_device, mode, dtype):
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.train.trainer import named_state_tensors
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    base = TECOGAN_PRESET if mode == "tecogan" else FRVSR_PRESET
    cfg = base.replace(num_resblock=2, batch_size=1, rnn_n=3, crop_size=16,
                       compute_dtype=dtype)
    tar = cfg.hr_load_size
    batches = [(synthetic_clip(3, tar, tar, seed=30 + i, content="natural")[None] * 255
                ).astype(np.uint8) for i in range(4)]
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=False)
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for capture in (None, False):
            vgg = random_vgg19(3) if cfg.gan else None
            trainer = Trainer(cfg, cuda_device, vgg=vgg, capture=capture)
            state = trainer.init_state(6)
            captures = CapturedProgram.captures
            metrics = [{k: float(v) for k, v in trainer.train_step(state, b)[1].items()}
                       for b in batches]
            assert CapturedProgram.captures - captures == (capture is None)
            # Detached copies: a clone of a parameter would keep its grad
            # accumulator alive on this stream, and a later capture's
            # backward would have to wait on it.
            runs[capture] = (metrics, [(n, t.detach().clone())
                                       for n, t in named_state_tensors(state)])
            if capture is None:
                kept = (trainer, state)
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
    assert runs[None][0] == runs[False][0]
    for (name, a), (_, b) in zip(runs[None][1], runs[False][1]):
        assert torch.equal(a, b), name
    trainer, state = kept
    before = upsample4_bwd.launches
    trainer.train_step(state, batches[0])
    assert upsample4_bwd.launches == before + 1  # one replay, one K2
    state.ema_losses["l2_content_loss"] = state.ema_losses["l2_content_loss"].clone()
    trainer.train_step(state, batches[1])
    assert trainer.recaptures == 1
    assert upsample4_bwd.launches == before + 3  # a warm-up and a replay more


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["frvsr", "tecogan"])
def test_bf16_train_step_matches_cpu(cuda_device, mode):
    """One bfloat16 step on the card (2 blocks, the real FNet; TecoGAN with
    the merged Dst and VGG19 random weights, gate open), the captured step,
    against the CPU's bfloat16 step, held against the CPU's own bfloat16
    error (its float32 step), as chip_smoke.py's phases 7b and 10b: losses
    within max(1e-3 of scale (2^-6 for those read from the discriminator,
    see chip_smoke.BF16_D_LOSS_RTOL), 2x the CPU's own gap); per parameter
    ||card - CPU|| / ||CPU|| within 2x the CPU's own error + 0.02, median
    0.08. Only the bfloat16 kernel entries ran, each wrapper twice a
    step's launches (the warm-up and one replay); the parameters and their
    gradients are float32."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19

    base = TECOGAN_PRESET if mode == "tecogan" else FRVSR_PRESET
    cfg = base.replace(num_resblock=2, batch_size=1, rnn_n=3, crop_size=16,
                       compute_dtype="bfloat16")
    tar = cfg.hr_load_size
    batch = (synthetic_clip(3, tar, tar, seed=18, content="natural")[None] * 255).astype(np.uint8)
    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    runs = {}
    for device, dtype in ((cuda_device, "bfloat16"), ("cpu", "bfloat16"), ("cpu", "float32")):
        trainer = Trainer(cfg.replace(compute_dtype=dtype), device,
                          vgg=random_vgg19(19) if cfg.gan else None)
        state = trainer.init_state(20)
        with torch.no_grad():  # flows mid-cell (see chip_smoke.py)
            state.fnet.output_conv2.bias.copy_(torch.tensor([0.015625, -0.026]))
            state.fnet.output_conv2.weight.mul_(0.1)
        if cfg.gan:
            state.ema_tbalance = torch.tensor(-100.0, device=device)
        before = {k: w.launches for k, w in kernels.items()}
        with entries_called() as entries:
            _, metrics = trainer.train_step(state, batch)
        launches = {k: w.launches - before[k] for k, w in kernels.items()}
        if device != "cpu":
            assert set(entries) == BF16_ENTRIES, entries
            assert launches == {k: 2 * n for k, n in step_launch_want(cfg).items()}
        params = [(f"{prefix}.{name}", p) for prefix, module in (
            ("g", state.generator), ("f", state.fnet), ("d", state.discriminator))
            if module is not None for name, p in module.named_parameters()]
        assert all(p.dtype == p.grad.dtype == torch.float32 for _, p in params)
        runs[device if device == "cpu" else "card", dtype] = (
            {k: float(v) for k, v in metrics.items()},
            {name: p.grad.detach().cpu() for name, p in params})
    (losses, grads), (losses_c, grads_c), (losses_f, grads_f) = (
        runs["card", "bfloat16"], runs["cpu", "bfloat16"], runs["cpu", "float32"])
    for k, want in losses_c.items():
        rtol = BF16_D_LOSS_RTOL if k.startswith(("t_", "D_layer")) else 1e-3
        tol = max(rtol * loss_scale(k, losses_c), 2 * abs(want - losses_f[k]))
        assert abs(losses[k] - want) <= tol, k
    rels = []
    for name, want in grads_c.items():
        assert grads[name].abs().max() > 0, name
        own = (grads_f[name] - want).norm() / want.norm()
        rel = (grads[name] - want).norm() / want.norm()
        assert rel <= 2 * own + 0.02, (name, float(rel), float(own))
        rels.append(float(rel))
    assert np.median(rels) <= 0.08


@pytest.mark.cuda
@pytest.mark.parametrize("shape,filt,alpha", [
    ((36, 32, 32, 2), "bilinear", 4.0), ((4, 32, 32, 3), "bicubic", 1.0),
    ((24, 32, 32, 9), "bilinear", 1.0)], ids=["flow", "skip", "triplets"])
def test_upsample4_bf16_grad_matches_cpu(cuda_device, shape, filt, alpha):
    """bfloat16 training's K1 shapes through autograd: the backward is K2's
    bfloat16 entry on the card and its plain version on the CPU, which
    round at the same points (after the H pass and at the end): within
    1e-2 of the largest gradient entry, and the gradient stays bfloat16."""
    rng = np.random.RandomState(15)
    x = torch.from_numpy((rng.randn(*shape)).astype(np.float32)).bfloat16()
    cot = torch.from_numpy(rng.randn(shape[0], 4 * shape[1], 4 * shape[2], shape[3])
                           .astype(np.float32)).bfloat16()
    grads = []
    for device in (cuda_device, "cpu"):
        xs = x.to(device).requires_grad_()
        before = upsample4_bwd.launches
        (g,) = torch.autograd.grad(upsample4(xs, filt, alpha), xs, cot.to(device))
        assert g.dtype == torch.bfloat16
        assert upsample4_bwd.launches == before + (device != "cpu")
        grads.append(g.float().cpu())
    assert (grads[0] - grads[1]).abs().max() <= 1e-2 * grads[1].abs().max()


def _serving_models(seed, num_resblock):
    from tecogan_tpu_torch.models import FNet, Generator
    from tecogan_tpu_torch.models.layers import glorot_init_

    gen = torch.Generator().manual_seed(seed)
    return (glorot_init_(Generator(num_resblock, 64), gen),
            glorot_init_(FNet((32, 64, 128), (256, 128, 64)), gen))


@pytest.mark.cuda
def test_server_tick_matches_streaming(cuda_device):
    """A 1-slot VSRServer, tick by tick, against StreamingSR.run on the same
    stream, float32 with TF32 off: the same frame step at the same batch
    (FNet once a frame with chunks of 1); after the prewarm (which captures
    the tick, its warm-up tick running the kernels once) the chain and K1
    launch on every tick."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=4, infer_chunk=1)
    frames = (synthetic_clip(4, 32, 48, seed=21, content="natural") * 255).astype(np.uint8)
    srv = VSRServer(cfg, *_serving_models(22, 4), 32, 48, max_streams=1, output="float32",
                    device=cuda_device)
    srv.prewarm()
    srv.open("a")
    before = (upsample4.launches, resblock_chain.launches)
    got = np.stack([srv.step({"a": f})["a"] for f in frames])
    assert (upsample4.launches - before[0], resblock_chain.launches - before[1]) == (8, 16)
    want, _ = StreamingSR(cfg, *_serving_models(22, 4), output="float32",
                          device=cuda_device).run(frames)
    assert got.shape == want.shape == (4, 128, 192, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_round_trip_on_the_card(cuda_device, tmp_path, dtype):
    """The exported frame step, saved and loaded, against the live frame
    function on the card under cuDNN's deterministic algorithms: bit-equal,
    with the kernels' launches counted in the loaded program's replays."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.recurrent.step import RecurrentState
    from tecogan_tpu_torch.serve import (
        build_frame_fn, export_frame_step, load_frame_step, save_frame_step)
    from tecogan_tpu_torch.recurrent.inference import place_models

    cfg = TecoConfig(num_resblock=3, compute_dtype=dtype)
    gen, fnet = _serving_models(23, 3)
    path = str(tmp_path / "step.pt2")
    save_frame_step(export_frame_step(cfg, gen, fnet, batch=2, height=24, width=40,
                                      device=cuda_device), path)
    step = load_frame_step(path)
    rng = np.random.RandomState(24)
    state = RecurrentState(
        torch.from_numpy(rng.rand(2, 24, 40, 3)).to(cuda_device, cfg.torch_dtype),
        torch.from_numpy(rng.rand(2, 96, 160, 3)).to(cuda_device, cfg.torch_dtype))
    lr = torch.from_numpy((rng.rand(2, 24, 40, 3) * 255).astype(np.uint8)).to(cuda_device)
    gen, fnet = place_models(gen, fnet, cuda_device, cfg.torch_dtype)
    torch.backends.cudnn.deterministic = True
    try:
        before = (upsample4.launches, resblock_chain.launches)
        new_state, hr = step(state, lr)
        assert (upsample4.launches - before[0], resblock_chain.launches - before[1]) == (2, 3)
        with torch.inference_mode():
            ref_state, ref_hr = build_frame_fn(cfg, "uint8")(gen, fnet, state, lr)
    finally:
        torch.backends.cudnn.deterministic = False
    assert hr.dtype == torch.uint8 and hr.shape == (2, 96, 160, 3)
    assert torch.equal(hr, ref_hr)
    assert torch.equal(new_state.prev_hr, ref_state.prev_hr)
    assert torch.equal(new_state.prev_lr, ref_state.prev_lr)


def _run_server_script(srv, clips):
    """Streams attach on ticks 0 and 1, b sits out tick 2, a leaves and c
    takes its slot (a reset) on tick 3. Returns every output and the state
    after each tick, and each tick's launches (K1, chain)."""
    script = ["a", {"a": 0}, "b", {"a": 1, "b": 0}, {"a": 2},
              "-a", "c", {"b": 1, "c": 0}, {"b": 2, "c": 1}]
    outs, states, launches = [], [], []
    for step in script:
        if isinstance(step, str):
            srv.close(step[1:]) if step.startswith("-") else srv.open(step)
            continue
        before = (upsample4.launches, resblock_chain.launches)
        got = srv.step({sid: clips[sid][k] for sid, k in step.items()})
        launches.append((upsample4.launches - before[0], resblock_chain.launches - before[1]))
        outs.append({sid: got[sid] for sid in sorted(got)})
        states.append([t.cpu() for t in srv._state])
    return outs, states, launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_captured_matches_eager(cuda_device, monkeypatch, dtype):
    """StreamingSR captured (the default on the card) against capture=False
    under cuDNN's deterministic algorithms, 2 blocks, 32x48, chunks of 4
    with a ragged last one: bit-equal outputs, the same launches per run
    (3 chunks: K1 3 flows + 12 skips, the chain 2 x 12), one capture for the
    chunk shape across three runs and none on the eager side."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = TecoConfig(num_resblock=2, compute_dtype=dtype, infer_chunk=4)
    frames = (synthetic_clip(10, 32, 48, seed=25, content="natural") * 255).astype(np.uint8)
    outs, counts = [], []
    for capture in (None, False):
        sr = StreamingSR(cfg, *_serving_models(26, 2), output="float32", device=cuda_device,
                         capture=capture)
        assert sr.capture is (capture is None)
        captures = CapturedProgram.captures
        sr.run(frames, warmup=2)
        before = (upsample4.launches, resblock_chain.launches)
        out, _ = sr.run(frames, warmup=2)
        counts.append((upsample4.launches - before[0], resblock_chain.launches - before[1]))
        outs.append(out)
        sr.run(frames[:7], warmup=2)  # the same chunk shape
        assert CapturedProgram.captures - captures == (capture is None)
    assert counts[0] == counts[1] == (15, 24)
    assert outs[0].shape == (8, 128, 192, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_server_captured_matches_eager(cuda_device, monkeypatch):
    """A 2-slot VSRServer, bfloat16, captured against capture=False under
    cuDNN's deterministic algorithms, through a staggered attach, an idle
    slot and a slot handed to a new stream (a reset): bit-equal outputs and
    states after every tick, 2 K1 and 2 chain launches a tick on both."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import VSRServer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16")
    rng = np.random.RandomState(27)
    clips = {sid: (rng.rand(3, 24, 40, 3) * 255).astype(np.uint8) for sid in "abc"}
    runs = []
    for capture in (None, False):
        srv = VSRServer(cfg, *_serving_models(28, 2), 24, 40, max_streams=2, output="uint8",
                        device=cuda_device, capture=capture)
        srv.prewarm()
        runs.append(_run_server_script(srv, clips))
    (outs, states, launches), (outs_e, states_e, launches_e) = runs
    assert launches == launches_e == [(2, 2)] * len(outs)
    for got, want in zip(outs, outs_e):
        assert got.keys() == want.keys()
        for sid in got:
            np.testing.assert_array_equal(got[sid], want[sid])
    for got, want in zip(states, states_e):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_background_prewarm_captures_beside_ticks(cuda_device, monkeypatch):
    """MultiGeometryServer: two buckets captured on a background thread while
    a warm bucket keeps ticking on this one; afterwards every bucket's tick
    is a captured graph, and the outputs equal an eager server's on the
    same script (cuDNN deterministic)."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import MultiGeometryServer
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16")
    rng = np.random.RandomState(29)
    clip_a = (rng.rand(4, 32, 48, 3) * 255).astype(np.uint8)
    clip_b = (rng.rand(4, 24, 40, 3) * 255).astype(np.uint8)
    models = _serving_models(30, 2)
    srv = MultiGeometryServer(cfg, *models, slots_per_geometry=2, device=cuda_device)
    srv.prewarm([(32, 48)])
    srv.open("a", 32, 48)
    outs = []
    thread = srv.prewarm([(24, 40), (40, 56)], background=True)
    while thread.is_alive() and len(outs) < 400:
        outs.append(srv.step({"a": clip_a[len(outs) % 4]})["a"])
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert sorted(srv.geometries) == [(24, 40), (32, 48), (40, 56)]
    assert all(isinstance(p, CapturedProgram)
               for b in srv._buckets.values() for p in b._programs.values())
    srv.open("b", 24, 40)
    for t in range(3):
        got = srv.step({"a": clip_a[(len(outs)) % 4], "b": clip_b[t]})
        outs.append((got["a"], got["b"]))
    eager = MultiGeometryServer(cfg, *models, slots_per_geometry=2, device=cuda_device,
                                capture=False)
    eager.open("a", 32, 48)
    for t, out in enumerate(outs[:-3]):
        np.testing.assert_array_equal(out, eager.step({"a": clip_a[t % 4]})["a"])
    eager.open("b", 24, 40)
    for t, (a, b) in enumerate(outs[-3:]):
        want = eager.step({"a": clip_a[(len(outs) - 3 + t) % 4], "b": clip_b[t]})
        np.testing.assert_array_equal(a, want["a"])
        np.testing.assert_array_equal(b, want["b"])


@pytest.mark.cuda
def test_eviction_frees_the_graph_pool(cuda_device):
    """An evicted bucket's captured tick gives its memory pool back: after
    the eviction no device segment belongs to that graph's pool."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import MultiGeometryServer

    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16")
    srv = MultiGeometryServer(cfg, *_serving_models(31, 2), slots_per_geometry=1,
                              device=cuda_device)
    srv.state_budget_mb = srv.bucket_bytes(32, 48) / 2**20 * 1.5
    srv.open("a", 32, 48)
    srv.step({"a": np.zeros((32, 48, 3), np.uint8)})
    (tick,) = srv._buckets[(32, 48)]._programs.values()
    pool, held = tick.pool_id, tick.pool_bytes()
    assert held > 0
    # The budget counts captured pools: one that fits the new bucket and
    # its estimated pool, not both buckets.
    srv.state_budget_mb = 1.5 * (srv.bucket_bytes(40, 48) + srv.pool_estimate(40, 48)) / 2**20
    srv.close("a")
    srv.open("b", 40, 48)  # evicts the idle 32x48 bucket
    assert list(srv.geometries) == [(40, 48)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert not [s for s in torch.cuda.memory_snapshot()
                if tuple(s["segment_pool_id"]) == pool]


@pytest.mark.cuda
def test_state_budget_counts_the_captured_pool(cuda_device):
    """A budget below one bucket's captured graph pool, but over what the
    JAX formula (``bucket_bytes``) counts for two buckets: a second
    geometry is refused while the first bucket serves a stream, and evicts
    it once it is idle."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.serve import MultiGeometryServer

    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16")
    srv = MultiGeometryServer(cfg, *_serving_models(23, 2), slots_per_geometry=2,
                              state_budget_mb=None, device=cuda_device)
    g1, g2 = (32, 48), (24, 48)
    srv.prewarm([g1])
    pool = srv._buckets[g1].graph_pool_bytes()
    formula = srv.bucket_bytes(*g1) + srv.bucket_bytes(*g2)
    srv.state_budget_mb = 0.9 * pool / 2**20
    assert formula < srv.state_budget_mb * 2**20 and srv.footprint_bytes > pool
    assert srv.pool_estimate(*g2) == -(-pool * 3 // 4)
    srv.open("a", *g1)
    with pytest.raises(RuntimeError, match="every remaining bucket has open streams"):
        srv.open("b", *g2)
    assert list(srv.geometries) == [g1]
    srv.close("a")
    srv.open("b", *g2)  # evicts the idle g1 bucket
    assert list(srv.geometries) == [g2]


@pytest.mark.cuda
def test_capture_of_a_host_read_raises(cuda_device):
    """A body that reads a device value on the host cannot be captured: the
    capture raises, naming that line, and nothing runs eagerly in its
    place; the card keeps working. (Last in this file: it leaves a failed
    capture behind.)"""
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    x = torch.ones(4, device=cuda_device)
    out = torch.zeros(1, device=cuda_device)

    def body():
        if x.sum().item() > 0:  # a host read
            out.add_(1.0)
        return out

    captures = CapturedProgram.captures
    with pytest.raises(RuntimeError, match=r"capturing host read failed at .*\.item\(\)"):
        CapturedProgram(body, (x, out), name="host read")
    assert CapturedProgram.captures == captures
    assert out.item() == 1.0  # the warm-up ran once; no eager run replaced the capture
    assert torch.equal((x * 2).cpu(), torch.full((4,), 2.0))
