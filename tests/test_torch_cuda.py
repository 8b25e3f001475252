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
import torch.nn.functional as F

from chip_smoke import (
    BF16_D_LOSS_RTOL,
    BF16_ENTRIES,
    chain_oracle_bf16,
    check_generate,
    check_summaries,
    entries_called,
    loss_scale,
    step_launch_want,
    watched_summaries,
)
from tecogan_tpu_torch.config import FRVSR_PRESET
from tecogan_tpu_torch.data.synthetic import synthetic_clip
from tecogan_tpu_torch.kernels import (
    bias_relu_crop,
    bias_relu_crop_plain,
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


# The transposed convs' raw outputs (B, C, 2H + 1, 2W + 1) that the epilogue
# crops: 2160p's 4x and 2x convs, a 5-slot 1080p serving tick's 4x conv, and
# small ones: a 2x3 output, one pixel, and 24 channels (three bfloat16
# vectors a pixel, a block of 255 threads) on a ragged width.
EPILOGUE_SHAPES = [(1, 64, 2161, 3841), (1, 64, 1081, 1921), (5, 64, 1081, 1921),
                   (2, 64, 3, 5), (1, 64, 2, 2), (3, 24, 9, 71)]
EPILOGUE_IDS = ["2160p_4x", "2160p_2x", "serve_4x", "2x3", "1px", "24ch"]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _conv_output(shape, dtype, device, seed):
    """A conv output as cuDNN leaves it: dense in channels_last."""
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(shape, generator=gen, device=device).to(dtype)
    return y.contiguous(memory_format=torch.channels_last)


def _two_passes(y, bias):
    """What the epilogue replaces, as ATen runs a biased cuDNN transposed
    conv and the ReLU: ``add_`` of the bias over all of y, then ``F.relu``
    of the SAME crop."""
    return F.relu(y.clone().add_(bias.view(1, -1, 1, 1))[..., :-1, :-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES, ids=EPILOGUE_IDS)
def test_bias_relu_crop_kernel_matches_plain(cuda_device, shape, dtype):
    """The epilogue against its plain version and the two ATen passes it
    replaces: bit-equal (its rounding points are add_'s and clamp_min's),
    dense in channels_last, one launch."""
    b, c, h1, w1 = shape
    y = _conv_output(shape, dtype, cuda_device, 31)
    bias = (0.5 * torch.randn(c, generator=torch.Generator().manual_seed(32))).to(
        cuda_device, dtype)
    before = bias_relu_crop.launches
    got = bias_relu_crop(y, bias)
    assert bias_relu_crop.launches == before + 1
    assert got.shape == (b, c, h1 - 1, w1 - 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, bias_relu_crop_plain(y, bias))
    assert torch.equal(got, _two_passes(y, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bias_relu_crop_passes_nan_and_signed_zeros_as_aten(cuda_device, dtype):
    """NaN (both signs), infinities, signed zeros and values whose sum with
    the bias is a signed zero, with biases of -0, +0, NaN and inf among the
    channels: the same bits as the two ATen passes."""
    nan, inf = float("nan"), float("inf")
    specials = torch.tensor([nan, -nan, inf, -inf, -0.0, 0.0, 1.0, -1.0, 1e-30, -1e-30])
    gen = torch.Generator().manual_seed(33)
    shape = (2, 16, 7, 9)
    y = torch.randn(shape, generator=gen)
    pick = torch.rand(shape, generator=gen) < 0.5
    y[pick] = specials[torch.randint(len(specials), (int(pick.sum()),), generator=gen)]
    bias = torch.tensor([-0.0, 0.0, nan, inf, -inf, 1.0, -1.0, 0.5] * 2)
    y = y.to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    y[:, 5, ::2, ::3] = -1.0  # + 1.0: +0 from a sum
    y[:, 6, ::2, ::3] = 1.0   # - 1.0: +0 from a sum
    bias = bias.to(cuda_device, dtype)
    got, want = bias_relu_crop(y, bias), _two_passes(y, bias)
    assert torch.isnan(want).any() and (want == 0).any()
    bits = _BITS[dtype]
    diff = got.view(bits) != want.view(bits)
    assert not diff.any(), (f"{int(diff.sum())} values differ: got {got[diff][:8].tolist()} "
                            f"want {want[diff][:8].tolist()} from y {y[..., :-1, :-1][diff][:8]}")
    assert torch.equal(bias_relu_crop_plain(y, bias).view(bits), want.view(bits))


@pytest.mark.cuda
def test_bias_relu_crop_rejects_what_the_kernel_does_not_take(cuda_device):
    """C not a multiple of the 16-byte vector (C = 3), NCHW-contiguous y,
    y and bias on two devices (either way), mixed or other dtypes: raises,
    with no fallback and no launch."""
    y = _conv_output((1, 64, 5, 7), torch.bfloat16, cuda_device, 34)
    bias = torch.zeros(64, device=cuda_device, dtype=torch.bfloat16)
    before = bias_relu_crop.launches
    for dtype, vector in ((torch.bfloat16, 8), (torch.float32, 4)):
        y3 = _conv_output((1, 3, 5, 7), dtype, cuda_device, 35)
        with pytest.raises(ValueError, match=f"multiple of {vector}"):
            bias_relu_crop(y3, torch.zeros(3, device=cuda_device, dtype=dtype))
    with pytest.raises(ValueError, match="channels_last"):
        bias_relu_crop(y.contiguous(), bias)
    with pytest.raises(ValueError, match="y is on cuda:0 and bias on cpu"):
        bias_relu_crop(y, bias.cpu())
    with pytest.raises(ValueError, match="y is on cpu and bias on cuda:0"):
        bias_relu_crop(y.cpu(), bias)
    with pytest.raises(TypeError, match="one dtype"):
        bias_relu_crop(y, bias.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bias_relu_crop(y.half(), bias.half())
    assert bias_relu_crop.launches == before


@pytest.mark.cuda
def test_generator_epilogue_equals_two_passes_at_2160p(cuda_device, monkeypatch):
    """Generator.forward under inference_mode on a 540x960 input (the
    2160p cell's frame: 16 blocks, bfloat16, the models in channels_last as
    the streaming path places them) against the two-pass composition
    (F.relu of the biased transposed conv's crop), cuDNN deterministic:
    bit-equal, with 2 epilogue launches a call and none on the two passes."""
    from tecogan_tpu_torch.models.layers import Conv2Tran, glorot_init_
    from tecogan_tpu_torch.models.generator import Generator
    from tecogan_tpu_torch.recurrent.inference import place_models
    from tecogan_tpu_torch.models.fnet import FNet

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gen = glorot_init_(Generator(16, 64), torch.Generator().manual_seed(36))
    with torch.no_grad():
        for conv in (gen.conv_tran1, gen.conv_tran2):
            conv.bias.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(37))
    gen, _ = place_models(gen, FNet(), cuda_device, torch.bfloat16)
    x = torch.rand((1, 540, 960, 51), generator=torch.Generator().manual_seed(38)).to(
        cuda_device)
    outs, launches = [], []
    for two_passes in (False, True):
        if two_passes:
            monkeypatch.setattr(Conv2Tran, "forward_relu", lambda self, x: F.relu(self(x)))
        before = bias_relu_crop.launches
        with torch.inference_mode():
            outs.append(gen(x))
        torch.cuda.synchronize()
        launches.append(bias_relu_crop.launches - before)
    assert launches == [2, 0]
    assert outs[0].shape == (1, 2160, 3840, 3)
    assert torch.equal(outs[0], outs[1])


# The recurrent step's input: HR frames of the three inference cells
# (2160p, a 5-slot 1080p serving tick, Vid4) and a ragged one whose LR size
# (45 x 47) is not a multiple of the kernel's tile.
WARP_PACK_SHAPES = [(1, 2160, 3840), (5, 1080, 1920), (1, 576, 720), (2, 180, 188)]
WARP_PACK_IDS = ["2160p", "serve5", "vid4", "ragged"]


def _warp_pack_inputs(shape, dtype, device, seed):
    """lr, image and a flow of (dy, dx) up to 96 HR pixels, which crosses
    every border, with a tenth of the pixels at whole-pixel flows (fraction
    0) and a hundredth far outside the frame (the clamps)."""
    b, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    lr = torch.rand((b, h // 4, w // 4, 3), generator=gen, device=device)
    image = torch.rand((b, h, w, 3), generator=gen, device=device)
    flow = (torch.rand((b, h, w, 2), generator=gen, device=device) * 2 - 1) * 96
    pick = torch.rand((b, h, w, 1), generator=gen, device=device)
    flow = torch.where(pick < 0.1, flow.round(), flow)
    flow = torch.where(pick > 0.99, flow * 100, flow)
    return lr.to(dtype), image.to(dtype), flow.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", WARP_PACK_SHAPES, ids=WARP_PACK_IDS)
def test_warp_pack_kernel_matches_plain(cuda_device, shape, dtype):
    """The warp, pack and concat in one launch against the ATen route it
    replaces (``cat([lr, warp_space_to_depth(...)])``): bit-equal, its
    rounding points being the ATen ops'."""
    from tecogan_tpu_torch.kernels import warp_pack, warp_pack_plain

    lr, image, flow = _warp_pack_inputs(shape, dtype, cuda_device, 41)
    before = warp_pack.launches
    got = warp_pack(lr, image, flow)
    assert warp_pack.launches == before + 1
    want = warp_pack_plain(lr, image, flow)
    assert got.shape == want.shape == (shape[0], shape[1] // 4, shape[2] // 4, 51)
    bits = _BITS[dtype]
    diff = got.view(bits) != want.view(bits)
    assert not diff.any(), (f"{int(diff.sum())} values differ, first at "
                            f"{diff.nonzero()[:4].tolist()}: got {got[diff][:8].tolist()} "
                            f"want {want[diff][:8].tolist()}")


@pytest.mark.cuda
def test_warp_pack_rejects_what_the_kernel_does_not_take(cuda_device):
    """Inputs on two devices, a non-contiguous image, mixed dtypes, an image
    whose data starts between two 4-byte words: raises, with no fallback and
    no launch."""
    from tecogan_tpu_torch.kernels import warp_pack

    lr, image, flow = _warp_pack_inputs((1, 16, 24), torch.bfloat16, cuda_device, 42)
    before = warp_pack.launches
    with pytest.raises(ValueError, match="are on cpu, cuda:0 and cuda:0"):
        warp_pack(lr.cpu(), image, flow)
    with pytest.raises(ValueError, match="are on cuda:0, cuda:0 and cpu"):
        warp_pack(lr, image, flow.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        warp_pack(lr, image.transpose(1, 2).contiguous().transpose(1, 2), flow)
    with pytest.raises(TypeError, match="one dtype"):
        warp_pack(lr, image, flow.float())
    shifted = torch.empty(image.numel() + 1, dtype=image.dtype, device=cuda_device)[1:]
    shifted = shifted.view(image.shape).copy_(image)
    with pytest.raises(ValueError, match="image aligned to 4 bytes"):
        warp_pack(lr, shifted, flow)
    assert warp_pack.launches == before


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
@pytest.mark.parametrize("shape,n", [
    ((1, 540, 960), 2), ((5, 270, 480), 1), ((1, 144, 180), 2), ((4, 32, 32), 2),
    ((1, 80, 180), 4), ((2, 37, 53), 1), ((3, 20, 33), 1), ((1, 5, 7), 1)],
    ids=["2160p", "serve-5-slots", "vid4", "training", "shard", "ragged", "batch3", "tiny"])
def test_resblock_chain_bf16_matches_its_rounding_points(cuda_device, shape, n):
    """The bfloat16 warpgroup-MMA kernel against its rounding points
    repeated in float32 (chain_oracle_bf16) at each path's shape: a 2160p
    stream's LR frame (16 strips x 8 segments), a 5-slot 1080p serving
    tick (several units a CTA), Vid4, bfloat16 training's crops, the first
    of 2 row shards of a Vid4 frame with its 8-row halo
    (``parallel/spatial.py``, 4 blocks a call), partial strips and
    segments, B = 3, a frame smaller than one strip. Tolerance 8e-3 of the
    output's scale, ~2 bfloat16 ulps: float32 sums in another order may
    flip a rounding of y or of the output. One launch a block; the input
    is left as it was."""
    rng = np.random.RandomState(5)
    c = 64
    lim = 0.5 * (6.0 / (2 * 9 * c)) ** 0.5
    x = torch.relu(_tensor(rng, (*shape, c), 1.0, cuda_device)).bfloat16()
    weights = [_tensor(rng, s, k, cuda_device).bfloat16()
               for s, k in (((n, 3, 3, c, c), lim), ((n, c), 0.1),
                            ((n, 3, 3, c, c), lim), ((n, c), 0.1))]
    before, launches = x.clone(), resblock_chain.launches
    got = resblock_chain(x, *weights)
    want = chain_oracle_bf16(x, *weights)
    assert resblock_chain.launches == launches + n
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
def test_captured_gan_step_records_no_stage_spans(cuda_device):
    """The TecoGAN step's stage spans on the card, where a span is off
    while a stream captures: under a profiler, a trainer's first, capturing
    call records each stage once (the capture's eager warm-up) and its
    capture none; its replays record ``train.step`` and ``graph.replay``
    and no stage; an eager trainer (``capture=False``) records every stage
    a step. The gate's counters read as the steps taken."""
    from tecogan_tpu_torch.config import TECOGAN_PRESET
    from tecogan_tpu_torch.models.vgg19 import random_vgg19
    from tecogan_tpu_torch.utils import profiling

    stages = ("train.unroll", "train.vgg", "train.dst", "train.backward", "train.adam",
              "train.d_step")
    cfg = TECOGAN_PRESET.replace(num_resblock=2, batch_size=1, rnn_n=3, crop_size=16)
    tar = cfg.hr_load_size
    batch = (synthetic_clip(3, tar, tar, seed=40, content="natural")[None] * 255
             ).astype(np.uint8)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts = {}
    for capture in (None, False):
        trainer = Trainer(cfg, cuda_device, vgg=random_vgg19(3), capture=capture)
        state = trainer.init_state(7)
        profiling.clear()
        with torch.profiler.profile(activities=acts):
            for _ in range(3):
                trainer.train_step(state, batch)
            torch.cuda.synchronize()
        names = [r.name for r in profiling.spans()]
        counts[capture] = {n: names.count(n) for n in (*stages, "train.step", "graph.replay")}
        assert int(state.counter_with_d) + int(state.counter_wo_d) == 3
    assert counts[None] == {**{s: 1 for s in stages}, "train.step": 3, "graph.replay": 3}
    assert counts[False] == {**{s: 3 for s in stages}, "train.step": 3, "graph.replay": 0}
    profiling.clear()


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
    the tick, its warm-up tick running the kernels once) the chain, K1,
    the transposed convs' epilogue (2 a tick) and the warp's ``warp_pack``
    (1 a tick) launch on every tick."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import warp_pack
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=4, infer_chunk=1)
    frames = (synthetic_clip(4, 32, 48, seed=21, content="natural") * 255).astype(np.uint8)
    srv = VSRServer(cfg, *_serving_models(22, 4), 32, 48, max_streams=1, output="float32",
                    device=cuda_device)
    srv.prewarm()
    srv.open("a")
    before = (upsample4.launches, resblock_chain.launches, bias_relu_crop.launches,
              warp_pack.launches)
    got = np.stack([srv.step({"a": f})["a"] for f in frames])
    assert (upsample4.launches - before[0], resblock_chain.launches - before[1],
            bias_relu_crop.launches - before[2], warp_pack.launches - before[3]) == (8, 16, 8, 4)
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
    from tecogan_tpu_torch.kernels import warp_pack
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
        before = (upsample4.launches, resblock_chain.launches, bias_relu_crop.launches,
                  warp_pack.launches)
        new_state, hr = step(state, lr)
        assert (upsample4.launches - before[0], resblock_chain.launches - before[1],
                bias_relu_crop.launches - before[2], warp_pack.launches - before[3]) == \
            (2, 3, 2, 1)
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
    (3 chunks: K1 3 flows + 12 skips, the chain 2 x 12, the transposed
    convs' epilogue 2 a frame, 2 x 12, ``warp_pack`` 1 a frame, 12, counted
    once a frame in every replay), one capture for the
    chunk shape across three runs and none on the eager side."""
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.kernels import warp_pack
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
        before = (upsample4.launches, resblock_chain.launches, bias_relu_crop.launches,
                  warp_pack.launches)
        out, _ = sr.run(frames, warmup=2)
        counts.append((upsample4.launches - before[0], resblock_chain.launches - before[1],
                       bias_relu_crop.launches - before[2], warp_pack.launches - before[3]))
        outs.append(out)
        sr.run(frames[:7], warmup=2)  # the same chunk shape
        assert CapturedProgram.captures - captures == (capture is None)
    assert counts[0] == counts[1] == (15, 24, 24, 12)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_captured_matches_eager(cuda_device, dtype):
    """The summaries' generate program, captured, against ``capture=False``
    under deterministic algorithms: bit-equal, and exactly the chain N x T
    and K1 T + 1 launches a replay (``chip_smoke.check_generate``)."""
    cfg = FRVSR_PRESET.replace(num_resblock=3, rnn_n=4, batch_size=2, compute_dtype=dtype)
    state = Trainer(cfg, cuda_device).init_state(0)
    got = check_generate(cuda_device, cfg, state, "[test generate]", "test")
    assert got["ms"] > 0 and got["pool"] > 0


@pytest.mark.cuda
def test_train_writes_four_gifs_on_the_card(cuda_device, tmp_path):
    """train() on the card with a save: the four tags' GIFs and images of
    each save, generate's launches (twice at its capture), every event
    record's CRC (``chip_smoke.check_summaries``)."""
    from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes
    from tecogan_tpu_torch.train.loop import train

    scenes = str(tmp_path / "scenes")
    write_synthetic_scenes(scenes, 2, 6, 60, 64, start_index=2000)
    cfg = FRVSR_PRESET.replace(input_video_dir=scenes, num_resblock=2, crop_size=8,
                               batch_size=2, rnn_n=4, max_frm=5, queue_thread=2,
                               save_freq=2)
    kernels = {"resblock_chain": resblock_chain, "upsample4": upsample4,
               "upsample4_bwd": upsample4_bwd}
    out = str(tmp_path / "run")
    with watched_summaries(kernels) as (calls, writes):
        train(cfg, out, cuda_device, max_steps=3, test_while_train=False)
    check_summaries("[test train]", cfg, {str(tmp_path / "run" / "log"): [2, 3]}, calls, writes)
    assert len(calls) == 2 and calls[0]["trainer"].capture


@pytest.mark.cuda
def test_device_time_on_the_card(cuda_device):
    from tecogan_tpu_torch.utils.profiling import device_time, device_time_samples, sync

    x = torch.randn(512, 512, device=cuda_device)
    assert device_time(torch.matmul, x, x, iters=5, warmup=1) > 0
    assert len(device_time_samples(torch.matmul, x, x, iters=2, passes=3)) == 3
    assert sync(x) == pytest.approx(float(x.sum().cpu()))


@pytest.mark.cuda
def test_cli_input_video_matches_png_route(cuda_device, tmp_path):
    """chip_smoke.py phase 14 (c) in small: ``cli.main --input_video`` on the
    card equals the same CLI on a PNG directory of the port's decode of the
    clip, bit for bit under cuDNN's deterministic algorithms, both through
    the chain and K1 as often."""
    import contextlib
    import io

    from chip_smoke import build_models, video_clip
    from tecogan_tpu_torch.cli.main import main
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.data.inference import read_frames
    from tecogan_tpu_torch.data.png import write_png
    from tecogan_tpu_torch.data.video_io import VideoFrameWriter, read_video_frames
    from tecogan_tpu_torch.weights import params_to_npz, to_jax_params

    clip, png_dir = str(tmp_path / "clip.mp4"), tmp_path / "lr"
    w = VideoFrameWriter(clip, fps=24.0)
    w.submit(video_clip(12, 32, 40, seed=3), 0)
    w.close()
    png_dir.mkdir()
    for i, f in enumerate(read_video_frames(clip)[0]):
        write_png(str(png_dir / f"{i:04d}.png"), f)
    npz = str(tmp_path / "params.npz")
    gen_tree, fnet_tree = to_jax_params(*build_models(0, TecoConfig(num_resblock=2)))
    params_to_npz(npz, generator=gen_tree, fnet=fnet_tree)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, src in (("video", ["--input_video", clip]),
                          ("png", ["--input_dir_LR", str(png_dir)])):
            upsample4.launches = resblock_chain.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                main(["--mode", "inference", "--output_dir", str(tmp_path / name),
                      "--params_npz", npz, *src])
            out = read_frames([str(tmp_path / name / f"output_{i:04d}.png") for i in range(12)])
            runs[name] = out, (upsample4.launches, resblock_chain.launches)
    finally:
        torch.backends.cudnn.deterministic = False
    (got, got_n), (want, want_n) = runs["video"], runs["png"]
    assert got.shape == (12, 128, 160, 3) and got.std() > 1.0
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n and min(got_n) > 0


# ---------------------------------------------------------------- NVDEC
# The test streams (tests/nvdec_streams.py, numpy only), imported from this
# directory.
def _nvdec_streams():
    import nvdec_streams

    return nvdec_streams


@pytest.fixture
def nvdec(cuda_device):
    """The streams module, where this card's NVDEC creates decoders. A
    container that withholds NVIDIA's ``video`` capability
    (``NvdecUnavailable``, that refusal alone) skips the test: NVDEC cannot
    decode there. Any other failure of the query fails it."""
    from tecogan_tpu_torch.data import video_nvdec

    try:
        video_nvdec.decoder_caps("h264", cuda_device)
    except video_nvdec.NvdecUnavailable as exc:
        pytest.skip(f"NVDEC creates no decoder on this card: {exc}")
    return _nvdec_streams()


@pytest.fixture
def model_decoder(cuda_device, monkeypatch):
    """The streams module, with ``ModelNvdec`` (the streams' numpy model,
    which decodes nothing) in place of the NVDEC binding: the port's
    demuxer, reader and NV12 kernel on the card, whatever NVDEC does."""
    from tecogan_tpu_torch.data import video_nvdec

    tn = _nvdec_streams()
    model = tn.ModelNvdec([tn.H264Stream(n) for n in tn.STREAMS])
    monkeypatch.setattr(video_nvdec, "load_library", lambda: model)
    return tn


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4))
def test_nv12_kernel_matches_plain(cuda_device, case):
    """The NV12 kernel against its plain version, bit for bit: pitch above
    the width, odd crop offsets, limited and full range, BT.601 and
    BT.709; one launch each."""
    from tecogan_tpu_torch.kernels import nv12_to_rgb, nv12_to_rgb_plain, yuv_coefficients

    (h, w), (ch, pitch), (left, top), matrix, full = (
        ((41, 57), (48, 80), (3, 5), 2, False), ((45, 67), (52, 96), (1, 7), 1, True),
        ((144, 180), (144, 256), (0, 0), 2, False),
        ((720, 1280), (720, 1536), (0, 0), 1, True))[case]
    surface = torch.randint(0, 256, (ch + ch // 2, pitch), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(case))
    coeffs = yuv_coefficients(matrix, full)
    before = nv12_to_rgb.launches
    got = nv12_to_rgb(surface.to(cuda_device), ch, left, top, w, h, coeffs)
    assert nv12_to_rgb.launches == before + 1
    assert torch.equal(got.cpu(), nv12_to_rgb_plain(surface, ch, left, top, w, h, coeffs))


def _streams_bit_equal(tn, tmp_path, container):
    from tecogan_tpu_torch.data.video_io import read_video_frames
    from tecogan_tpu_torch.kernels import nv12_to_rgb

    for name in tn.STREAMS:
        st = tn.H264Stream(name)
        before = nv12_to_rgb.launches
        frames, fps = read_video_frames(st.write(tmp_path / f"{name}.{container}"))
        assert fps == tn.FPS and nv12_to_rgb.launches == before + st.count
        np.testing.assert_array_equal(frames, st.expected_rgb())


def _seek_b_frames(tn, tmp_path, container):
    from tecogan_tpu_torch.data.video_io import VideoReader

    st = tn.H264Stream("b_main")
    want = st.expected_rgb()
    path = st.write(tmp_path / f"b.{container}")
    for start in (5, 7, 9, 13, 40):
        with VideoReader(path, block=4) as reader:
            reader.seek(start)
            rest = list(reader)
        assert len(rest) == max(0, len(want) - start)
        if rest:
            np.testing.assert_array_equal(np.stack(rest), want[start:])


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["mp4", "mkv"])
def test_nvdec_streams_bit_equal(nvdec, tmp_path, container):
    """Every hand-written H.264 stream decodes on the card's NVDEC to the
    frames OpenCV gives (the model's, which the CPU tests hold to OpenCV),
    one NV12 launch a frame."""
    _streams_bit_equal(nvdec, tmp_path, container)


@pytest.mark.cuda
def test_nvdec_vp9_fixture(nvdec):
    """The VP9 fixture decodes on NVDEC to the frames OpenCV gives (their
    SHA-256 recorded beside it)."""
    from tecogan_tpu_torch.data.video_io import read_video_frames

    want = nvdec.vp9_expected()
    frames, fps = read_video_frames(str(nvdec.VP9_FIXTURE))
    assert (fps, list(frames.shape)) == (want["fps"], want["shape"])
    assert nvdec.frame_sha256(frames) == want["frames"]


@pytest.mark.cuda
def test_nvdec_two_readers_on_two_threads(nvdec, tmp_path):
    """Two NVDEC readers, one per thread (as two serving sources),
    interleaved."""
    import threading

    from tecogan_tpu_torch.data.video_io import VideoReader

    streams = [nvdec.H264Stream("b_main"), nvdec.H264Stream("crop")]
    paths = [st.write(tmp_path / f"{i}.mp4") for i, st in enumerate(streams)]
    results, errors = [None, None], []

    def read(i):
        try:
            with VideoReader(paths[i], block=2) as reader:
                results[i] = np.stack(list(reader))
        except BaseException as exc:  # raised below in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for got, st in zip(results, streams):
        np.testing.assert_array_equal(got, st.expected_rgb())


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["mp4", "mkv"])
def test_nvdec_seek_b_frames(nvdec, tmp_path, container):
    """``seek`` on NVDEC's decode of the B-frame stream lands on the exact
    frame in display order, inside a GOP, on the second key frame and past
    the end."""
    _seek_b_frames(nvdec, tmp_path, container)


@pytest.mark.cuda
def test_nvdec_parser_reports_each_stream_format(cuda_device, tmp_path):
    """Every H.264 stream in MP4 and MKV and the VP9 fixture through the
    port's NVDEC reader: NVDEC's parser reports the expected coded size,
    display area, range and matrix; then the reader decodes every frame,
    or, where the card's container withholds NVIDIA's ``video``
    capability, raises ``NvdecUnavailable`` (chip_smoke.py phase 15 (a))."""
    from chip_smoke import check_nvdec_format
    from tecogan_tpu_torch.data import video_nvdec

    tn = _nvdec_streams()
    try:
        video_nvdec.decoder_caps("h264", cuda_device)
        refused = False
    except video_nvdec.NvdecUnavailable:
        refused = True
    h264 = {name: tn.H264Stream(name) for name in tn.STREAMS}
    paths = {(n, c): st.write(tmp_path / f"{n}.{c}") for n, st in h264.items()
             for c in ("mp4", "mkv")}
    assert len(check_nvdec_format(cuda_device, tn, h264, paths, refused)) == 11


@pytest.mark.cuda
@pytest.mark.parametrize("container", ["mp4", "mkv"])
def test_reader_and_nv12_kernel_over_the_model_decoder(model_decoder, tmp_path, container):
    """The port's demuxer, reader and NV12 kernel on the card over the
    streams' model in NVDEC's place (no decode): every stream's frames, one
    NV12 launch a frame, and ``seek`` on the B-frame stream."""
    _streams_bit_equal(model_decoder, tmp_path, container)
    _seek_b_frames(model_decoder, tmp_path, container)


@pytest.mark.cuda
def test_orbax_fixture_reads_without_jax(cuda_device):
    """The committed JAX-written orbax fixture (OCDBT store, zstd) read by
    the port alone, on the card's machine: every leaf equal to its recorded
    SHA-256 (chip_smoke.py phase 16 (a))."""
    import hashlib
    import json

    from chip_smoke import ORBAX_FIXTURE, ORBAX_SHA256, _flat_leaves
    from tecogan_tpu_torch.train.orbax_io import read_jax_checkpoint

    want = json.loads(ORBAX_SHA256.read_text())
    leaves = _flat_leaves(read_jax_checkpoint(str(ORBAX_FIXTURE / str(want["step"]))))
    got = {"/".join(p): hashlib.sha256(a.tobytes()).hexdigest() for p, a in leaves}
    assert got == {k: v["sha256"] for k, v in want["leaves"].items()}


@pytest.mark.cuda
def test_load_models_from_a_jax_layout_checkpoint_streams_like_cpu(cuda_device, tmp_path):
    """``save_jax_checkpoint`` of a 2-block FRVSR state, then ``load_models``:
    the card's streaming output equals the CPU path's at phase 5's
    tolerance, and the kernels ran."""
    from chip_smoke import PATH_TOL, rel_err
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.train.checkpoint import load_models, save_jax_checkpoint

    cfg = FRVSR_PRESET.replace(num_resblock=2, compute_dtype="float32", infer_chunk=4)
    state = Trainer(cfg, "cpu").init_state(3)
    state.step = 5
    save_jax_checkpoint(str(tmp_path / "ckpt"), state)
    frames = np.random.RandomState(4).rand(6, 32, 48, 3).astype(np.float32)
    outs = []
    before = (upsample4.launches, resblock_chain.launches)
    for device in (cuda_device, torch.device("cpu")):
        step, gen, fnet = load_models(str(tmp_path / "ckpt"), cfg)
        assert step == 5 and len(gen.resblocks) == 2
        out, _ = StreamingSR(TecoConfig(num_resblock=2, compute_dtype="float32",
                                        infer_chunk=4), gen, fnet, output="float32",
                             device=device).run(frames)
        outs.append(torch.from_numpy(out))
    assert upsample4.launches > before[0] and resblock_chain.launches > before[1]
    assert outs[0].shape == (6, 128, 192, 3)
    assert rel_err(*outs)[1] <= PATH_TOL


# ---------------------------------------------- parallel paths on one card
# chip_smoke.py phase 17 at a small size: the mesh names the card twice.
def _par_models(seed, cfg):
    from chip_smoke import build_models

    return build_models(seed, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_spatial_streaming_on_one_card_matches_unsharded(cuda_device, dtype):
    """``StreamingSR`` on a 2-shard mesh ``[cuda, cuda]``, 2 blocks, LR 64x48
    (shards of 32 rows: the halo warp), against the unsharded run: float32
    at phase 5's tolerance; in bfloat16 the first frame and each frame's
    sharded step from the unsharded state within one uint8 level (chip_smoke
    phase 17 (a)); the chain and K1 launch on every shard."""
    from chip_smoke import PATH_TOL, deterministic, rel_err, spatial_teacher_forced
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=2, compute_dtype=dtype, infer_chunk=3)
    output = "float32" if dtype == "float32" else "uint8"
    frames = (np.random.RandomState(1).rand(7, 64, 48, 3) * 255).astype(np.uint8)
    mesh = make_mesh({"space": 2}, [cuda_device, cuda_device])
    outs = []
    with deterministic():
        for m in (None, mesh):
            before = (upsample4.launches, resblock_chain.launches)
            sr = StreamingSR(cfg, *_par_models(2, cfg), output=output, device=cuda_device,
                             capture=False, spatial_mesh=m)
            outs.append(sr.run(frames)[0])
            shards = 1 if m is None else 2
            # 3 chunks of 3: the last padded to 9 frames; K1: a flow a chunk
            # and a skip a frame, per shard.
            assert (upsample4.launches - before[0], resblock_chain.launches - before[1]) == (
                shards * (9 + 3), shards * 2 * 9)
        forced = spatial_teacher_forced(torch.device("cuda", 0), cfg, _par_models(2, cfg),
                                        frames, mesh.axis_devices("space"))
    assert sr.step.halo_warps == 9 and sr.step.gather_warps == 0
    assert forced <= 1
    if output == "uint8":
        assert np.abs(outs[1][0].astype(np.int16) - outs[0][0]).max() <= 1
    else:
        assert rel_err(torch.from_numpy(outs[1]), torch.from_numpy(outs[0]))[1] <= PATH_TOL


@pytest.mark.cuda
def test_halo_warp_on_one_card_is_bit_equal(cuda_device):
    from tecogan_tpu_torch.ops.warp import warp_space_to_depth, warp_space_to_depth_halo
    from tecogan_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(2)
    image = torch.from_numpy(rng.rand(2, 256, 64, 3).astype(np.float32)).to(cuda_device)
    flow = torch.from_numpy((rng.rand(2, 256, 64, 2) * 2 - 1).astype(np.float32) * 24).to(
        cuda_device)
    mesh = make_mesh({"space": 4}, [cuda_device] * 4)
    got = warp_space_to_depth_halo(image, flow, mesh, "space", 4, max_displacement=24.0)
    assert torch.equal(got, warp_space_to_depth(image, flow, 4))


@pytest.mark.cuda
def test_pipeline_on_one_card_equals_streaming(cuda_device):
    """Both stages on the card (two streams): bit-equal to
    ``StreamingSR(capture=False)`` under cuDNN's deterministic algorithms."""
    from chip_smoke import deterministic
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import PipelinedStreamingSR
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16", infer_chunk=3)
    frames = (np.random.RandomState(3).rand(7, 32, 48, 3) * 255).astype(np.uint8)
    with deterministic():
        want, _ = StreamingSR(cfg, *_par_models(3, cfg), output="uint8", device=cuda_device,
                              capture=False).run(frames)
        got, _ = PipelinedStreamingSR(cfg, *_par_models(3, cfg), output="uint8",
                                      flow_device=cuda_device,
                                      recurrent_device=cuda_device).run(frames)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_spatial_streaming_captured_matches_eager_sharded(cuda_device, dtype):
    """A 2-shard ``StreamingSR`` on ``[cuda:0, cuda:0]`` captured (the
    default) against ``capture=False`` under cuDNN's deterministic
    algorithms, 2 blocks, LR 64x48, chunks of 3 with a short last one:
    bit-equal over two runs, the same launches a run, one capture for the
    chunk shape (none eager), and the route printed for each."""
    from chip_smoke import deterministic
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    cfg = TecoConfig(num_resblock=2, compute_dtype=dtype, infer_chunk=3)
    output = "float32" if dtype == "float32" else "uint8"
    frames = (np.random.RandomState(4).rand(7, 64, 48, 3) * 255).astype(np.uint8)
    card = torch.device("cuda", 0)
    mesh = make_mesh({"space": 2}, [card, card])
    outs, counts = [], []
    with deterministic():
        for capture in (None, False):
            sr = StreamingSR(cfg, *_par_models(4, cfg), output=output, device=cuda_device,
                             capture=capture, spatial_mesh=mesh)
            assert sr.capture is (capture is None)
            assert sr.route.startswith("captured" if capture is None else "eager")
            captures = CapturedProgram.captures
            first, _ = sr.run(frames)
            before = (upsample4.launches, resblock_chain.launches)
            again, _ = sr.run(frames)
            counts.append((upsample4.launches - before[0], resblock_chain.launches - before[1]))
            np.testing.assert_array_equal(first, again)
            outs.append(again)
            assert CapturedProgram.captures - captures == (capture is None)
    # 3 chunks of 3 a run, per shard: K1 a flow a chunk and a skip a frame.
    assert counts[0] == counts[1] == (2 * (3 + 9), 2 * 2 * 9)
    assert outs[0].shape == (7, 256, 192, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,chunk", [("bfloat16", 3), ("float32", 2)],
                         ids=["bf16-uint8", "f32-f32"])
def test_pipeline_captured_equals_captured_streaming(cuda_device, dtype, chunk):
    """Both stages on the card, each a captured graph (two captures for the
    chunk shape, none on a second run), and both eager: bit-equal to a
    captured ``StreamingSR`` under cuDNN's deterministic algorithms, with
    its launches, over 7 frames in 3 or 4 chunks. bfloat16 reads uint8
    frames; float32 reads float32 frames, so stage F's frames are its own
    input buffer, which the next chunk's upload overwrites."""
    from chip_smoke import deterministic
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import PipelinedStreamingSR
    from tecogan_tpu_torch.recurrent import StreamingSR
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    cfg = TecoConfig(num_resblock=2, compute_dtype=dtype, infer_chunk=chunk)
    frames = np.random.RandomState(5).rand(7, 32, 48, 3)
    if dtype == "bfloat16":
        frames, output = (frames * 255).astype(np.uint8), "uint8"
    else:
        frames, output = frames.astype(np.float32), "float32"
    outs, counts = [], []
    with deterministic():
        for make in (
                lambda: StreamingSR(cfg, *_par_models(5, cfg), output=output,
                                    device=cuda_device),
                lambda: PipelinedStreamingSR(cfg, *_par_models(5, cfg), output=output,
                                             flow_device=cuda_device,
                                             recurrent_device=cuda_device),
                lambda: PipelinedStreamingSR(cfg, *_par_models(5, cfg), output=output,
                                             flow_device=cuda_device,
                                             recurrent_device=cuda_device, capture=False)):
            sr = make()
            captures = CapturedProgram.captures
            sr.run(frames)
            made = CapturedProgram.captures - captures
            before = (upsample4.launches, resblock_chain.launches)
            out, _ = sr.run(frames)
            counts.append((upsample4.launches - before[0], resblock_chain.launches - before[1]))
            assert CapturedProgram.captures - captures == made
            outs.append((out, made, sr.capture_s))
    assert outs[0][0].shape == (7, 128, 192, 3)
    for out, _, _ in outs[1:]:
        np.testing.assert_array_equal(out, outs[0][0])
    assert [m for _, m, _ in outs] == [1, 2, 0] and all(s > 0 for _, _, s in outs[:2])
    # The last chunk is padded to the chunk length: K1 a flow a chunk and a
    # skip a frame run, 2 chain calls a frame run.
    ran = -(-7 // chunk) * chunk
    assert counts == [(ran // chunk + ran, 2 * ran)] * 3


@pytest.mark.cuda
def test_data_parallel_world_size_one_matches_trainer(cuda_device):
    """A captured ``DataParallelTrainer`` step at world size 1 over NCCL:
    every state tensor bit-equal to the plain ``Trainer``'s."""
    import socket

    import torch.distributed as dist

    from chip_smoke import deterministic, frvsr_batch
    from tecogan_tpu_torch.parallel import DataParallelTrainer, init_distributed
    from tecogan_tpu_torch.train.trainer import named_state_tensors

    cfg = FRVSR_PRESET.replace(num_resblock=2, batch_size=2, rnn_n=3)
    batch = frvsr_batch(cfg, 2, 5)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        finals = []
        with deterministic():
            for cls in (Trainer, DataParallelTrainer):
                trainer = cls(cfg, cuda_device)
                state = trainer.init_state(1)
                for _ in range(2):
                    trainer.train_step(state, batch)
                assert trainer.capture
                finals.append([t.detach().clone() for _, t in named_state_tensors(state)])
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(*finals))


@pytest.mark.cuda
def test_slot_pool_mesh_on_one_card(cuda_device):
    """A 4-slot ``VSRServer`` over a 2-device mesh ``[cuda, cuda]``,
    captured: every tick bit-equal to two unsharded 2-slot pools on the
    same streams, and the first within one level of the 4-slot pool."""
    from chip_smoke import deterministic
    from tecogan_tpu_torch.config import TecoConfig
    from tecogan_tpu_torch.parallel import make_mesh
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=2, compute_dtype="bfloat16")
    frames = (np.random.RandomState(4).rand(3, 4, 32, 48, 3) * 255).astype(np.uint8)
    outs = []
    with deterministic():
        for m, groups in ((make_mesh({cfg.dp_axis: 2}, [cuda_device, cuda_device]),
                           [[0, 1, 2, 3]]), (None, [[0, 1], [2, 3]]), (None, [[0, 1, 2, 3]])):
            servers = []
            for group in groups:
                srv = VSRServer(cfg, *_par_models(4, cfg), 32, 48, max_streams=len(group),
                                mesh=m, device=cuda_device)
                for k in group:
                    srv.open(k)
                servers.append((srv, group))
            ticks = []
            for f in frames:
                tick = {}
                for srv, group in servers:
                    tick.update(srv.step({k: f[k] for k in group}))
                ticks.append(tick)
            outs.append(ticks)
    for a, b in zip(outs[0], outs[1]):
        for k in range(4):
            np.testing.assert_array_equal(a[k], b[k])
    for k in range(4):
        assert np.abs(outs[0][0][k].astype(np.int16) - outs[2][0][k]).max() <= 1


@pytest.mark.cuda
def test_captured_program_spans(cuda_device):
    """A ``CapturedProgram`` under the profiler: one ``graph.capture`` (its
    warm-up and capture, with the program's name and ``warmup_s``) and a
    ``graph.replay`` a replay, each a ``tecogan.*`` range of the trace;
    the captured body opens none and the replays give its output."""
    from tecogan_tpu_torch.utils import profiling
    from tecogan_tpu_torch.utils.cuda_graphs import CapturedProgram

    x = torch.arange(64, dtype=torch.float32, device=cuda_device)
    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prog = CapturedProgram(lambda: x * 2 + 1, (x,), name="spans")
        for _ in range(3):
            out = prog()
        torch.cuda.synchronize()
    records = profiling.spans()
    names = sorted(r.name for r in records)
    assert names == ["graph.capture"] + ["graph.replay"] * 3
    (capture,) = [r for r in records if r.name == "graph.capture"]
    assert capture.attrs["program"] == "spans" and capture.attrs["warmup_s"] > 0
    assert all(r.attrs == {"program": "spans"} for r in records if r.name == "graph.replay")
    ranges = sorted(e.name for e in prof.events()
                    if e.name.startswith(profiling.SPAN_PREFIX) and e.device_type.name == "CPU")
    assert ranges == [profiling.SPAN_PREFIX + n for n in names]
    torch.testing.assert_close(out, x * 2 + 1)
    prog.close()
