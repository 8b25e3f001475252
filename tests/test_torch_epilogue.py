"""The transposed convs' epilogue (``kernels/epilogue.py``) and its routing
(``models/layers.py:Conv2Tran.forward_relu``) on the CPU, where the
operator runs its plain version: the conv with no bias, then
``relu(y[..., :-1, :-1] + b)``. A CPU conv may fold its bias into the sum,
so the two routes agree to float rounding here; on the card cuDNN adds a
transposed conv's bias in a pass of its own, and ``tests/test_torch_cuda.py``
holds the kernel and the generator to the two passes bit for bit.

The launches of the kernel are counted only for CUDA tensors; here the
``plain_calls`` fixture counts the operator's CPU bodies instead, so the
routing is tested where it is decided.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.kernels import bias_relu_crop, bias_relu_crop_plain, epilogue
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.layers import Conv2Tran, glorot_init_

torch.set_num_threads(1)

# float32: the conv sums in another order with its bias folded in or not.
RTOL, ATOL = 1e-6, 1e-7
MODES = ["no_grad", "inference_mode", "frozen"]


@pytest.fixture
def plain_calls(monkeypatch):
    """The shapes of y at every call of the operator's CPU body."""
    calls = []

    def counted(y, bias):
        calls.append(tuple(y.shape))
        return bias_relu_crop_plain(y, bias)

    monkeypatch.setattr(epilogue, "bias_relu_crop_plain", counted)
    return calls


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    glorot_init_(module, gen)
    with torch.no_grad():  # biases away from zero, so a dropped bias shows
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.bias.uniform_(-0.2, 0.2, generator=gen)
    return module


def _no_autograd(mode, *modules):
    """A context in which autograd records nothing: grad mode off, inference
    mode, or (``frozen``) grad mode on and no parameter needing a gradient."""
    if mode == "frozen":
        for m in modules:
            m.requires_grad_(False)
        return contextlib.nullcontext()
    return torch.no_grad() if mode == "no_grad" else torch.inference_mode()


def _parent_relu(self, x):
    """The two passes ``forward_relu`` replaces: the conv with its bias and
    the crop, then ``F.relu``."""
    return F.relu(self(x))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("shape", [(2, 64, 5, 7), (1, 16, 1, 1), (3, 24, 4, 9)],
                         ids=["64ch", "1x1", "24ch"])
def test_forward_relu_matches_conv_then_relu(plain_calls, shape, layout, mode):
    """Without autograd, one epilogue call a conv, equal to ``F.relu`` of
    the layer's SAME output to float rounding, (B, C, 2H, 2W)."""
    b, c, h, w = shape
    layer = _seeded(Conv2Tran(c, c), 1)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = F.relu(layer(x))
    with _no_autograd(mode, layer):
        got = layer.forward_relu(x)
    assert plain_calls == [(b, c, 2 * h + 1, 2 * w + 1)]
    assert got.shape == want.shape == (b, c, 2 * h, 2 * w)
    assert (want > 0).any() and (want == 0).any()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("needs_grad", ["parameters", "input"])
def test_forward_relu_under_grad_keeps_the_conv_path(plain_calls, needs_grad):
    """With anything for autograd to record, ``forward_relu`` is exactly
    ``F.relu(self(x))``: no epilogue call, the same values, a graph."""
    layer = _seeded(Conv2Tran(16, 16), 3)
    x = torch.randn((2, 16, 4, 6), generator=torch.Generator().manual_seed(4))
    if needs_grad == "input":
        layer.requires_grad_(False)
        x.requires_grad_(True)
    got = layer.forward_relu(x)
    assert plain_calls == []
    assert got.grad_fn is not None
    assert torch.equal(got, _parent_relu(layer, x))


def test_generator_gradients_reach_the_transposed_convs(plain_calls, monkeypatch):
    """A training forward and backward through the generator calls no
    epilogue, and every parameter's gradient, the transposed convs'
    weights and biases among them, equals the two-pass composition's."""
    gen = _seeded(Generator(num_resblock=2, channels=16), 5)
    x = torch.rand((2, 6, 8, 51), generator=torch.Generator().manual_seed(6))
    gen(x).square().mean().backward()
    got = {n: p.grad.clone() for n, p in gen.named_parameters()}
    assert plain_calls == []
    gen.zero_grad()
    monkeypatch.setattr(Conv2Tran, "forward_relu", _parent_relu)
    gen(x).square().mean().backward()
    for name, p in gen.named_parameters():
        assert torch.equal(got[name], p.grad), name
    for name in ("conv_tran1.weight", "conv_tran1.bias", "conv_tran2.weight",
                 "conv_tran2.bias"):
        assert got[name].abs().sum() > 0, name


@pytest.mark.parametrize("mode", MODES)
def test_generator_without_autograd_calls_the_epilogue_twice(plain_calls, monkeypatch,
                                                             mode):
    """Each generator call without autograd runs both transposed convs
    through the epilogue (at 2x and 4x), and its output equals the two-pass
    composition's to float rounding."""
    gen = _seeded(Generator(num_resblock=2, channels=16), 7)
    x = torch.rand((2, 6, 8, 51), generator=torch.Generator().manual_seed(8))
    with _no_autograd(mode, gen):
        got = gen(x)
    assert plain_calls == [(2, 16, 13, 17), (2, 16, 25, 33)]
    monkeypatch.setattr(Conv2Tran, "forward_relu", _parent_relu)
    with torch.no_grad():
        want = gen(x)
    assert got.shape == want.shape == (2, 24, 32, 3)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-6)


def _small_models(seed):
    return (_seeded(Generator(num_resblock=2, channels=16), seed),
            _seeded(FNet((8, 8, 8), (8, 8, 8)), seed + 1))


def test_streaming_calls_the_epilogue_twice_a_frame(plain_calls):
    """StreamingSR.run: two epilogue calls for every frame the generator
    runs, the warm-up frames included (10 + 2 frames, chunks of 4)."""
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=2, gen_channels=16, infer_chunk=4)
    frames = np.random.RandomState(9).rand(10, 16, 24, 3).astype(np.float32)
    sr = StreamingSR(cfg, *_small_models(10), output="float32", device="cpu")
    out, _ = sr.run(frames, warmup=2)
    assert out.shape == (8, 64, 96, 3)
    assert len(plain_calls) == 2 * 12


def test_server_tick_calls_the_epilogue_twice(plain_calls):
    """A VSRServer tick runs the generator once over its slots: two
    epilogue calls a tick, whatever the number of streams."""
    from tecogan_tpu_torch.serve import VSRServer

    cfg = TecoConfig(num_resblock=2, gen_channels=16)
    rng = np.random.RandomState(11)
    srv = VSRServer(cfg, *_small_models(12), 16, 24, max_streams=3, output="float32",
                    device="cpu")
    srv.open("a")
    srv.open("b")
    for tick in range(3):
        del plain_calls[:]
        out = srv.step({"a": rng.rand(16, 24, 3).astype(np.float32),
                        "b": rng.rand(16, 24, 3).astype(np.float32)})
        assert sorted(out) == ["a", "b"] and out["a"].shape == (64, 96, 3)
        assert [s[2:] for s in plain_calls] == [(33, 49), (65, 97)], tick


def test_fake_kernel_gives_the_cropped_shape():
    """A fake-tensor trace of the operator gives (B, C, H, W) in
    channels_last from a (B, C, H + 1, W + 1) conv output."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        y = mode.from_tensor(torch.empty(3, 64, 11, 17))
        out = torch.ops.tecogan_torch.bias_relu_crop(y, mode.from_tensor(torch.empty(64)))
    assert out.shape == (3, 64, 10, 16)
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("y,bias,match", [
    ((2, 8, 5, 7), (4,), "bias"),
    ((8, 5, 7), (8,), "bias"),
    ((2, 8, 0, 7), (8,), "no row or column"),
], ids=["bias_width", "three_dims", "empty"])
def test_bias_relu_crop_rejects_bad_shapes(y, bias, match):
    with pytest.raises(ValueError, match=match):
        bias_relu_crop(torch.zeros(y), torch.zeros(bias))
