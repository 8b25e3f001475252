"""The recurrent step's input in one pass (``kernels/warp_pack.py``,
``csrc/warp_pack.cu``) and its routing (``recurrent/step.py:generator_step``)
on the CPU, where the operator runs its plain version,
``cat([lr, warp_space_to_depth(image, flow, 4)], -1)``.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it to
the plain route bit for bit). Here its tile walk, its shared-memory staging
at each LR row's offset modulo 16 and its head / 16-byte body / tail stores
are emulated in numpy, with the tile constants read from the ``.cu`` file's
``constexpr`` lines, and its arithmetic (float32 coordinates, ATen's clamps,
every lerp op rounded to the storage type) is held to the plain route bit
for bit in float32 and bfloat16.

The launches of the kernel are counted only for CUDA tensors; here the
``plain_calls`` fixture counts the operator's CPU bodies instead, so the
routing is tested where it is decided.
"""

import contextlib
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.models.fnet import FNet
from tecogan_tpu_torch.models.generator import Generator
from tecogan_tpu_torch.models.layers import glorot_init_
from tecogan_tpu_torch.kernels import warp_pack, warp_pack_plain
from tecogan_tpu_torch.ops.warp import warp_space_to_depth
from tecogan_tpu_torch.recurrent.step import (
    RecurrentState,
    flows_for_sequence,
    frame_step,
    generator_step,
    init_state,
    unroll_generator,
    upscale_flow,
)

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "tecogan_tpu_torch" / "csrc" / "warp_pack.cu"
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
# Flows of random fractions, and of whole pixels (every fraction 0).
KINDS = ["fraction", "whole"]
# HR frames: one tile, a ragged one (LR 45 x 47: a partial tile at the end
# of each LR row, LR rows whose spans start at every offset modulo 16 an
# element allows) and one whose LR rows are all 16-byte aligned (LR 12 x
# 64: no head or tail).
SHAPES = [(1, 8, 8), (2, 180, 188), (1, 48, 256)]
SHAPE_IDS = ["8x8", "ragged", "aligned"]
MODES = ["no_grad", "inference_mode", "frozen"]


def _inputs(shape, dtype, seed, reach=96.0, kind="fraction"):
    """lr, image and a flow of random (dy, dx) up to ``reach`` HR pixels,
    which crosses every border of the frame, in ``dtype``; with ``kind``
    ``whole``, rounded to whole pixels."""
    b, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    lr = torch.rand((b, h // 4, w // 4, 3), generator=gen)
    image = torch.rand((b, h, w, 3), generator=gen)
    flow = (torch.rand((b, h, w, 2), generator=gen) * 2 - 1) * reach
    if kind == "whole":
        flow = flow.round()
    return lr.to(dtype), image.to(dtype), flow.to(dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("reach", [96.0, 2.5], ids=["reach96", "reach2"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_version_is_the_concat_of_the_warp(shape, reach, dtype, kind):
    """The operator's CPU body and its plain version are the concat of the LR
    frame and the packed warp, bit for bit."""
    lr, image, flow = _inputs(shape, dtype, 1, reach, kind)
    want = torch.cat([lr, warp_space_to_depth(image, flow, 4)], dim=-1)
    got = warp_pack(lr, image, flow)
    assert got.shape == (shape[0], shape[1] // 4, shape[2] // 4, 51) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(warp_pack_plain(lr, image, flow), want)


# --------------------------------------------------------------------------
# The kernel, emulated.


def _source_constants() -> dict:
    """The ``constexpr int`` lines at namespace scope of the kernel source,
    evaluated in order (C++ integer division)."""
    values = {}
    for line in SOURCE.read_text().splitlines():
        m = re.match(r"constexpr int (\w+) = (.*);", line.split("//")[0].rstrip())
        if m:
            values[m.group(1)] = int(eval(m.group(2).replace("/", "//"), {}, dict(values)))
    return values


K = _source_constants()


def _round(x: np.ndarray, dtype) -> np.ndarray:
    """float32 values rounded to ``dtype`` (bfloat16: to nearest even), as
    float32."""
    x = np.asarray(x, np.float32)
    if dtype == torch.float32:
        return x
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _clamp(v, lo, hi):
    """ATen's clamp: max(v, lo), then min(., hi)."""
    v = np.where(v < lo, np.float32(lo), v)
    return np.where(hi < v, np.float32(hi), v).astype(np.float32)


def _lerp(a, b, t, dtype):
    d = _round(b - a, dtype)
    return _round(a + _round(d * t, dtype), dtype)


def _to_bytes(values: np.ndarray, dtype) -> np.ndarray:
    """float32 values already in ``dtype`` as that dtype's little-endian bytes."""
    if dtype == torch.float32:
        return values.astype(np.float32).view(np.uint8)
    return (values.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)


def _ld_pair(u16: np.ndarray, p: np.ndarray):
    """The kernel's ``ld_pair`` on a bfloat16 image's bits: pixels p and
    p + 1 from three aligned 4-byte words (and 2 bytes at an odd p), as
    (3, n) channel bits of each. Asserts that nothing past the image is
    read."""
    odd = p & 1
    w = (3 * p - odd) >> 1
    assert (4 * w + 12 + 2 * odd).max() <= 2 * u16.size and w.min() >= 0
    words = u16.view(np.uint32)  # H and W are multiples of 4: an even count
    w0, w1, w2 = words[w], words[w + 1], words[w + 2]

    def perm(a, b):  # __byte_perm(a, b, 0x5432)
        return (a >> 16) | ((b & 0xFFFF) << 16)

    r2_odd = u16[np.where(odd == 1, 2 * (w + 3), 0)]
    l01, r01 = np.where(odd, perm(w0, w1), w0), np.where(odd, w2, perm(w1, w2))
    l2 = np.where(odd, w1 >> 16, w1 & 0xFFFF)
    r2 = np.where(odd, r2_odd, w2 >> 16)
    return ([l01 & 0xFFFF, l01 >> 16, l2], [r01 & 0xFFFF, r01 >> 16, r2])


def _gather(img: np.ndarray, dtype, p: np.ndarray, ww: int):
    """The four corners at pixel p (top left) of the flat RGB image, (n, 3)
    float32 each, read as the kernel reads them."""
    if dtype == torch.float32:
        return [img[(3 * (p + d))[:, None] + np.arange(3)] for d in (0, 1, ww, ww + 1)]
    u16 = (img.view(np.uint32) >> 16).astype(np.uint16)
    out = []
    for q in (p, p + ww):
        for side in _ld_pair(u16, q):
            bits = np.stack(side, axis=1).astype(np.uint32) << 16
            out.append(bits.view(np.float32))
    return out


def _emulate(lr, image, flow, dtype):
    """The kernel over the whole grid: each block's runs, its corner loads,
    its staging at each LR row's offset modulo 16 and its row stores.
    Returns the output's bytes and how often each was written."""
    lr, image, flow = (t.float().numpy() for t in (lr, image, flow))
    b_n, hh, ww, _ = image.shape
    h, w = hh // 4, ww // 4
    size = 4 if dtype == torch.float32 else 2
    rows_t = K["kRows"]
    cols_t, out_c, runs = K["kCols"], K["kOutC"], K["kRuns"]
    row_bytes = ((cols_t * out_c * size + 15) // 16 + 1) * 16
    out = np.zeros(b_n * h * w * out_c * size, np.uint8)
    writes = np.zeros(out.size, np.int64)
    img = image.reshape(-1)
    # The runs each warp takes: every run of a tile once.
    tile_runs = 4 * rows_t * runs
    taken = [r0 + u for warp_ in range(K["kWarps"])
             for r0 in range(warp_ * K["kUnroll"], tile_runs, K["kWarps"] * K["kUnroll"])
             for u in range(K["kUnroll"]) if r0 + u < tile_runs]
    assert sorted(taken) == list(range(tile_runs))
    run = np.repeat(np.array(taken), 32)
    lane = np.tile(np.arange(32), len(taken))
    ly, lx = run // runs, (run % runs) * 32 + lane
    for b in range(b_n):
        for i0 in range(0, h, rows_t):
            for j0 in range(0, w, cols_t):
                rows, cols = min(rows_t, h - i0), min(cols_t, w - j0)
                offset = [(((b * h + i0 + li) * w + j0) * out_c * size) % 16
                          for li in range(rows)]
                vals = np.zeros((rows, cols, out_c), np.float32)
                vals[:, :, :3] = lr[b, i0:i0 + rows, j0:j0 + cols]
                ok = (ly < 4 * rows) & (lx < 4 * cols)
                y, x = 4 * i0 + ly[ok], 4 * j0 + lx[ok]
                fy, fx = flow[b, y, x, 0], flow[b, y, x, 1]
                qy, qx = y.astype(np.float32) - fy, x.astype(np.float32) - fx
                y0 = _clamp(np.floor(qy), 0.0, hh - 2)
                x0 = _clamp(np.floor(qx), 0.0, ww - 2)
                ay = _round(_clamp(qy - y0, 0.0, 1.0), dtype)[:, None]
                ax = _round(_clamp(qx - x0, 0.0, 1.0), dtype)[:, None]
                p = (b * hh + y0.astype(np.int64)) * ww + x0.astype(np.int64)
                corner = _gather(img, dtype, p, ww)
                top = _lerp(corner[0], corner[1], ax, dtype)
                bot = _lerp(corner[2], corner[3], ax, dtype)
                v = _lerp(top, bot, ay, dtype)
                ch = 3 + (((ly[ok] % 4) * 4 + lx[ok] % 4) * 3)[:, None] + np.arange(3)
                vals[(ly[ok] // 4)[:, None], (lx[ok] // 4)[:, None], ch] = v
                stage = np.zeros(rows_t * row_bytes, np.uint8)
                for li in range(rows):
                    s0 = li * row_bytes + offset[li]
                    span = _to_bytes(vals[li].reshape(-1), dtype)
                    stage[s0:s0 + span.size] = span
                for li in range(rows):
                    g0 = ((b * h + i0 + li) * w + j0) * out_c * size
                    s0 = li * row_bytes + offset[li]
                    n = cols * out_c * size
                    head = min(16 - offset[li] if offset[li] else 0, n)
                    body = (n - head) & ~15
                    assert (g0 + head) % 16 == 0 and (s0 + head) % 16 == 0 or body == 0
                    pieces = ([(k, size) for k in range(0, head, size)]
                              + [(k, 16) for k in range(head, head + body, 16)]
                              + [(k, size) for k in range(head + body, n, size)])
                    for k, width in pieces:
                        out[g0 + k:g0 + k + width] = stage[s0 + k:s0 + k + width]
                        writes[g0 + k:g0 + k + width] += 1
    return out, writes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_kernel_emulation_matches_plain(shape, dtype, kind):
    """The kernel's walk, staging and stores write every output byte once,
    and its arithmetic gives the plain route's bits."""
    lr, image, flow = _inputs(shape, dtype, 2, kind=kind)
    out, writes = _emulate(lr, image, flow, dtype)
    assert (writes == 1).all()
    want = warp_pack_plain(lr, image, flow)
    assert np.array_equal(out, want.view(torch.uint8).numpy().reshape(-1))


def test_kernel_constants():
    """The tile the emulation reads: 51 output channels, 32 LR columns (128
    HR columns in 4 warp-wide runs), every warp busy."""
    assert (K["kOutC"], K["kCols"], K["kRuns"]) == (51, 32, 4)
    assert K["kThreads"] == 32 * K["kWarps"]
    assert 4 * K["kRows"] * K["kRuns"] % (K["kWarps"] * K["kUnroll"]) == 0


# --------------------------------------------------------------------------
# The route.


@pytest.fixture
def plain_calls(monkeypatch):
    """The image shape at every call of the operator's CPU body."""
    calls = []

    def counted(lr, image, flow):
        calls.append(tuple(image.shape))
        return warp_pack_plain(lr, image, flow)

    # The module, which the package's ``warp_pack`` function shadows.
    module = importlib.import_module("tecogan_tpu_torch.kernels.warp_pack")
    monkeypatch.setattr(module, "warp_pack_plain", counted)
    return calls


def _small_models(seed):
    gen = torch.Generator().manual_seed(seed)
    return (glorot_init_(Generator(num_resblock=2, channels=16), gen),
            glorot_init_(FNet((8, 8, 8), (8, 8, 8)), gen))


def _no_autograd(mode, *modules):
    """A context in which autograd records nothing: grad mode off, inference
    mode, or (``frozen``) grad mode on and no parameter needing a gradient."""
    if mode == "frozen":
        for m in modules:
            m.requires_grad_(False)
        return contextlib.nullcontext()
    return torch.no_grad() if mode == "no_grad" else torch.inference_mode()


def _aten_step(generator, state, lr, flow):
    """The route ``generator_step`` keeps under autograd: the ATen warp,
    pack and concat, then the generator."""
    x = torch.cat([lr, warp_space_to_depth(state.prev_hr, flow, 4)], dim=-1)
    hr = (generator(x) + 1) / 2
    return RecurrentState(prev_lr=lr, prev_hr=hr), hr


@pytest.mark.parametrize("mode", MODES)
def test_frame_step_without_autograd_calls_warp_pack_once_a_frame(plain_calls, mode):
    """``frame_step`` without autograd: one ``warp_pack`` a frame, and the
    frames equal the ATen route's bit for bit (the same CPU ops)."""
    gen, fnet = _small_models(3)
    frames = torch.rand((4, 2, 8, 12, 3), generator=torch.Generator().manual_seed(4))
    state = want_state = init_state(2, 8, 12, device="cpu")
    with _no_autograd(mode, gen, fnet):
        for t, lr in enumerate(frames):
            state, hr = frame_step(gen, fnet, state, lr)
            with torch.no_grad():
                flow = upscale_flow(fnet(torch.cat([want_state.prev_lr, lr], -1)), 8, 12)
                want_state, want = _aten_step(gen, want_state, lr, flow)
            assert torch.equal(hr, want), t
    assert plain_calls == [(2, 32, 48, 3)] * 4


@pytest.mark.parametrize("needs_grad", ["prev_hr", "flow"])
def test_generator_step_under_autograd_keeps_the_aten_route(plain_calls, needs_grad):
    """An input that needs a gradient keeps the ATen route: no ``warp_pack``
    call, a graph back to that input, the same values."""
    gen, _ = _small_models(5)
    lr, image, flow = _inputs((1, 16, 24), torch.float32, 6, reach=4.0)
    (image if needs_grad == "prev_hr" else flow).requires_grad_(True)
    state = RecurrentState(torch.zeros_like(lr), image)
    _, hr = generator_step(gen, state, lr, flow)
    assert plain_calls == []
    grad = torch.autograd.grad(hr.sum(), image if needs_grad == "prev_hr" else flow)[0]
    assert grad.abs().sum() > 0
    with torch.no_grad():
        _, want = _aten_step(gen, state, lr, flow)
    assert torch.equal(hr.detach(), want)


def test_training_unroll_never_calls_warp_pack(plain_calls):
    """The training unroll (FNet's flows, the recurrent generator, remat and
    not) under autograd runs the ATen warp: no ``warp_pack`` call, and a
    gradient reaches FNet through it."""
    gen, fnet = _small_models(7)
    seq = torch.rand((2, 4, 8, 8, 3), generator=torch.Generator().manual_seed(8))
    for remat in (True, False):
        _, flow_hr = flows_for_sequence(fnet, seq)
        outs, _ = unroll_generator(gen, seq, flow_hr, remat=remat)
        outs.square().mean().backward()
    assert plain_calls == []
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in fnet.parameters())


def test_streaming_calls_warp_pack_once_a_frame(plain_calls):
    """StreamingSR.run: one ``warp_pack`` for every frame the generator runs,
    the warm-up frames included (10 + 2 frames, chunks of 4)."""
    from tecogan_tpu_torch.recurrent import StreamingSR

    cfg = TecoConfig(num_resblock=2, gen_channels=16, infer_chunk=4)
    frames = np.random.RandomState(9).rand(10, 16, 24, 3).astype(np.float32)
    sr = StreamingSR(cfg, *_small_models(10), output="float32", device="cpu")
    out, _ = sr.run(frames, warmup=2)
    assert out.shape == (8, 64, 96, 3)
    assert plain_calls == [(1, 64, 96, 3)] * 12


def test_server_tick_calls_warp_pack_once(plain_calls):
    """A VSRServer tick warps every slot in one ``warp_pack`` call, whatever
    the number of streams."""
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
        assert plain_calls == [(3, 64, 96, 3)], tick


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fake_kernel_gives_the_packed_shape(dtype):
    """A fake-tensor trace of the operator gives (B, H/4, W/4, 51)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        lr, image, flow = (mode.from_tensor(t) for t in _inputs((3, 40, 24), dtype, 13))
        out = torch.ops.tecogan_torch.warp_pack(lr, image, flow)
    assert out.shape == (3, 10, 6, 51) and out.dtype == dtype


def _bad(case):
    """Inputs the kernel does not take, with the error they raise."""
    lr, image, flow = _inputs((2, 16, 24), torch.float32, 14)
    error, match = ValueError, None
    if case == "four_channels":
        image, match = torch.rand(2, 16, 24, 4), r"\(B, H, W, 3\)"
    elif case == "height":
        image, flow, match = image[:, :14], flow[:, :14], "multiples of 4"
    elif case == "flow_shape":
        flow, match = flow[:, :, :20], "does not match"
    elif case == "lr_shape":
        lr, match = lr[:, :, :5], "is not image"
    elif case == "image_layout":
        image, match = image.transpose(1, 2).contiguous().transpose(1, 2), "contiguous"
    elif case == "flow_layout":
        flow, match = flow.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0), "contiguous"
    elif case == "lr_dtype":
        lr, error, match = lr.to(torch.bfloat16), TypeError, "one dtype"
    elif case == "float16":
        lr, image, flow = (t.half() for t in (lr, image, flow))
        error, match = TypeError, "float32 or bfloat16"
    elif case == "image_offset":  # bfloat16 pixels one element past a 4-byte word
        lr, image, flow = (t.to(torch.bfloat16) for t in (lr, image, flow))
        image = _offset_by_one(image)
        match = "image aligned to 4 bytes"
    elif case == "flow_offset":  # float32 (dy, dx) one element past an 8-byte pair
        flow, match = _offset_by_one(flow), "flow aligned to 8 bytes"
    return (lr, image, flow), error, match


def _offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element into its
    storage."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert out.is_contiguous()
    return out.copy_(t)


BAD = ["four_channels", "height", "flow_shape", "lr_shape", "image_layout", "flow_layout",
       "lr_dtype", "float16", "image_offset", "flow_offset"]


@pytest.mark.parametrize("case", BAD)
def test_warp_pack_rejects_what_the_kernel_does_not_take(case):
    args, error, match = _bad(case)
    with pytest.raises(error, match=match):
        warp_pack(*args)


def test_ragged_shape_counts():
    """The ragged case's grid: a partial tile at the end of each LR row, LR
    rows at every offset modulo 16 an element allows (8 in bfloat16, 4 in
    float32)."""
    h, w = 45, 47
    assert w % K["kCols"]
    for size in (2, 4):
        assert len({(r * w * K["kOutC"] * size) % 16 for r in range(h)}) == 16 // size
    assert math.ceil(w / K["kCols"]) == 2
