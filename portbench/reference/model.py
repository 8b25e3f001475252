"""The plain reference of TecoGAN's recurrent 4x generator and FNet, in
float32 PyTorch, for the benchmark's correctness checks.

It follows the published model (thunil/TecoGAN ``lib/frvsr.py:4-88``,
``main.py:180-270``, ``lib/ops.py``) and imports nothing of the program
under test: each operation is written out here from its definition.

- FNet: three down blocks (conv3 + lrelu 0.2 twice, 2x2 max pool), three up
  blocks (conv3 + lrelu twice, 2x legacy-TF bilinear upsample), conv3 -> 32
  + lrelu, conv3 -> 2, ``tanh * 24``; the flow (dy, dx) in LR pixels on the
  //8 grid, symmetric-padded back to the frame.
- The HR flow: the LR flow times 4, upsampled 4x by legacy-TF bilinear
  (source ``dst / 4``, edge clamped).
- The warp: backward bilinear sampling at ``(y - dy, x - dx)``, the floor
  clamped into ``[0, size - 2]`` and the fraction into ``[0, 1]``
  (``tf.contrib.image.dense_image_warp``).
- Space-to-depth in ``tf.space_to_depth`` order.
- The generator: conv3 (51 -> 64) + ReLU, N residual blocks
  ``x += conv3(relu(conv3(x)))``, two 3x3 stride-2 transposed convs with
  TF's SAME cropping + ReLU, conv3 -> 3, plus the Catmull-Rom (0.75) 4x
  upsample of the LR frame, mapped from [-1, 1] to [0, 1].

Every convolution goes through :class:`Precision`, which the control uses
to round the convolutions' inputs and weights to a lower precision; the
reference itself computes in float32 with TF32 off (:func:`float32_math`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

FNET_DOWN = (32, 64, 128)
FNET_UP = (256, 128, 64)
MAX_VELOCITY = 24.0
GEN_CHANNELS = 64


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """Plain float32 convolutions and matrix products: TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """How a convolution sees its operands. The reference: as they are.
    ``Precision("fp8")``: each input and weight scaled per tensor to the
    float8 e4m3 range (largest magnitude to 448), rounded to float8 and
    scaled back; the products are then summed in float32, as fp8 tensor
    cores sum them."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"precision {kind!r}: float32 or fp8")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).float() / scale


FLOAT32 = Precision()


def conv3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          prec: Precision) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of NCHW ``x``; ``w`` (out, in, 3, 3)."""
    return F.conv2d(prec(x), prec(w), b, padding=1)


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        prec: Precision) -> torch.Tensor:
    """``tf.nn.conv2d_transpose`` 3x3 stride 2 SAME: the padding-0
    transposed conv's first 2H rows and 2W columns; ``w`` (in, out, 3, 3)."""
    return F.conv_transpose2d(prec(x), prec(w), b, stride=2)[..., :-1, :-1]


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


# ---------------------------------------------------------------- resizing
def _phase_weights(kind: str) -> Tuple[Tuple[int, ...], List[Tuple[float, ...]], int]:
    """(tap offsets, per-phase weights, factor) of a separable upsample."""
    if kind == "bilinear2":
        return (0, 1), [(1.0 - p / 2, p / 2) for p in range(2)], 2
    if kind == "bilinear4":
        return (0, 1), [(1.0 - p / 4, p / 4) for p in range(4)], 4
    r = 0.75  # Catmull-Rom as lib/ops.py:186-188 writes it
    mat = ((0.0, 1.0, 0.0, 0.0), (-r, 0.0, r, 0.0),
           (2 * r, r - 3, 3 - 2 * r, -r), (-r, 2 - r, r - 2, r))
    weights = []
    for t in (0.0, 0.25, 0.5, 0.75):
        powers = (1.0, t, t * t, t * t * t)
        weights.append(tuple(sum(powers[k] * mat[k][j] for k in range(4)) for j in range(4)))
    return (-1, 0, 1, 2), weights, 4


def _upsample_axis(x: torch.Tensor, axis: int, kind: str) -> torch.Tensor:
    offsets, weights, factor = _phase_weights(kind)
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    taps = [x.index_select(axis, (idx + o).clamp(0, n - 1)) for o in offsets]
    phases = [sum(wt * tap for wt, tap in zip(wp, taps)) for wp in weights]
    out = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = n * factor
    return out.reshape(shape)


def upsample(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Separable upsample of NHWC ``x``: "bilinear2" / "bilinear4" (legacy TF,
    no half-pixel offset, edge clamped) or "bicubic4" (Catmull-Rom, edge
    clamped)."""
    return _upsample_axis(_upsample_axis(x, 1, kind), 2, kind)


# -------------------------------------------------------------------- FNet
def fnet(w: Weights, pair: torch.Tensor, prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, h, w, 6) -> (B, h//8*8, w//8*8, 2) LR flow (dy, dx)."""
    net = pair.permute(0, 3, 1, 2).contiguous()
    for i in range(len(FNET_DOWN)):
        for j in (1, 2):
            net = lrelu(conv3(net, w[f"fnet.encoders.{i}.conv_{j}.weight"],
                              w[f"fnet.encoders.{i}.conv_{j}.bias"], prec))
        net = F.max_pool2d(net, 2)
    for i in range(len(FNET_UP)):
        for j in (1, 2):
            net = lrelu(conv3(net, w[f"fnet.decoders.{i}.conv_{j}.weight"],
                              w[f"fnet.decoders.{i}.conv_{j}.bias"], prec))
        net = upsample(net.permute(0, 2, 3, 1), "bilinear2").permute(0, 3, 1, 2).contiguous()
    net = lrelu(conv3(net, w["fnet.output_conv1.weight"], w["fnet.output_conv1.bias"], prec))
    net = conv3(net, w["fnet.output_conv2.weight"], w["fnet.output_conv2.bias"], prec)
    return (torch.tanh(net) * MAX_VELOCITY).permute(0, 2, 3, 1)


def pad_symmetric(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``tf.pad(.., SYMMETRIC)`` at the bottom and right, edge row included."""
    fh, fw = flow.shape[1], flow.shape[2]
    if h > fh:
        flow = torch.cat([flow, flow[:, 2 * fh - h:].flip(1)], dim=1)
    if w > fw:
        flow = torch.cat([flow, flow[:, :, 2 * fw - w:].flip(2)], dim=2)
    return flow


def hr_flow(w: Weights, prev_lr: torch.Tensor, lr: torch.Tensor,
            prec: Precision = FLOAT32) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNet on (previous, current) and the x4 HR flow: (LR flow, HR flow)."""
    h, wd = lr.shape[1], lr.shape[2]
    flow = fnet(w, torch.cat([prev_lr, lr], dim=-1), prec)
    return flow, upsample(4.0 * pad_symmetric(flow, h, wd), "bilinear4")


# -------------------------------------------------------------- warp, s2d
def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward bilinear warp of (B, H, W, C) by (B, H, W, 2) (dy, dx)."""
    b, h, w, c = image.shape
    gy = torch.arange(h, dtype=torch.float32, device=image.device)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=image.device)[None, None, :]
    qy = gy - flow[..., 0].float()
    qx = gx - flow[..., 1].float()
    fy = torch.floor(qy).clamp(0.0, h - 2)
    fx = torch.floor(qx).clamp(0.0, w - 2)
    ay = (qy - fy).clamp(0.0, 1.0)[..., None]
    ax = (qx - fx).clamp(0.0, 1.0)[..., None]
    iy, ix = fy.long(), fx.long()
    bi = torch.arange(b, device=image.device)[:, None, None]
    tl, tr = image[bi, iy, ix], image[bi, iy, ix + 1]
    bl, br = image[bi, iy + 1, ix], image[bi, iy + 1, ix + 1]
    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    return top + (bot - top) * ay


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 4, w // 4, 16 * c)


# -------------------------------------------------------------- generator
def num_blocks(w: Weights) -> int:
    return sum(1 for k in w if k.startswith("generator.resblocks.") and k.endswith("conv_1.weight"))


def generator(w: Weights, x: torch.Tensor, lr: torch.Tensor,
              prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, h, w, 51) inputs and the (B, h, w, 3) LR frame -> (B, 4h, 4w, 3)
    in [-1, 1]."""
    net = F.relu(conv3(x.permute(0, 3, 1, 2).contiguous(), w["generator.input_stage_conv.weight"],
                       w["generator.input_stage_conv.bias"], prec))
    for i in range(num_blocks(w)):
        p = f"generator.resblocks.{i}"
        y = F.relu(conv3(net, w[f"{p}.conv_1.weight"], w[f"{p}.conv_1.bias"], prec))
        net = net + conv3(y, w[f"{p}.conv_2.weight"], w[f"{p}.conv_2.bias"], prec)
    for name in ("conv_tran1", "conv_tran2"):
        net = F.relu(conv_transpose_same(net, w[f"generator.{name}.weight"],
                                         w[f"generator.{name}.bias"], prec))
    net = conv3(net, w["generator.output_stage_conv.weight"],
                w["generator.output_stage_conv.bias"], prec).permute(0, 2, 3, 1)
    return (net + upsample(lr, "bicubic4")) * 2 - 1


def frame_step(w: Weights, prev_lr: torch.Tensor, prev_hr: torch.Tensor, lr: torch.Tensor,
               prec: Precision = FLOAT32) -> torch.Tensor:
    """One streaming step (main.py:194-216): the HR frame in [0, 1]; the
    previous HR output is kept in [0, 1]."""
    _, flow = hr_flow(w, prev_lr, lr, prec)
    packed = space_to_depth4(warp(prev_hr, flow))
    return (generator(w, torch.cat([lr, packed], dim=-1), lr, prec) + 1) / 2


def quantize(hr: torch.Tensor) -> torch.Tensor:
    """``np.clip(img * 255, 0, 255).astype(np.uint8)`` (lib/ops.py:520-523)."""
    return (hr * 255.0).clamp(0.0, 255.0).to(torch.uint8)


@torch.no_grad()
def stream(w: Weights, frames: torch.Tensor, keep: List[int],
           prec: Precision = FLOAT32) -> Dict[int, torch.Tensor]:
    """Run (T, h, w, 3) uint8 LR frames through the recurrence from the zero
    state, one frame at a time (batch 1), and return the uint8 HR frames of
    the processed indices in ``keep``, on the host."""
    device = next(iter(w.values())).device
    last = max(keep)
    _, h, wd, _ = frames.shape
    prev_lr = torch.zeros((1, h, wd, 3), device=device)
    prev_hr = torch.zeros((1, 4 * h, 4 * wd, 3), device=device)
    out = {}
    for t in range(last + 1):
        lr = frames[t:t + 1].to(device).float() / 255.0
        hr = frame_step(w, prev_lr, prev_hr, lr, prec)
        if t in keep:
            out[t] = quantize(hr[0]).cpu()
        prev_lr, prev_hr = lr, hr
    return out


def conv_param_names(num_resblock: int) -> List[Tuple[str, Tuple[int, int, str]]]:
    """Every convolution of the generator and FNet: (name, (in, out,
    "conv" | "tran")), in the order the weights are drawn."""
    out = [("generator.input_stage_conv", (51, GEN_CHANNELS, "conv"))]
    for i in range(num_resblock):
        for j in (1, 2):
            out.append((f"generator.resblocks.{i}.conv_{j}", (GEN_CHANNELS, GEN_CHANNELS, "conv")))
    out += [("generator.conv_tran1", (GEN_CHANNELS, GEN_CHANNELS, "tran")),
            ("generator.conv_tran2", (GEN_CHANNELS, GEN_CHANNELS, "tran")),
            ("generator.output_stage_conv", (GEN_CHANNELS, 3, "conv"))]
    cin = 6
    for i, c in enumerate(FNET_DOWN):
        out += [(f"fnet.encoders.{i}.conv_1", (cin, c, "conv")),
                (f"fnet.encoders.{i}.conv_2", (c, c, "conv"))]
        cin = c
    for i, c in enumerate(FNET_UP):
        out += [(f"fnet.decoders.{i}.conv_1", (cin, c, "conv")),
                (f"fnet.decoders.{i}.conv_2", (c, c, "conv"))]
        cin = c
    out += [("fnet.output_conv1", (cin, 32, "conv")), ("fnet.output_conv2", (32, 2, "conv"))]
    return out


def make_weights(num_resblock: int, seed: int, device, gain: float = 1.0) -> Weights:
    """Glorot-uniform kernels and small uniform biases for every convolution,
    drawn from ``seed`` on ``device`` in one call and sliced: float32, in the
    PyTorch modules' layouts (conv (out, in, 3, 3), transposed conv (in,
    out, 3, 3)). ``gain`` scales the residual blocks' second convs, which
    keeps the trunk's activations from growing block by block."""
    specs = conv_param_names(num_resblock)
    sizes = [(9 * cin * cout, cout) for _, (cin, cout, _) in specs]
    total = sum(a + b for a, b in sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    w: Weights = {}
    pos = 0
    for (name, (cin, cout, kind)), (nk, nb) in zip(specs, sizes):
        limit = math.sqrt(6.0 / (9 * (cin + cout)))
        if ".conv_2" in name and name.startswith("generator.resblocks"):
            limit *= gain
        shape = (cout, cin, 3, 3) if kind == "conv" else (cin, cout, 3, 3)
        w[f"{name}.weight"] = (flat[pos:pos + nk] * limit).view(shape)
        w[f"{name}.bias"] = flat[pos + nk:pos + nk + nb] * 0.01
        pos += nk + nb
    return w
