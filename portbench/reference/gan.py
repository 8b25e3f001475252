"""The plain reference of a TecoGAN adversarial training step (thunil/TecoGAN
``runGan.py`` case 3, ``:107-244``; ``lib/Teco.py:30-74`` (Dst),
``:77-517`` (the step); ``lib/ops.py`` ``vgg_19``), in float32 PyTorch with
autograd. It reuses the generator, FNet, warps and resizes of
:mod:`portbench.reference.model` and the loader's batches and the Gaussian
of :mod:`portbench.reference.train`, and imports nothing of the program.

One step from a batch of (B, N, tar, tar, 3) uint8 HR crops:

- the LR inputs and [-1, 1] targets as in FRVSR's step, then ping-pong:
  the N frames and the N - 1 before the last, reversed (2N - 1 frames);
- FNet over every adjacent pair, the x4 HR flows, the recurrent unroll;
- the content L2 and FNet's warp L2, as in FRVSR's step;
- VGG19 up to ``conv5_4`` on the generated and the target frames: [-1, 1]
  mapped to 0-255 RGB minus the VGG mean, 3x3 convs + ReLU, a 2x2 max pool
  before each block after the first; the endpoints ``conv2_2``,
  ``conv3_4``, ``conv4_4`` and ``conv5_4`` each divided by its channel L2
  norm (1e-12 inside the root); a layer's loss is 1 - the mean over
  pixels of the channel sum of the two normalised features, and the VGG
  loss their sum;
- the ping-pong loss: the mean absolute difference of the first N - 1
  generated frames and the last N - 1 reversed;
- the discriminator's inputs: the first ``3 (T // 3)`` frames in triplets
  (t-1, t, t+1); each member warped toward the middle one by the flows
  (t-1 -> t, zero, t+1 -> t), the flows taken as constants; t+1 -> t is
  the flow of ping-pong's pair (frame t+1, frame t); the centre
  ``int(H crop_dt)`` box of the warped
  triplet kept, zero outside; then the triplet, the warped triplet and the
  4x legacy-TF bilinear upsample of the LR triplet, each with its channels
  ordered channel-major (R R R G G G B B B): 27 channels;
- Dst: conv3 -> 64 + lrelu(0.2); four blocks of a 4x4 stride-2 conv
  without bias (TF SAME padding), TF-slim batch norm (the batch's mean and
  biased variance, eps 1e-3, a bias, no scale) and lrelu(0.2); a 1x1 conv
  -> 1 and a sigmoid;
- the adversarial loss ``mean(-log(D(fake) + eps))`` and the layer losses
  (per block, the mean channel-sum L1 distance of the real and fake
  activations; their sum scaled by ``fix_range / norm``), both faded in by
  ``dt_ratio = min(max, ratio_0 + ratio_add step)``; the generator's loss
  ``content + vgg_scaling vgg + pp_scaling pingpong + ratio adv dt_ratio +
  layers dt_ratio``; one backward of it plus ``warp_scaling`` times the
  warp loss for G and FNet, and their Adams (beta2 0.999);
- the discriminator's loss ``mean(-(log(1 - D(fake) + eps) + log(D(real)
  + eps)))`` and ``t_balance = mean(log(D(real) + eps)) + adv``; its
  gradient, and its Adam with its own count and learning rate (the
  schedule at that count), applied only while the EMA of ``t_balance``
  is below ``d_balance``; the gate's counts; the running statistics
  (decay 0.9, the biased variance) updated on real, then fake, whatever
  the gate; then the EMA (decay ``loss_ema_decay``).

Departures from ``Teco.py``, each the port's and the JAX package's order:

- the gate reads the EMA of ``t_balance`` as it stood before this step,
  and the EMA takes this step's value after the step (``Teco.py`` runs the
  EMA's update beside the gated branch);
- the generator's losses see the discriminator at its parameters before
  this step's update, as constants, and its statistics do not move there;
  the discriminator's own step runs it again on the same inputs, taken as
  constants, and moves them, real first (TF orders its two update ops by
  no rule);
- one backward of the joint loss gives G and FNet their gradients (the
  warp loss does not depend on G), where ``Teco.py`` takes two;
- the VGG features' norm has 1e-12 inside the square root, not as a floor
  of the squared sum (``tf.nn.l2_normalize``): the same wherever a norm
  exceeds 1e-6.

Weights: seeded glorot-uniform makers for Dst (biases uniform in [-0.01,
0.01], as the generator's) and for VGG19 (zero biases, as the port's
``random_vgg19``), drawn on the device in one call each. Every convolution
goes through a :class:`Precision`; the control rounds the convolutions'
operands to bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model as R
from portbench.reference import train as RT

Weights = Dict[str, torch.Tensor]

VGG_MEAN = (123.68, 116.78, 103.94)
VGG19 = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))
VGG_LAYERS = ("conv2_2", "conv3_4", "conv4_4", "conv5_4")
DST_BLOCKS = (64, 64, 128, 256)
BN_EPS = 1e-3
BN_DECAY = 0.9

#: The losses a step reports, in the program's metric names.
LOSS_KEYS = ("l2_content_loss", "l2_warp_loss", "vgg_all", "PingPang", "t_adversarial_loss",
             "t_discrim_loss", "D_layer_loss_sum")


class Precision(R.Precision):
    """:class:`portbench.reference.model.Precision`, and ``"bfloat16"``: each
    convolution's inputs and weights rounded to bfloat16 and the products
    summed in float32, as bf16 tensor cores sum them (the backward's
    gradients pass the same roundings)."""

    def __init__(self, kind: str = "float32"):
        if kind == "bfloat16":
            self.kind = kind
            return
        super().__init__(kind)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "bfloat16":
            return t.to(torch.bfloat16).float()
        return super().__call__(t)


FLOAT32 = Precision()


# ----------------------------------------------------------------- weights
def _glorot(specs: Sequence[Tuple[str, Tuple[int, ...], int, int]], seed: int, device,
            bias_range: float) -> Weights:
    """For each (name, kernel shape, fan in, fan out): a glorot-uniform
    kernel and a bias uniform in [-bias_range, bias_range] (zero for 0),
    drawn from ``seed`` on ``device`` in one call and sliced."""
    sizes = [(math.prod(shape), shape[0]) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(a + b for a, b in sizes), generator=gen, device=device) * 2 - 1
    w: Weights = {}
    pos = 0
    for (name, shape, fan_in, fan_out), (nk, nb) in zip(specs, sizes):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w[f"{name}.weight"] = (flat[pos:pos + nk] * limit).view(shape)
        w[f"{name}.bias"] = flat[pos + nk:pos + nk + nb] * bias_range
        pos += nk + nb
    return w


def make_d_weights(seed: int, device, in_channels: int = 27) -> Weights:
    """Dst's parameters, keyed as the port's ``Discriminator``'s state dict
    under ``discriminator.``: glorot kernels ((out, in, k, k)), biases
    uniform in [-0.01, 0.01]; a block's conv has no bias, its batch norm
    has one."""
    specs = [("discriminator.input_stage_conv", (64, in_channels, 3, 3),
              9 * in_channels, 9 * 64)]
    cin = 64
    for i, c in enumerate(DST_BLOCKS):
        specs.append((f"discriminator.blocks.{i}.conv", (c, cin, 4, 4), 16 * cin, 16 * c))
        cin = c
    specs.append(("discriminator.dense", (1, cin, 1, 1), cin, 1))
    w = _glorot(specs, seed, device, 0.01)
    for i, c in enumerate(DST_BLOCKS):
        w[f"discriminator.blocks.{i}.bn.bias"] = w.pop(f"discriminator.blocks.{i}.conv.bias")
    return w


def d_stats_init(device) -> Weights:
    """TF-slim's initial running statistics: mean 0, variance 1."""
    out = {}
    for i, c in enumerate(DST_BLOCKS):
        out[f"discriminator.blocks.{i}.bn.running_mean"] = torch.zeros(c, device=device)
        out[f"discriminator.blocks.{i}.bn.running_var"] = torch.ones(c, device=device)
    return out


def vgg_names() -> List[Tuple[str, int, int]]:
    """(endpoint, in, out) of VGG19's 16 convs, in order."""
    out, cin = [], 3
    for block, n, c in VGG19:
        for i in range(1, n + 1):
            out.append((f"conv{block}_{i}", cin, c))
            cin = c
    return out


def make_vgg19(seed: int, device) -> Weights:
    """VGG19's 16 convs, glorot kernels and zero biases (the port's
    ``random_vgg19``'s law), keyed as ``VGG19Features``'s state dict under
    ``vgg.``."""
    specs = [(f"vgg.convs.{name}", (cout, cin, 3, 3), 9 * cin, 9 * cout)
             for name, cin, cout in vgg_names()]
    return _glorot(specs, seed, device, 0.0)


# -------------------------------------------------------------------- VGG19
def vgg_features(w: Weights, images: torch.Tensor, prec: Precision = FLOAT32
                 ) -> List[torch.Tensor]:
    """(B, H, W, 3) in [-1, 1] -> the four endpoints, NCHW, each over its
    channel L2 norm."""
    mean = torch.tensor(VGG_MEAN, device=images.device)
    net = ((images + 1) / 2 * 255.0 - mean).permute(0, 3, 1, 2)
    out = []
    for name, _, _ in vgg_names():
        if name.endswith("_1") and name != "conv1_1":
            net = F.max_pool2d(net, 2)
        net = F.relu(R.conv3(net, w[f"vgg.convs.{name}.weight"], w[f"vgg.convs.{name}.bias"],
                             prec))
        if name in VGG_LAYERS:
            out.append(net / torch.sqrt(net.square().sum(dim=1, keepdim=True) + 1e-12))
        if name == VGG_LAYERS[-1]:
            break
    return out


# ---------------------------------------------------------------------- Dst
def conv4_same(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    """4x4 stride-2 convolution with TF's SAME padding: a total of
    ``max(4 - 2, 0)`` rows for an even size and 3 for an odd one, the extra
    one after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = 2 if size % 2 == 0 else 3
        pads += [total // 2, total - total // 2]
    return F.conv2d(prec(F.pad(x, pads)), prec(w), None, stride=2)


def discriminator(w: Weights, x: torch.Tensor, prec: Precision = FLOAT32
                  ) -> Tuple[torch.Tensor, List[torch.Tensor], List[Tuple[torch.Tensor, ...]]]:
    """(B, H, W, 27) -> D's output (B, H/16, W/16) in (0, 1), the four
    blocks' activations (NCHW) and each block's batch mean and biased
    variance."""
    p = "discriminator."
    net = R.lrelu(R.conv3(x.permute(0, 3, 1, 2), w[p + "input_stage_conv.weight"],
                          w[p + "input_stage_conv.bias"], prec))
    layers, stats = [], []
    for i in range(len(DST_BLOCKS)):
        net = conv4_same(net, w[f"{p}blocks.{i}.conv.weight"], prec)
        mean = net.mean(dim=(0, 2, 3))
        var = net.var(dim=(0, 2, 3), unbiased=False)
        net = ((net - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
               + w[f"{p}blocks.{i}.bn.bias"][:, None, None])
        net = R.lrelu(net)
        layers.append(net)
        stats.append((mean.detach(), var.detach()))
    out = torch.sigmoid(F.conv2d(prec(net), prec(w[p + "dense.weight"]), w[p + "dense.bias"]))
    return out[:, 0], layers, stats


def _channel_major(trip: torch.Tensor) -> torch.Tensor:
    """(TB, 3, H, W, c) -> (TB, H, W, 3c), channel-major: R R R G G G B B B."""
    tb, _, h, w, c = trip.shape
    return trip.permute(0, 2, 3, 4, 1).reshape(tb, h, w, 3 * c)


def dst_inputs(lr: torch.Tensor, targets: torch.Tensor, gen: torch.Tensor,
               flow_hr: torch.Tensor, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The real and fake inputs of Dst from the (B, T, ...) ping-pong LR
    frames, targets, generated frames and the (B, T-1, H, W, 2) HR flows."""
    b, t, h, wd, c = targets.shape
    n = t // 3
    tb = b * n
    crop = int(h * cfg["crop_dt"])
    off = (h - crop) // 2
    crop = h - 2 * off
    flows = flow_hr.detach()
    fwd = flows[:, 0:3 * n:3]  # t-1 -> t: the pair (3k, 3k+1)
    # t+1 -> t is the pair (3k+2, 3k+1); the ping-pong sequence reads the
    # same backward, so that pair is the one at index T - 3 - 3k.
    bwd = torch.stack([flows[:, t - 3 - 3 * k] for k in range(n)], dim=1)
    trip_flows = torch.stack([fwd, torch.zeros_like(fwd), bwd], dim=2).reshape(tb * 3, h, wd, 2)

    def triplets(frames):
        return frames[:, :3 * n].reshape(tb, 3, *frames.shape[2:])

    def warped(frames):
        out = R.warp(triplets(frames).reshape(tb * 3, h, wd, c), trip_flows)
        box = out.reshape(tb, 3, h, wd, c)[:, :, off:off + crop, off:off + crop]
        return F.pad(box, (0, 0, off, wd - off - crop, off, h - off - crop))

    lr_hi = R.upsample(_channel_major(triplets(lr)), "bilinear4")
    real = torch.cat([_channel_major(triplets(targets)), _channel_major(warped(targets)), lr_hi],
                     dim=-1)
    fake = torch.cat([_channel_major(triplets(gen)), _channel_major(warped(gen)), lr_hi], dim=-1)
    return real, fake


# --------------------------------------------------------------------- step
def lr_at(cfg: Dict, count: int) -> float:
    """``tf.train.exponential_decay`` at an update's 0-based count."""
    if cfg["decay_step"] <= 0:
        return cfg["learning_rate"]
    p = count / cfg["decay_step"]
    if cfg["stair"]:
        p = math.floor(p)
    return cfg["learning_rate"] * cfg["decay_rate"] ** p


def dt_ratio(cfg: Dict, step: int) -> float:
    return min(cfg["dt_ratio_max"], cfg["dt_ratio_0"] + cfg["dt_ratio_add"] * step)


def forward(w: Weights, vgg: Weights, hr_u8: torch.Tensor, cfg: Dict, step: int,
            prec: Precision = FLOAT32) -> Dict:
    """One step's forward from the weights ``w`` (G, FNet, Dst): the
    generator's and FNet's joint loss, the reported losses, ``t_balance``
    and the discriminator's (detached) inputs."""
    if not (cfg["dt_mergeDs"] and cfg["pingpong"]):
        raise ValueError("the reference covers case 3: the merged Dst and ping-pong")
    b, n, tar, _, c = hr_u8.shape
    hr = hr_u8.float().reshape(b * n, tar, tar, c) / 255.0
    k = int(cfg["gaussian_sigma"] * 3.0)
    lr = RT.gauss_down4(hr, cfg["gaussian_sigma"])
    crop = lr.shape[1]
    targets = (hr[:, k:k + 4 * crop, k:k + 4 * crop] * 2 - 1).reshape(b, n, 4 * crop, 4 * crop, c)
    lr = lr.reshape(b, n, crop, crop, c)
    if cfg["pingpong"]:
        lr = torch.cat([lr, lr.flip(1)[:, 1:]], dim=1)
        targets = torch.cat([targets, targets.flip(1)[:, 1:]], dim=1)
    t = lr.shape[1]
    pre = lr[:, :-1].reshape(b * (t - 1), crop, crop, c)
    cur = lr[:, 1:].reshape(b * (t - 1), crop, crop, c)
    flow_lr, flow_hr = R.hr_flow(w, pre, cur, prec)
    flow_hr = flow_hr.reshape(b, t - 1, 4 * crop, 4 * crop, 2)
    zeros = torch.zeros((b, crop, crop, 48), device=hr.device)
    outs = [R.generator(w, torch.cat([lr[:, 0], zeros], dim=-1), lr[:, 0], prec)]
    for i in range(1, t):
        packed = R.space_to_depth4(R.warp(outs[-1], flow_hr[:, i - 1]) * 0.5 + 0.5)
        outs.append(R.generator(w, torch.cat([lr[:, i], packed], dim=-1), lr[:, i], prec))
    gen = torch.stack(outs, dim=1)
    hw = (4 * crop, 4 * crop, c)
    loss = {"l2_content_loss": (gen - targets).square().sum(dim=-1).mean(),
            "l2_warp_loss": (cur - R.warp(pre, flow_lr)).square().sum(dim=-1).mean()}
    g_feats = vgg_features(vgg, gen.reshape(b * t, *hw), prec)
    with torch.no_grad():
        t_feats = vgg_features(vgg, targets.reshape(b * t, *hw), prec)
    vgg_terms = [1.0 - (g * f).sum(dim=1).mean() for g, f in zip(g_feats, t_feats)]
    loss["vgg_all"] = sum(vgg_terms[1:], vgg_terms[0])
    m = cfg["rnn_n"] - 1
    loss["PingPang"] = (gen[:, :m] - gen[:, -m:].flip(1)).abs().mean()
    real, fake = dst_inputs(lr, targets, gen, flow_hr, cfg)
    frozen = {key: v.detach() for key, v in w.items() if key.startswith("discriminator.")}
    d_real, real_layers, _ = discriminator(frozen, real, prec)
    d_fake, fake_layers, _ = discriminator(frozen, fake, prec)
    eps = cfg["eps"]
    adv = (-torch.log(d_fake + eps)).mean()
    raw = [(r - f).abs().sum(dim=1).mean() for r, f in zip(real_layers, fake_layers)]
    layer_sum = sum(cfg["d_layer_fix_range"] * x / norm
                    for x, norm in zip(raw, cfg["d_layer_norm"]))
    ratio = dt_ratio(cfg, step)
    gen_loss = (loss["l2_content_loss"] + cfg["vgg_scaling"] * loss["vgg_all"]
                + cfg["pp_scaling"] * loss["PingPang"] + cfg["ratio"] * adv * ratio
                + layer_sum * ratio)
    loss["t_adversarial_loss"] = adv
    loss["t_discrim_loss"] = (-(torch.log(1 - d_fake + eps) + torch.log(d_real + eps))).mean()
    loss["D_layer_loss_sum"] = layer_sum
    return {"joint": gen_loss + cfg["warp_scaling"] * loss["l2_warp_loss"], "loss": loss,
            "t_balance": torch.log(d_real + eps).mean() + adv,
            "real": real.detach(), "fake": fake.detach()}


class _Adam:
    """Adam (beta2 0.999) on a list of leaves, with its own count."""

    def __init__(self, leaves: List[torch.Tensor], cfg: Dict):
        self.leaves = leaves
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0
        self.b1, self.eps = cfg["beta1"], cfg["adam_eps"]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.count += 1
        b1, b2 = self.b1, 0.999
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr * (m / (1 - b1 ** self.count)) / ((v / (1 - b2 ** self.count)).sqrt()
                                                       + self.eps))


def run_steps(w0: Weights, vgg: Weights, hr_batches: Sequence[np.ndarray], cfg: Dict,
              prec: Precision = FLOAT32, ema_tbalance: float = 0.0) -> Dict:
    """Steps over ``hr_batches`` from the weights ``w0`` (G, FNet, Dst) and
    TF-slim's initial statistics, the EMA of ``t_balance`` starting at
    ``ema_tbalance``: each step's losses (:data:`LOSS_KEYS`) and gate, the
    first step's gradients of every leaf, and the parameters and Dst's
    running statistics after the last step."""
    device = next(iter(w0.values())).device
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    g_keys = [k for k in w if not k.startswith("discriminator.")]
    d_keys = [k for k in w if k.startswith("discriminator.")]
    g_opt = _Adam([w[k] for k in g_keys], cfg)
    d_opt = _Adam([w[k] for k in d_keys], cfg)
    stats = d_stats_init(device)
    ema = ema_tbalance
    out: Dict = {"losses": [], "gates": [], "grads": None}
    with R.float32_math():
        for step, hb in enumerate(hr_batches):
            f = forward(w, vgg, torch.from_numpy(hb).to(device), cfg, step, prec)
            g_grads = torch.autograd.grad(f["joint"], [w[k] for k in g_keys])
            out["losses"].append([float(f["loss"][k].detach()) for k in LOSS_KEYS])
            g_opt.step(g_grads, lr_at(cfg, step))
            # The discriminator's step: the same inputs, its leaves live.
            d_w = {k: w[k] for k in d_keys}
            d_real, _, real_stats = discriminator(d_w, f["real"], prec)
            d_fake, _, fake_stats = discriminator(d_w, f["fake"], prec)
            eps = cfg["eps"]
            d_loss = (-(torch.log(1 - d_fake + eps) + torch.log(d_real + eps))).mean()
            d_grads = torch.autograd.grad(d_loss, [w[k] for k in d_keys])
            for i, (rs, fs) in enumerate(zip(real_stats, fake_stats)):
                for (mean, var) in (rs, fs):
                    rm = stats[f"discriminator.blocks.{i}.bn.running_mean"]
                    rv = stats[f"discriminator.blocks.{i}.bn.running_var"]
                    rm.mul_(BN_DECAY).add_(mean, alpha=1 - BN_DECAY)
                    rv.mul_(BN_DECAY).add_(var, alpha=1 - BN_DECAY)
            gate = ema < cfg["d_balance"]
            if gate:
                d_opt.step(d_grads, lr_at(cfg, d_opt.count))
            out["gates"].append(bool(gate))
            decay = cfg["loss_ema_decay"]
            ema = decay * ema + (1 - decay) * float(f["t_balance"].detach())
            if step == 0:
                out["grads"] = {k: g.detach().clone()
                                for k, g in zip(g_keys + d_keys, [*g_grads, *d_grads])}
    out["params"] = {k: p.detach() for k, p in w.items()}
    out["stats"] = stats
    out["counts"] = (sum(out["gates"]), len(out["gates"]) - sum(out["gates"]))
    return out


def stats_gap(got: Weights, want: Weights) -> float:
    """The worst running statistic's gap: the norm of the difference of the
    two moves from the initial statistics, over the norm of the
    reference's move."""
    init = d_stats_init(next(iter(want.values())).device)
    worst = 0.0
    for k, v in want.items():
        moved = (v - init[k]).double()
        gap = (got[k].to(v.device).double() - v.double()).norm() / moved.norm().clamp_min(1e-30)
        worst = max(worst, float(gap))
    return worst
