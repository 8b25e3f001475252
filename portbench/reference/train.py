"""The plain reference of an FRVSR training step (thunil/TecoGAN
``runGan.py`` case 4; ``lib/Teco.py:77-164,318-335,437-447``;
``lib/dataloader.py:207-348``), in float32 PyTorch with autograd.

- the loader's choice of sequences, crops and flips, worked out again from
  the loader's seed over the scenes' frames (the draw order of
  ``dataloader.py``: a permutation of the windows, a 31-bit seed a
  sequence, then the camera-pan draw (p 0.3), the crop and the flip);
- the LR inputs: a 9-tap Gaussian (sigma 1.5) over the HR crop, stride 4,
  VALID; the targets: the crop inside the Gaussian's margin, in [-1, 1];
- FNet over the (previous, current) pairs, the x4 HR flows, the recurrent
  unroll (frame 0 with zero recurrent channels; frame i from frame i-1's
  output in [-1, 1] warped, mapped to [0, 1] and packed by space-to-depth);
- the content loss ``mean(sum_c (out - target)^2)``, FNet's warp loss
  ``mean(sum_c (cur - warp(prev, flow_lr))^2)``, one backward of their sum;
- Adam (beta2 0.999) on every leaf.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model as R

Weights = Dict[str, torch.Tensor]


# ------------------------------------------------------------------ batches
def hr_load_size(cfg: Dict) -> int:
    return 4 * cfg["crop_size"] + 2 * int(cfg["gaussian_sigma"] * 3.0)


def plan(cfg: Dict, dims: Tuple[int, int], index: int, rng: np.random.RandomState):
    """One sequence: (scene, frame indices, per-frame crop rows and columns,
    flip)."""
    n = cfg["rnn_n"]
    wps = cfg["max_frm"] - n + 1
    scene, start = index // wps, index % wps
    tar, (h, w) = hr_load_size(cfg), dims
    if cfg["moving_first_frame"] and rng.rand() >= 1.0 - cfg["moving_first_frame_prob"]:
        off = np.floor(rng.uniform(-3.5, 4.5, size=(n, 2))).astype(np.int64)
        pos = np.cumsum(off, axis=0) - off
        lefttop = pos - pos.min(axis=0)
        rg = pos.max(axis=0) - pos.min(axis=0)
        oh = int(rng.uniform(0, h - tar - rg[1]))
        ow = int(rng.uniform(0, w - tar - rg[0]))
        frames, oy, ox = [start] * n, oh + lefttop[:, 1], ow + lefttop[:, 0]
    else:
        oh = int(rng.uniform(0, h - tar)) if cfg["random_crop"] else 0
        ow = int(rng.uniform(0, w - tar)) if cfg["random_crop"] else 0
        frames, oy, ox = list(range(start, start + n)), [oh] * n, [ow] * n
    flip = bool(cfg["flip"] and rng.rand() < 0.5)
    return scene, frames, oy, ox, flip


def batches(cfg: Dict, scenes: Sequence[np.ndarray], seed: int, count: int) -> List[np.ndarray]:
    """The loader's first ``count`` batches, (B, T, tar, tar, 3) uint8, from
    the scenes' (frames, H, W, 3) uint8 frames."""
    tar = hr_load_size(cfg)
    wps = cfg["max_frm"] - cfg["rnn_n"] + 1
    n = len(scenes) * wps
    rng = np.random.RandomState(seed)
    perm, cursor, out = rng.permutation(n), 0, []
    for _ in range(count):
        idxs = []
        for _ in range(cfg["batch_size"]):
            if cursor >= n:
                perm, cursor = rng.permutation(n), 0
            idxs.append(int(perm[cursor]))
            cursor += 1
        seeds = rng.randint(0, 2**31 - 1, size=len(idxs))
        seqs = []
        for i, s in zip(idxs, seeds):
            scene, frames, oy, ox, flip = plan(cfg, scenes[0].shape[1:3], i,
                                               np.random.RandomState(s))
            seq = np.stack([scenes[scene][f, y:y + tar, x:x + tar]
                            for f, y, x in zip(frames, oy, ox)])
            seqs.append(seq[:, :, ::-1] if flip else seq)
        out.append(np.ascontiguousarray(np.stack(seqs)))
    return out


# --------------------------------------------------------------------- step
def gauss_down4(hr: torch.Tensor, sigma: float) -> torch.Tensor:
    """(N, H, W, 3) -> (N, (H - k + 4) // 4, .., 3): the normalised k x k
    Gaussian (k = 1 + 2 int(3 sigma)), separable, stride 4, VALID."""
    k = 1 + 2 * int(sigma * 3.0)
    n = torch.arange(k, dtype=torch.float64) - (k - 1) / 2.0
    g1 = torch.exp(-0.5 * (n / sigma) ** 2)
    taps = (g1 / g1.sum()).float().to(hr.device)
    c = hr.shape[-1]
    x = hr.permute(0, 3, 1, 2)
    x = F.conv2d(x, taps.view(1, 1, k, 1).expand(c, 1, k, 1), stride=(4, 1), groups=c)
    x = F.conv2d(x, taps.view(1, 1, 1, k).expand(c, 1, 1, k), stride=(1, 4), groups=c)
    return x.permute(0, 2, 3, 1)


def losses(w: Weights, hr_u8: torch.Tensor, cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content loss, warp loss) of one batch of (B, T, tar, tar, 3) uint8."""
    b, t, tar, _, c = hr_u8.shape
    hr = hr_u8.float().reshape(b * t, tar, tar, c) / 255.0
    k = int(cfg["gaussian_sigma"] * 3.0)
    lr = gauss_down4(hr, cfg["gaussian_sigma"])
    crop = lr.shape[1]
    target = (hr[:, k:k + 4 * crop, k:k + 4 * crop] * 2 - 1).reshape(b, t, 4 * crop, 4 * crop, c)
    lr = lr.reshape(b, t, crop, crop, c)
    pre = lr[:, :-1].reshape(b * (t - 1), crop, crop, c)
    cur = lr[:, 1:].reshape(b * (t - 1), crop, crop, c)
    flow_lr, flow_hr = R.hr_flow(w, pre, cur)
    flow_hr = flow_hr.reshape(b, t - 1, 4 * crop, 4 * crop, 2)
    zeros = torch.zeros((b, crop, crop, 48), device=hr.device)
    outs = [R.generator(w, torch.cat([lr[:, 0], zeros], dim=-1), lr[:, 0])]
    for i in range(1, t):
        packed = R.space_to_depth4(R.warp(outs[-1], flow_hr[:, i - 1]) * 0.5 + 0.5)
        outs.append(R.generator(w, torch.cat([lr[:, i], packed], dim=-1), lr[:, i]))
    gen = torch.stack(outs, dim=1)
    content = (gen - target).square().sum(dim=-1).mean()
    warped = R.warp(pre, flow_lr)
    warp_loss = (cur - warped).square().sum(dim=-1).mean()
    return content, warp_loss


def run_steps(w0: Weights, hr_batches: Sequence[np.ndarray], cfg: Dict) -> Dict:
    """Steps over ``hr_batches`` from the weights ``w0``: each step's losses,
    the first step's gradients and the parameters after the last step."""
    device = next(iter(w0.values())).device
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    b1, b2, eps, lr = cfg["beta1"], 0.999, cfg["adam_eps"], cfg["learning_rate"]
    out = {"losses": [], "grads": None}
    with R.float32_math():
        for step, hb in enumerate(hr_batches, start=1):
            content, warp_loss = losses(w, torch.from_numpy(hb).to(device), cfg)
            grads = torch.autograd.grad(content + cfg["warp_scaling"] * warp_loss,
                                        list(w.values()))
            out["losses"].append((float(content.detach()), float(warp_loss.detach())))
            if step == 1:
                out["grads"] = {k: g.detach().clone() for k, g in zip(w, grads)}
            with torch.no_grad():
                for (k, p), g in zip(w.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k] / (1 - b2 ** step)).sqrt() + eps
                    p.sub_(lr * (m[k] / (1 - b1 ** step)) / denom)
    out["params"] = {k: p.detach() for k, p in w.items()}
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose first gradient is not nought to rounding: at least
    ``share`` of the median leaf's norm."""
    median = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= share * median]


def delta(params: Dict[str, torch.Tensor], w0: Weights) -> Dict[str, torch.Tensor]:
    return {k: params[k].float() - w0[k].float() for k in w0}

