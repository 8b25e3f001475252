"""FRVSR and TecoGAN losses (counterpart of ``tecogan_tpu/train/losses.py``;
reference lib/Teco.py:77-435). The L2 losses are ``mean(sum(sq, channel))``,
i.e. 3x the plain MSE, as in the reference; the ping-pong loss is a plain L1
mean; the VGG loss is one minus the cosine similarity per layer; the
discriminator's feature losses are channel-sum L1 means scaled to a fixed
range. :func:`assemble_dst_inputs` builds the discriminator's inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tecogan_tpu_torch.config import TecoConfig
from tecogan_tpu_torch.kernels.upsample4 import upscale_bilinear4
from tecogan_tpu_torch.ops.warp import dense_image_warp, dense_image_warp_box


def content_loss(gen_outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """L2 content loss: mean over pixels of the channel-summed square
    (reference Teco.py:318-325)."""
    return (gen_outputs - targets).square().sum(dim=-1).mean()


def warp_loss(r_inputs: torch.Tensor, flow_lr: torch.Tensor) -> torch.Tensor:
    """FNet's warp loss in the LR domain: frame t-1 warped by the predicted
    flow against frame t (reference Teco.py:120-122,328-335).

    Args:
      r_inputs: (B, T, h, w, 3) LR frames in [0, 1].
      flow_lr: (B, T-1, h, w, 2) LR flows.
    """
    b, t, h, w, c = r_inputs.shape
    pre = r_inputs[:, :-1].reshape(b * (t - 1), h, w, c)
    cur = r_inputs[:, 1:].reshape(b * (t - 1), h, w, c)
    warped = dense_image_warp(pre, flow_lr.reshape(b * (t - 1), h, w, 2))
    return (cur - warped).square().sum(dim=-1).mean()


def pingpong_loss(gen_outputs: torch.Tensor, rnn_n: int) -> torch.Tensor:
    """L1 between the forward half of the ping-pong unroll and its reversed
    backward half, reduced in float32 (reference Teco.py:362-372)."""
    first = gen_outputs[:, :rnn_n - 1].float()
    last_rev = gen_outputs[:, -(rnn_n - 1):].flip(1).float()
    return (first - last_rev).abs().mean()


def vgg_cosine_loss(gen_feats: Dict[str, torch.Tensor],
                    target_feats: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sum over layers of 1 - the mean cosine similarity of channel-L2-
    normalised NHWC features (reference Teco.py:339-358). Returns the total
    and the per-layer terms."""
    per_layer = [1.0 - (gen_feats[k].float() * target_feats[k].float()).sum(dim=-1).mean()
                 for k in gen_feats]
    total = per_layer[0]
    for layer in per_layer[1:]:
        total = total + layer
    return total, per_layer


def d_layer_losses(real_layers: Sequence[torch.Tensor], fake_layers: Sequence[torch.Tensor],
                   layer_norms: Sequence[float], fix_range: float
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The discriminator's feature-matching losses (reference
    Teco.py:280-313): per layer the mean channel-sum L1 distance (raw), and
    the sum of ``fix_range * raw / norm`` that the generator minimises."""
    raw = [(r.float() - f.float()).abs().sum(dim=-1).mean()
           for r, f in zip(real_layers, fake_layers)]
    total = fix_range * raw[0] / layer_norms[0]
    for layer, norm in zip(raw[1:], layer_norms[1:]):
        total = total + fix_range * layer / norm
    return total, raw


def _triplet_channels(x: torch.Tensor) -> torch.Tensor:
    """(TB, 3, H, W, C) -> (TB, H, W, 3C) in the reference's channel order
    R R R G G G B B B, the triplet member fastest (Teco.py:227-229)."""
    tb, _, h, w, c = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(tb, h, w, 3 * c)


def assemble_dst_inputs(r_inputs: torch.Tensor, r_targets: torch.Tensor,
                        gen_outputs: torch.Tensor, flow_hr: torch.Tensor,
                        config: TecoConfig, flow_hr_back: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The real and fake discriminator inputs (reference Teco.py:180-270;
    counterpart of ``tecogan_tpu/train/losses.py:113-307``).

    Frames are grouped in consecutive triplets (t-1, t, t+1); the outer
    members are warped toward the middle one by the forward flow and the
    backward flow. Under ping-pong the backward flows are the extension's
    (every third flow counting back from the second-to-last, Teco.py:206-209);
    otherwise the caller passes ``flow_hr_back``, (B, T//3, 4h, 4w, 2), FNet
    on the (next, middle) pairs (Teco.py:190-203). Flows are detached: no
    discriminator gradient reaches FNet (Teco.py:214).

    Only the centre ``crop_dt`` box of the warped triplet is ever used
    (``crop = int(H * crop_dt)``, ``off = (H - crop) // 2``, ``crop = H -
    2 off``), so only the box is warped (:func:`dense_image_warp_box`,
    gathering from the whole frames), and the middle member, whose flow is
    zero, is passed through (a zero-flow warp is an identity in value and
    gradient). The merged Dst (``config.dt_mergeDs``) zero-pads the warped
    box back and concatenates the triplet, the warped triplet and the 4x
    bilinear upsample of the LR triplet (kernel K1): 27 channels at (4h,
    4w). The pure Dt takes the 9-channel warped box as it is.

    Returns:
      (real, fake): each (B * T//3, 4h, 4w, 27), or (B * T//3, crop, crop, 9)
      for the pure Dt.
    """
    b, t, hr_h, hr_w, c = r_targets.shape
    t_size = 3 * (t // 3)
    n_trip = t_size // 3
    t_batch = b * n_trip
    crop = int(hr_h * config.crop_dt)
    off = (hr_h - crop) // 2
    crop = hr_h - 2 * off

    v_pre = flow_hr[:, 0:t_size:3]
    if flow_hr_back is not None:
        v_nxt = flow_hr_back
    elif config.pingpong:
        t_flows = flow_hr.shape[1]
        start = t_flows - 2 - 3 * (n_trip - 1)
        v_nxt = flow_hr[:, start:t_flows - 1:3].flip(1)
    else:
        raise ValueError("without ping-pong the backward flows must be passed "
                         "(reference Teco.py:190-203)")
    box = (slice(None), slice(None), slice(off, off + crop), slice(off, off + crop))
    t_vel = torch.stack([v_pre[box], v_nxt[box]], dim=2).detach().float()
    t_vel = t_vel.reshape(t_batch * 2, crop, crop, 2)

    def members(frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, c) -> the triplets' (TB, 3, crop, crop, c) warped
        box."""
        trips = frames[:, :t_size].reshape(t_batch, 3, hr_h, hr_w, c)
        edges = trips[:, 0::2].reshape(t_batch * 2, hr_h, hr_w, c)
        we = dense_image_warp_box(edges, t_vel, (off, off)).reshape(t_batch, 2, crop, crop, c)
        mid = trips[:, 1:2, off:off + crop, off:off + crop]
        return torch.cat([we[:, :1], mid, we[:, 1:]], dim=1)

    warped_r = _triplet_channels(members(r_targets))
    warped_f = _triplet_channels(members(gen_outputs))
    if not config.dt_mergeDs:
        return warped_r, warped_f
    pad = (0, 0, off, hr_w - off - crop, off, hr_h - off - crop)
    lr_h, lr_w = r_inputs.shape[2], r_inputs.shape[3]
    lr9 = _triplet_channels(r_inputs[:, :t_size].reshape(t_batch, 3, lr_h, lr_w, c))
    input_hi = upscale_bilinear4(lr9.contiguous())

    def merged(frames: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
        before = _triplet_channels(frames[:, :t_size].reshape(t_batch, 3, hr_h, hr_w, c))
        return torch.cat([before, F.pad(warped, pad), input_hi], dim=-1)

    return merged(r_targets, warped_r), merged(gen_outputs, warped_f)
