"""Synthetic video from a seed: textured frames with sub-pixel motion.

A clip is a texture of several octaves of smooth noise with hard-edged
regions (a threshold of another noise field), seen through a camera that
pans at a constant sub-pixel velocity and a smooth local displacement
field that sways over time, so consecutive frames differ by real flows
of a few pixels. Everything is drawn from a ``torch.Generator`` on the
device in a few large calls and sampled by one ``grid_sample``; frames
leave as uint8 (T, H, W, 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _smooth_noise(gen: torch.Generator, channels: int, h: int, w: int, cell: int,
                  device) -> torch.Tensor:
    """(1, C, h, w) noise in about [-1, 1], smooth over ``cell`` pixels."""
    gh, gw = max(2, h // cell + 2), max(2, w // cell + 2)
    coarse = torch.rand((1, channels, gh, gw), generator=gen, device=device) * 2 - 1
    return F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)


def make_texture(gen: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """(1, 3, h, w) float32 texture in [0, 1]."""
    tex = torch.zeros((1, 3, h, w), device=device)
    for cell, amp in ((max(h, w) // 4, 0.35), (48, 0.25), (12, 0.2), (3, 0.1)):
        tex += amp * _smooth_noise(gen, 3, h, w, cell, device)
    edges = (_smooth_noise(gen, 1, h, w, 24, device) > 0.15).float()
    tint = torch.rand((1, 3, 1, 1), generator=gen, device=device) - 0.5
    tex = tex + 0.6 * edges * tint
    return torch.sigmoid(2.5 * tex)


def make_clip(gen: torch.Generator, frames: int, h: int, w: int, device,
              max_speed: float = 2.0, sway: float = 1.5) -> torch.Tensor:
    """(frames, h, w, 3) uint8 on ``device``: a pan of up to ``max_speed``
    pixels a frame in each axis plus a local sway of up to ``sway`` pixels."""
    margin = int(math.ceil(max_speed * frames + sway)) + 4
    th, tw = h + 2 * margin, w + 2 * margin
    tex = make_texture(gen, th, tw, device)
    vel = (torch.rand(2, generator=gen, device=device) * 2 - 1) * max_speed
    local = _smooth_noise(gen, 2, h, w, 64, device)[0] * sway  # (2, h, w) pixels
    phase = torch.rand(1, generator=gen, device=device) * 2 * math.pi
    t = torch.arange(frames, device=device, dtype=torch.float32)
    start = (torch.rand(2, generator=gen, device=device) * 2 - 1)
    shift = start[None] * margin / 2 + vel[None] * (t[:, None] - frames / 2)  # (T, 2)
    swing = torch.sin(phase + t * 0.21)  # (T,)
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    py = ys + margin + shift[:, 0, None, None] + swing[:, None, None] * local[0][None]
    px = xs + margin + shift[:, 1, None, None] + swing[:, None, None] * local[1][None]
    grid = torch.stack([(px + 0.5) / tw * 2 - 1, (py + 0.5) / th * 2 - 1], dim=-1)
    out = torch.empty((frames, h, w, 3), dtype=torch.uint8, device=device)
    step = max(1, (1 << 26) // (h * w))  # bound grid_sample's temporaries
    for s in range(0, frames, step):
        g = grid[s:s + step]
        img = F.grid_sample(tex.expand(g.shape[0], -1, -1, -1), g, mode="bilinear",
                            padding_mode="border", align_corners=False)
        out[s:s + step] = (img.permute(0, 2, 3, 1) * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    return out


def with_warmup(clip: torch.Tensor, warmup: int = 5) -> torch.Tensor:
    """The reference's inference protocol (dataloader.py:42-44): frames
    [warmup..1] reversed, then the clip."""
    return torch.cat([clip[1:warmup + 1].flip(0), clip], dim=0)


def pingpong_index(j: int, n: int) -> int:
    """The clip frame of a stream's j-th frame when it loops a clip of n
    frames forward and back: 0, 1, .., n-1, n-2, .., 1, 0, 1, .."""
    period = 2 * (n - 1)
    k = j % period
    return k if k < n else period - k
