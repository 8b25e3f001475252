"""VGG19's convolutional features for the perceptual loss (counterpart of
``tecogan_tpu/models/vgg19.py:37-123``; reference lib/ops.py:287-334, the
slim ``vgg_19`` without its classifier, and ``VGG19_slim``, Teco.py:5-24).

Inputs in [-1, 1] become 0-255 RGB minus the VGG mean; the features are
post-ReLU endpoints ``conv{b}_{i}``, each channel-L2-normalised. The weights
are frozen: :class:`VGG19Features` turns its parameters' gradients off, so
a backward reaches only its input.

Weights: the reference's TF-slim ``vgg_19.ckpt`` converted to an npz keyed
by TF names (``vgg_19/conv1/conv1_1/weights`` ...), :func:`load_vgg19_npz`;
or seeded random ones, :func:`random_vgg19`, for smoke runs and timing
(the perceptual term is then not the published one).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tecogan_tpu_torch.models.layers import conv2, glorot_init_, maxpool_2x2
from tecogan_tpu_torch.ops.image import deprocess

VGG_MEAN = (123.68, 116.78, 103.94)  # reference Teco.py:3

# (block, number of convs, channels)
_VGG_CFG = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))

#: The endpoints of the TecoGAN perceptual loss (reference Teco.py:176).
DEFAULT_FEATURE_KEYS = ("conv2_2", "conv3_4", "conv4_4", "conv5_4")

#: Every endpoint, in network order.
ALL_KEYS = tuple(f"conv{b}_{i}" for b, n, _ in _VGG_CFG for i in range(1, n + 1))


class VGG19Features(nn.Module):
    """The 16 convs of VGG19 (``convs["conv{b}_{i}"]``), frozen."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict()
        in_channels = 3
        for block, n_convs, ch in _VGG_CFG:
            for i in range(1, n_convs + 1):
                self.convs[f"conv{block}_{i}"] = conv2(in_channels, ch)
                in_channels = ch
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, keys: Sequence[str] = DEFAULT_FEATURE_KEYS
                ) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) -> {key: (B, h, w, C) post-ReLU endpoint}; stops after
        the last endpoint asked for."""
        last = max(ALL_KEYS.index(k) for k in keys)
        net = x.to(self.convs["conv1_1"].weight.dtype).permute(0, 3, 1, 2)
        out = {}
        for j, name in enumerate(ALL_KEYS[:last + 1]):
            if name.endswith("_1") and j:
                net = maxpool_2x2(net)
            net = F.relu(self.convs[name](net))
            if name in keys:
                out[name] = net.permute(0, 2, 3, 1)
        return {k: out[k] for k in keys}


@functools.lru_cache(maxsize=None)
def _device_mean(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``VGG_MEAN`` on ``device``, uploaded once: a captured training step
    cannot copy from pageable host memory."""
    return torch.tensor(VGG_MEAN, dtype=dtype, device=device)


def vgg19_normalized_features(vgg: VGG19Features, images_pm1: torch.Tensor,
                              keys: Sequence[str] = DEFAULT_FEATURE_KEYS
                              ) -> Dict[str, torch.Tensor]:
    """``VGG19_slim`` (reference Teco.py:5-24): (B, H, W, 3) in [-1, 1] ->
    {key: endpoint / its channel L2 norm}, the norm taken with 1e-12 inside
    the square root."""
    mean = _device_mean(images_pm1.dtype, images_pm1.device)
    feats = vgg(deprocess(images_pm1) * 255.0 - mean, keys)
    return {k: f / torch.sqrt(f.square().sum(dim=-1, keepdim=True) + 1e-12)
            for k, f in feats.items()}


def random_vgg19(seed: int = 0) -> VGG19Features:
    """Glorot-uniform VGG19 weights (zero biases) drawn from ``seed``, the
    counterpart of ``random_vgg19_params``: the step's cost and code path
    do not depend on the weights, its perceptual term does."""
    return glorot_init_(VGG19Features(), torch.Generator().manual_seed(seed))


def load_vgg19_npz(path: str) -> VGG19Features:
    """TF-slim vgg_19 weights from an npz keyed by the TF variable names
    (``vgg_19/conv{b}/conv{b}_{i}/weights`` and ``.../biases``), as a float32
    CPU module."""
    from tecogan_tpu_torch.weights import vgg19_from_jax

    with np.load(path) as data:
        tree = {name: {"kernel": data[f"vgg_19/conv{name[4]}/{name}/weights"],
                       "bias": data[f"vgg_19/conv{name[4]}/{name}/biases"]}
                for name in ALL_KEYS}
    return vgg19_from_jax(tree)
