"""LPIPS (net-lin, AlexNet) as a torch module (counterpart of
``tecogan_tpu/eval/lpips.py``; reference LPIPSmodels/ ``PNetLin``,
networks_basic.py:95-177, AlexNet slices pretrained_networks.py:57-95):

  d(x0, x1) = sum_l mean_hw( lin_l . (unit_norm(F_l(x0)) - unit_norm(F_l(x1)))^2 )

where F_l are AlexNet's features after each of its five ReLUs, unit_norm a
channel-wise L2 normalisation and lin_l the learned non-negative 1x1 weights
of LPIPS v0.1.

The module takes the JAX package's weight layout (``{"conv{i}": {"w": HWIO,
"b": (out,)}}`` for i in 0..4, plus five lin vectors) and holds it as torch
``Conv2d`` weights on an explicit device. Its convolutions run in float32:
on a CUDA device cuDNN with TF32 switched off for the call, as the JAX
package computes them with ``lax.conv_general_dilated`` in float32.

Weights: the lin layers load from the reference's 6 kB ``v0.1/alex.pth``
(:func:`load_lin_weights_pth`); the AlexNet backbone is torchvision's
ImageNet ``alexnet``, supplied as a ``.pth`` or ``.npz`` file
(:func:`load_alexnet_pth`, :func:`load_alexnet_npz`). Without them the
suite skips LPIPS and tLP100 (:func:`default_lpips` returns None).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# networks_basic.py:30-31 ScalingLayer constants.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision AlexNet ``features`` convs: (out_ch, kernel, stride, pad).
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
# A 3x3 stride-2 max-pool follows ReLU 1 and ReLU 2.
_POOL_AFTER = {0, 1}


class LPIPS(nn.Module):
    """LPIPS distance on ``device``. ``lpips(img0, img1)``: (B, H, W, 3) RGB
    in [-1, 1] (numpy or tensors) -> (B,) float32 distances, a tensor on
    ``device``."""

    def __init__(self, alex_params: Dict, lin_weights: List[np.ndarray],
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        self.convs = nn.ModuleList()
        in_ch = 3
        for i, (out_ch, k, stride, pad) in enumerate(_ALEX_CONVS):
            conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=pad)
            with torch.no_grad():
                w = np.asarray(alex_params[f"conv{i}"]["w"], np.float32)
                conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
                conv.bias.copy_(torch.from_numpy(
                    np.asarray(alex_params[f"conv{i}"]["b"], np.float32)))
            self.convs.append(conv)
            in_ch = out_ch
        for i, w in enumerate(lin_weights):
            self.register_buffer(f"lin{i}", torch.from_numpy(
                np.asarray(w, np.float32)).view(1, -1, 1, 1))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        self.to(self.device).eval()

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five post-ReLU AlexNet feature maps of NCHW ``x``, already
        shift/scale-normalised (float32 convolutions: TF32 off)."""
        feats = []
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for i, conv in enumerate(self.convs):
                x = F.relu(conv(x))
                feats.append(x)
                if i in _POOL_AFTER:
                    x = F.max_pool2d(x, 3, stride=2)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        return feats

    @torch.no_grad()
    def forward(self, img0, img1) -> torch.Tensor:
        x0, x1 = ((torch.as_tensor(im).to(self.device, torch.float32).permute(0, 3, 1, 2)
                   - self.shift) / self.scale for im in (img0, img1))
        f0, f1 = self.features(x0), self.features(x1)
        val = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            per_pixel = (diff * getattr(self, f"lin{i}")).sum(dim=1)
            val = val + per_pixel.mean(dim=(1, 2))  # networks_basic.py:162-165
        return val

    @staticmethod
    def im2tensor(img_uint8_rgb: np.ndarray) -> np.ndarray:
        """uint8-range RGB (H, W, 3) -> (1, H, W, 3) in [-1, 1]
        (LPIPSmodels/util.py:142-146)."""
        return (img_uint8_rgb.astype(np.float32) / (255.0 / 2.0) - 1.0)[None]


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


@torch.no_grad()
def alexnet_features(params: Dict, x) -> List[torch.Tensor]:
    """The five post-ReLU AlexNet feature maps (NHWC) of (B, H, W, 3) ``x``,
    already shift/scale-normalised, on ``x``'s device (the CPU for numpy):
    :class:`LPIPS`'s layers over the JAX layout's ``params``, the
    counterpart of ``tecogan_tpu/eval/lpips.py:72``."""
    device = _device_of(x)
    lpips = LPIPS(params, [np.zeros(c, np.float32) for c, *_ in _ALEX_CONVS], device)
    x = torch.as_tensor(x).to(device, torch.float32).permute(0, 3, 1, 2)
    return [f.permute(0, 2, 3, 1) for f in lpips.features(x)]


def lpips_distance(alex_params: Dict, lin_weights: List[np.ndarray], img0, img1
                   ) -> torch.Tensor:
    """(B,) LPIPS distances of (B, H, W, 3) RGB in [-1, 1] on ``img0``'s
    device (the CPU for numpy): an :class:`LPIPS` module over the weights,
    the counterpart of ``tecogan_tpu/eval/lpips.py:95``."""
    return LPIPS(alex_params, lin_weights, _device_of(img0))(img0, img1)


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-wise L2 normalisation (LPIPSmodels/util.py normalize_tensor)."""
    return f / (f.pow(2).sum(dim=1, keepdim=True).sqrt() + eps)


# ------------------------------------------------------------------ weights
def load_lin_weights_pth(path: str) -> List[np.ndarray]:
    """The five learned 1x1 weights of LPIPS ``v0.1/alex.pth``."""
    sd = torch.load(path, map_location="cpu")
    return [np.ascontiguousarray(sd[f"lin{i}.model.1.weight"].numpy()[0, :, 0, 0])
            .astype(np.float32) for i in range(5)]


def load_alexnet_pth(path: str) -> Dict:
    """A torchvision AlexNet state_dict (.pth) in the JAX layout."""
    sd = torch.load(path, map_location="cpu")
    params = {}
    for i, j in enumerate([0, 3, 6, 8, 10]):  # features.{j}.{weight,bias}
        w = sd[f"features.{j}.weight"].numpy()  # (out, in, kh, kw)
        params[f"conv{i}"] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32),
            "b": sd[f"features.{j}.bias"].numpy().astype(np.float32),
        }
    return params


def load_alexnet_npz(path: str) -> Dict:
    """AlexNet weights from an .npz with keys conv{i}_w (HWIO) / conv{i}_b."""
    with np.load(path) as z:
        return {f"conv{i}": {"w": z[f"conv{i}_w"], "b": z[f"conv{i}_b"]}
                for i in range(5)}


def random_alexnet_params(seed: int) -> Dict:
    """He-initialised backbone drawn from ``seed`` with numpy, zero biases,
    for tests and structure checks (not LPIPS values)."""
    rng = np.random.default_rng(seed)
    params, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX_CONVS):
        w = rng.standard_normal((k, k, in_ch, out_ch)) * np.sqrt(2.0 / (k * k * in_ch))
        params[f"conv{i}"] = {"w": w.astype(np.float32),
                              "b": np.zeros((out_ch,), np.float32)}
        in_ch = out_ch
    return params


def default_lpips(reference_root: Optional[str] = None,
                  backbone_path: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda") -> Optional[LPIPS]:
    """The LPIPS evaluator on ``device`` if its weights are there, else
    None: the lin weights at ``<reference_root>/LPIPSmodels/v0.1/alex.pth``
    (``reference_root`` defaults to ``$TECOGAN_REFERENCE_ROOT``, where the
    JAX package has a fixed path), the backbone at ``backbone_path`` or
    ``$TECOGAN_LPIPS_BACKBONE`` (.pth or .npz)."""
    reference_root = reference_root or os.environ.get("TECOGAN_REFERENCE_ROOT")
    backbone_path = backbone_path or os.environ.get("TECOGAN_LPIPS_BACKBONE")
    if not (reference_root and backbone_path):
        return None
    lin_path = os.path.join(reference_root, "LPIPSmodels", "v0.1", "alex.pth")
    if not (os.path.exists(backbone_path) and os.path.exists(lin_path)):
        return None
    alex = (load_alexnet_npz(backbone_path) if backbone_path.endswith(".npz")
            else load_alexnet_pth(backbone_path))
    return LPIPS(alex, load_lin_weights_pth(lin_path), device)
