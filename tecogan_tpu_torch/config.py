"""Configuration for the PyTorch port.

Counterpart of ``tecogan_tpu/config.py``: the same model, data, loss,
optimisation and runtime fields with the same defaults, and the same three
presets (reference runGan.py cases 1/3/4). The TPU tuning knobs of the JAX
package (the ``inline_flow`` / ``fold_input_s2d`` / ``train_fold_s2d`` /
``pallas_flow_upsample`` / ``fused_trunk`` mode strings) have no
counterpart here: on CUDA the port's kernels are always on. The mesh axis
names are kept (``parallel/``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TecoConfig:
    """Every knob of the port, with reference-parity defaults."""

    # --- model architecture (reference main.py:47, frvsr.py:44-88) ---
    num_resblock: int = 16          # 16 for TecoGAN, 10 for FRVSR / mini
    gen_channels: int = 64          # generator trunk width
    fnet_channels: Tuple[int, ...] = (32, 64, 128)   # encoder widths
    fnet_up_channels: Tuple[int, ...] = (256, 128, 64)
    flow_max_velocity: float = 24.0  # tanh scale of fnet output (frvsr.py:39-40)
    upscale: int = 4                 # fixed 4x super resolution

    # --- temporal unroll (reference main.py:64, Teco.py:80-85) ---
    rnn_n: int = 10                  # recurrent unroll length in frames
    pingpong: bool = False           # ping-pong sequence extension (2N-1 frames)

    # --- data (reference main.py:62-76, dataloader.py:276-348) ---
    batch_size: int = 4
    crop_size: int = 32              # LR crop; HR crop is 4x
    flip: bool = True
    random_crop: bool = True
    moving_first_frame: bool = True  # camera-pan augmentation (dataloader.py:107-120)
    moving_first_frame_prob: float = 0.3
    input_video_dir: str = ""
    input_video_pre: str = "scene"
    str_dir: int = 1000
    end_dir: int = 2000
    end_dir_val: int = 2050
    max_frm: int = 119
    queue_thread: int = 6            # host decode threads
    prefetch_depth: int = 2          # device prefetch (double-buffer)
    train_upload_uint8: bool = True  # upload uint8 crops, normalise on device
    loader_cache_mb: int = 256       # LRU decoded-frame cache (0 = off)
    gaussian_sigma: float = 1.5      # HR->LR gaussian down-4 sigma (ops.py:347)

    # --- losses (reference main.py:77-103, Teco.py:280-399) ---
    vgg_scaling: float = -0.002      # <=0 disables VGG loss
    warp_scaling: float = 1.0
    pp_scaling: float = 1.0          # ping-pong loss weight
    ratio: float = 0.01              # adversarial loss weight; <=0 -> FRVSR mode
    dt_mergeDs: bool = True          # spatio-temporal D (27ch) vs pure temporal (9ch)
    dt_ratio_0: float = 1.0          # D fade-in start
    dt_ratio_add: float = 0.0        # D fade-in increment per step
    dt_ratio_max: float = 1.0        # D fade-in cap
    d_balance: float = 0.4           # adaptive D gating threshold (Teco.py:494)
    crop_dt: float = 0.75            # center-crop factor for Dt inputs
    d_layerloss: bool = True         # discriminator feature-layer losses
    d_layer_norm: Tuple[float, ...] = (12.0, 14.0, 24.0, 100.0)  # Teco.py:290
    d_layer_fix_range: float = 0.02  # Teco.py:281
    eps: float = 1e-12

    # --- optimization (reference main.py:83-94) ---
    learning_rate: float = 1e-4
    decay_step: int = 500_000
    decay_rate: float = 0.5
    stair: bool = False
    beta1: float = 0.9
    adam_eps: float = 1e-8
    max_iter: int = 1_000_000
    display_freq: int = 20
    summary_freq: int = 100
    save_freq: int = 10_000
    loss_ema_decay: float = 0.99     # EMA over loss telemetry (Teco.py:415,433)

    # --- precision & runtime ---
    compute_dtype: str = "float32"   # "float32" | "bfloat16"
    remat_generator: Any = "auto"    # per-frame activation checkpointing in
    #   the training unroll: True | False | "auto"
    infer_chunk: int = 16            # frames per chunk at inference

    # --- parallelism (parallel/; the reference is single-GPU) ---
    dp_axis: str = "data"            # data-parallel mesh axis name
    sp_axis: str = "space"           # spatial-sharding mesh axis name

    # --- misc ---
    rand_seed: int = 1

    # -------------------------------------------------------------- helpers
    @property
    def gan(self) -> bool:
        """TecoGAN (adversarial) vs FRVSR mode (reference main.py:283-286)."""
        return self.ratio > 0

    @property
    def unroll_frames(self) -> int:
        """Total frames in the training unroll (2N-1 under ping-pong)."""
        return self.rnn_n * 2 - 1 if self.pingpong else self.rnn_n

    @property
    def gauss_border(self) -> int:
        """HR crop margin consumed by the VALID gaussian down-4 conv
        (reference dataloader.py:279-280)."""
        return int(self.gaussian_sigma * 3.0)

    @property
    def hr_load_size(self) -> int:
        return self.crop_size * self.upscale + 2 * self.gauss_border

    @property
    def torch_dtype(self) -> torch.dtype:
        """``compute_dtype`` as a torch dtype."""
        return _DTYPES[self.compute_dtype]

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r}; expected "
                             f"one of {tuple(_DTYPES)}")
        if self.crop_size % 8 != 0:
            raise ValueError(
                f"crop_size={self.crop_size} must be a multiple of 8 "
                "(FNet has three 2x2 maxpools; the training unroll does "
                "not pad odd LR grids back — reference uses 32)")

    def replace(self, **kw) -> "TecoConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "TecoConfig":
        d = json.loads(s)
        for k in ("fnet_channels", "fnet_up_channels", "d_layer_norm"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d)


# Canonical presets, mirroring runGan.py run cases -------------------------

#: FRVSR training (reference runGan.py case 4, :247-296)
FRVSR_PRESET = TecoConfig(
    num_resblock=10,
    learning_rate=5e-5,
    decay_step=500_000,
    decay_rate=1.0,
    stair=True,
    max_iter=500_000,
    ratio=-0.01,
    pingpong=False,
    str_dir=2000,
    end_dir=2250,
    end_dir_val=2290,
    queue_thread=12,
)

#: Full TecoGAN adversarial training (reference runGan.py case 3, :107-244)
TECOGAN_PRESET = TecoConfig(
    num_resblock=16,
    learning_rate=5e-5,
    decay_step=500_000,
    decay_rate=1.0,
    stair=True,
    max_iter=500_000,
    vgg_scaling=0.2,
    ratio=0.01,
    dt_mergeDs=True,
    pingpong=True,
    pp_scaling=0.5,
    d_layerloss=True,
    str_dir=2000,
    end_dir=2250,
    end_dir_val=2290,
    queue_thread=12,
)

#: TecoGAN-mini (10 resblocks, reference runGan.py:86,269)
MINI_PRESET = TECOGAN_PRESET.replace(num_resblock=10)
