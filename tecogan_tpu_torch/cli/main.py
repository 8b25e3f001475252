"""Training entry point of the port (counterpart of
``tecogan_tpu/cli/main.py:24-122,295-355``; reference main.py):

    python -m tecogan_tpu_torch.cli.main --mode train --preset frvsr \\
        --device cuda --input_video_dir <scenes> --output_dir <run>

Flag names keep the JAX package's (and the reference's) spelling; every
other knob rides :class:`TecoConfig`. ``--device`` (default ``cuda``) names
the one device to train on; a CUDA device that is not there raises, there is
no fallback to the CPU. Only FRVSR training is ported: ``--mode inference``
waits for ROADMAP queue 1 item 5, and a GAN or VGG configuration (the
default ``TecoConfig()`` included: its ``ratio`` is 0.01) raises.

Deviation from the JAX CLI: ``--num_resblock`` and ``--rand_seed`` default
to the preset's values. There they default to 16 and 1 and override the
preset, so ``--preset frvsr`` alone trains 16 blocks, not FRVSR's 10.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tecogan_tpu_torch.cli.main")
    p.add_argument("--mode", required=True, choices=["inference", "train"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--summary_dir", default=None)
    p.add_argument("--pre_trained_dir", default=None,
                   help="warm-start weights from a previous run's checkpoints")
    p.add_argument("--vgg_npz", default=None,
                   help="VGG19 weights for the perceptual loss (TecoGAN "
                        "training, not ported yet)")
    p.add_argument("--num_resblock", type=int, default=None)
    p.add_argument("--rand_seed", type=int, default=None)
    p.add_argument("--preset", default=None,
                   choices=[None, "frvsr", "tecogan", "mini"])
    p.add_argument("--input_video_dir", default="")
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--decay_step", type=int, default=None,
                   help="lr exponential-decay step (reference main.py:61)")
    p.add_argument("--decay_rate", type=float, default=None,
                   help="lr exponential-decay rate (reference main.py:62)")
    p.add_argument("--stair", action="store_true", default=None,
                   help="staircase decay (reference main.py:87)")
    p.add_argument("--ratio", type=float, default=None)
    p.add_argument("--vgg_scaling", type=float, default=None)
    p.add_argument("--str_dir", type=int, default=None)
    p.add_argument("--end_dir", type=int, default=None)
    p.add_argument("--end_dir_val", type=int, default=None)
    p.add_argument("--max_frm", type=int, default=None)
    p.add_argument("--rnn_n", type=int, default=None,
                   help="training unroll length (reference RNN_N, main.py:101)")
    p.add_argument("--queue_thread", type=int, default=None)
    p.add_argument("--save_freq", type=int, default=None,
                   help="checkpoint every N steps (reference main.py:58)")
    p.add_argument("--summary_freq", type=int, default=None)
    p.add_argument("--display_freq", type=int, default=None)
    p.add_argument("--compute_dtype", default=None)
    return p


_OVERRIDES = ("num_resblock", "rand_seed", "input_video_dir", "max_iter",
              "batch_size", "crop_size", "learning_rate", "decay_step",
              "decay_rate", "stair", "ratio", "vgg_scaling", "str_dir",
              "end_dir", "end_dir_val", "max_frm", "rnn_n", "queue_thread",
              "save_freq", "summary_freq", "display_freq", "compute_dtype")


def config_from_args(args):
    """The preset (or ``TecoConfig()``) with every flag given overriding it."""
    from tecogan_tpu_torch.config import (
        FRVSR_PRESET, MINI_PRESET, TECOGAN_PRESET, TecoConfig,
    )

    base = {"frvsr": FRVSR_PRESET, "tecogan": TECOGAN_PRESET,
            "mini": MINI_PRESET}.get(args.preset, TecoConfig())
    overrides = {}
    for field in _OVERRIDES:
        v = getattr(args, field)
        if v is not None and v != "":
            overrides[field] = v
    return base.replace(**overrides)


def resolve_device(name: str) -> torch.device:
    """The device ``--device`` names; raises if it is a CUDA device that
    this machine does not have."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available "
                               "(pass --device cpu to train on the CPU)")
        index = device.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"--device {name}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(index)
    return device


def run_train(args, config) -> None:
    from tecogan_tpu_torch.train.loop import train

    if args.vgg_npz:
        raise NotImplementedError("--vgg_npz: TecoGAN training (VGG loss) is "
                                  "ROADMAP queue 1 item 8")
    train(config, output_dir=args.output_dir, device=resolve_device(args.device),
          summary_dir=args.summary_dir, pre_trained_dir=args.pre_trained_dir)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "inference":
        raise NotImplementedError("--mode inference: the port's inference CLI "
                                  "is ROADMAP queue 1 item 5; use "
                                  "tecogan_tpu_torch.recurrent.StreamingSR")
    config = config_from_args(args)
    # Seed everything seedable (reference main.py:15-19,109-113).
    random.seed(config.rand_seed)
    np.random.seed(config.rand_seed)
    torch.manual_seed(config.rand_seed)

    from tecogan_tpu_torch.utils.logging import Tee

    os.makedirs(args.output_dir, exist_ok=True)
    log_dir = args.summary_dir or args.output_dir
    os.makedirs(log_dir, exist_ok=True)
    tee = Tee(os.path.join(log_dir, "logfile.txt")).install()
    try:
        print("[Configurations]:")
        for k, v in sorted(vars(args).items()):
            print(f"\t{k}: {v}")
        print("End of configuration")
        run_train(args, config)
    finally:
        tee.uninstall()


if __name__ == "__main__":
    main()
