"""Inference and training entry point of the port (counterpart of
``tecogan_tpu/cli/main.py``; reference main.py):

    python -m tecogan_tpu_torch.cli.main --mode inference --device cuda \\
        --input_dir_LR <dir> --output_dir <out> --params_npz <npz> \\
        --compute_dtype bfloat16
    python -m tecogan_tpu_torch.cli.main --mode train --preset frvsr \\
        --device cuda --input_video_dir <scenes> --output_dir <run>

Flag names keep the JAX package's (and the reference's) spelling; every
other knob rides :class:`TecoConfig`. ``--device`` (default ``cuda``) names
the one device to run on; a CUDA device that is not there raises, there is
no fallback to the CPU. Only FRVSR training is ported: a GAN or VGG
configuration (the default ``TecoConfig()`` included: its ``ratio`` is
0.01) raises.

Weight sources for inference, in precedence order:
  --checkpoint   a checkpoint dir of the port's trainer (train/checkpoint.py)
  --tf_npz       a TF TecoGAN/FRVSR checkpoint dumped to npz
                 (weights.convert_tf_npz)
  --params_npz   the npz interchange of both packages (weights.params_to_npz;
                 ``tecogan_tpu/train/checkpoint.py:params_to_npz`` writes it
                 from a JAX model)
  --allow_random_weights   seeded random weights (smoke runs)

Inference reads and writes PNG directories only: ``--input_video``,
``--output_video``, ``--spatial_shards`` and ``--pipeline`` raise
NotImplementedError (ROADMAP queue 1 items 12 and 11).

Deviations from the JAX CLI: ``--num_resblock`` and ``--rand_seed`` default
to the preset's values (there they default to 16 and 1 and override the
preset, so ``--preset frvsr`` alone trains 16 blocks, not FRVSR's 10); and
``--params_npz`` takes the depth from the npz, with the same NOTE line as
the other sources, where the JAX CLI needs a matching ``--num_resblock``.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tecogan_tpu_torch.cli.main")
    p.add_argument("--mode", required=True, choices=["inference", "train"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--summary_dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir of the port's trainer (inference)")
    p.add_argument("--tf_npz", default=None)
    p.add_argument("--params_npz", default=None)
    p.add_argument("--pre_trained_dir", default=None,
                   help="warm-start weights from a previous run's checkpoints")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="smoke mode without trained weights (random G/F for "
                        "inference)")
    # inference
    p.add_argument("--input_dir_LR", default=None)
    p.add_argument("--input_dir_HR", default=None)
    p.add_argument("--input_video", default=None,
                   help="video-file input (not ported: ROADMAP queue 1 item 12)")
    p.add_argument("--output_video", default=None,
                   help="video-file output (not ported: ROADMAP queue 1 item 12)")
    p.add_argument("--output_pre", default="",
                   help="subfolder of output_dir for this scene")
    p.add_argument("--output_name", default="output")
    p.add_argument("--output_ext", default="png")
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--infer_chunk", type=int, default=None)
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="not ported (multi-GPU, ROADMAP queue 1 item 11)")
    p.add_argument("--pipeline", action="store_true",
                   help="not ported (multi-GPU, ROADMAP queue 1 item 11)")
    # model / train
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
    p.add_argument("--no_test_while_train", action="store_true")
    return p


_OVERRIDES = ("num_resblock", "rand_seed", "input_video_dir", "max_iter",
              "batch_size", "crop_size", "learning_rate", "decay_step",
              "decay_rate", "stair", "ratio", "vgg_scaling", "str_dir",
              "end_dir", "end_dir_val", "max_frm", "rnn_n", "queue_thread",
              "infer_chunk", "save_freq", "summary_freq", "display_freq",
              "compute_dtype")


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
                               "(pass --device cpu to run on the CPU)")
        index = device.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"--device {name}: only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(index)
    return device


def _depth_note(source: str, n_rb: int, config):
    """The JAX CLI's NOTE when the weights' depth overrides the config's."""
    if n_rb != config.num_resblock:
        print(f"NOTE: {source} has {n_rb} resblocks; overriding "
              f"--num_resblock {config.num_resblock} (the checkpoint "
              "defines the model)")
        config = config.replace(num_resblock=n_rb)
    return config


def load_inference_params(args, config):
    """The generator and FNet of the configured weight source, as float32
    CPU modules: ``(generator, fnet, config)``, the config's
    ``num_resblock`` reconciled to the weights' depth."""
    from tecogan_tpu_torch import weights

    if args.checkpoint:
        from tecogan_tpu_torch.train.checkpoint import load_models

        step, gen, fnet = load_models(args.checkpoint, config)
        print(f"Loaded checkpoint step {step} from {args.checkpoint}")
        return gen, fnet, _depth_note("checkpoint", len(gen.resblocks), config)
    if args.tf_npz:
        trees = weights.convert_tf_npz(args.tf_npz, num_resblock=None)
        config = _depth_note(args.tf_npz, weights.detect_num_resblock(trees["generator"]),
                             config)
        return (*weights.from_jax_params(trees["generator"], trees["fnet"],
                                         config.flow_max_velocity), config)
    if args.params_npz:
        trees = weights.read_params_npz(args.params_npz)
        config = _depth_note(args.params_npz,
                             weights.detect_num_resblock(trees["generator"]), config)
        return (*weights.from_jax_params(trees["generator"], trees["fnet"],
                                         config.flow_max_velocity), config)
    if args.allow_random_weights:
        from tecogan_tpu_torch.models import FNet, Generator
        from tecogan_tpu_torch.models.layers import glorot_init_

        print("WARNING: random weights (smoke mode, not a trained model)")
        gen = torch.Generator().manual_seed(config.rand_seed)
        return (glorot_init_(Generator(config.num_resblock, config.gen_channels), gen),
                glorot_init_(FNet(config.fnet_channels, config.fnet_up_channels,
                                  config.flow_max_velocity), gen),
                config)
    raise SystemExit(
        "inference needs --checkpoint, --tf_npz, --params_npz, "
        "or --allow_random_weights"
    )


def run_inference(args, config) -> dict:
    """Streaming inference over a PNG directory (reference main.py:180-270):
    decode (and blur, on the HR route) up front, stream the chunks through
    :class:`StreamingSR` on the device, encode the HR PNGs on
    ``queue_thread`` threads while the next chunk computes. Returns the wall
    seconds of each stage and the counts."""
    from tecogan_tpu_torch.data.inference import FrameWriter, load_inference_frames
    from tecogan_tpu_torch.recurrent import WARMUP_FRAMES, StreamingSR

    if args.input_video or args.output_video:
        raise NotImplementedError("--input_video / --output_video: video I/O "
                                  "without OpenCV is ROADMAP queue 1 item 12")
    if args.spatial_shards > 1 or args.pipeline:
        raise NotImplementedError("--spatial_shards / --pipeline: multi-GPU "
                                  "inference is ROADMAP queue 1 item 11")
    device = resolve_device(args.device)
    # The weights and the writer first: a missing weight source or a non-PNG
    # --output_ext fails before any decode.
    gen, fnet, config = load_inference_params(args, config)
    out_dir = os.path.join(args.output_dir, args.output_pre)
    writer = FrameWriter(out_dir, name=args.output_name, ext=args.output_ext,
                         warmup=WARMUP_FRAMES, num_threads=config.queue_thread)
    try:
        t0 = time.perf_counter()
        data = load_inference_frames(
            input_dir_lr=args.input_dir_LR, input_dir_hr=args.input_dir_HR,
            max_frames=args.max_frames, as_uint8=True, device=device,
            num_threads=config.queue_thread)
        decode = time.perf_counter() - t0
        sr = StreamingSR(config, gen, fnet, output="uint8", device=device)
        _, secs = sr.run(data.inputs, warmup=WARMUP_FRAMES, on_chunk=writer.submit)
    finally:
        t0 = time.perf_counter()
        written = writer.close()
        flush = time.perf_counter() - t0
    n = data.inputs.shape[0]
    print(f"total time {secs:.2f}, frame number {n}")  # main.py:270 format
    print(f"Wrote {written} frames to {out_dir}")
    print(f"io: read {decode:.3f} s, stream {secs:.3f} s, writer flush {flush:.3f} s "
          f"({writer.num_threads} encode threads)")
    return {"decode_s": decode, "stream_s": secs, "flush_s": flush, "frames": n,
            "written": written, "threads": writer.num_threads, "out_dir": out_dir}


def run_train(args, config) -> None:
    from tecogan_tpu_torch.train.loop import train

    if args.vgg_npz:
        raise NotImplementedError("--vgg_npz: TecoGAN training (VGG loss) is "
                                  "ROADMAP queue 1 item 8")
    train(config, output_dir=args.output_dir, device=resolve_device(args.device),
          summary_dir=args.summary_dir, pre_trained_dir=args.pre_trained_dir,
          test_while_train=not args.no_test_while_train)


def main(argv=None):
    """Run the CLI; inference returns :func:`run_inference`'s dict."""
    args = build_parser().parse_args(argv)
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
        if args.mode == "inference":
            return run_inference(args, config)
        run_train(args, config)
    finally:
        tee.uninstall()


if __name__ == "__main__":
    main()
