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
no fallback to the CPU. Training takes FRVSR (``--preset frvsr``) and
TecoGAN (``--preset tecogan`` or ``mini``) configurations; with
``vgg_scaling > 0`` it needs ``--vgg_npz`` (VGG19 weights under their TF
names) or ``--allow_random_weights`` (seeded random VGG19 weights, for
smoke runs), as the JAX CLI does.

Weight sources for inference, in precedence order:
  --checkpoint   a checkpoint dir of the port's trainer or of the JAX
                 package's (orbax; read without JAX, train/checkpoint.py)
  --tf_npz       a TF TecoGAN/FRVSR checkpoint dumped to npz
                 (weights.convert_tf_npz)
  --params_npz   the npz interchange of both packages (weights.params_to_npz;
                 ``tecogan_tpu/train/checkpoint.py:params_to_npz`` writes it
                 from a JAX model)
  --allow_random_weights   seeded random weights (smoke runs)

Inference reads a PNG directory or, with ``--input_video``, a video file
(Motion JPEG or MPEG-4 Part 2 in AVI, MP4 or MKV, decoded on the host;
H.264 or VP9, routed to ``--device``'s NVDEC, so ``--device cpu`` refuses
them, and NVDEC's decode is unverified (ROADMAP item 12b);
``data/video_io.py``),
and writes PNGs or, with ``--output_video``, a video (``.avi`` Motion
JPEG; ``.mp4``, ``.m4v``, ``.mkv`` MPEG-4 Part 2) at
``--output_video_fps``, else the source's rate, else 24.

Parallelism (``parallel/``): ``--spatial_shards N`` splits each frame's rows
over N devices; ``--pipeline`` runs FNet and the flow upsample on one
device and the recurrent generator on the next; the two are mutually
exclusive. On the card they take the visible CUDA devices, the first N
or the first two (too few raises), whatever ``--device`` names; with
``--device cpu`` the CPU stands for them. A library caller may place them
itself (:func:`main`'s ``mesh_devices``, e.g. every shard on one card). On
the card both run as captured CUDA graphs: the sharded chunk as one graph
where every shard sits on one device (across cards eagerly, ROADMAP item
11c), each stage as one graph on its device; the timing line names the
route. Training is data parallel under ``torchrun --nproc_per_node N
-m tecogan_tpu_torch.cli.main --mode train ...``: each process
joins the group from torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` and trains on ``cuda:LOCAL_RANK`` (``--device
cpu``: gloo on the CPU); ``--no_mesh`` trains each process alone.

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
                   help="checkpoint dir of the port's trainer or of the JAX "
                        "package's orbax checkpoints (inference)")
    p.add_argument("--tf_npz", default=None)
    p.add_argument("--params_npz", default=None)
    p.add_argument("--pre_trained_dir", default=None,
                   help="warm-start weights from a previous run's checkpoints "
                        "(the port's or the JAX package's orbax ones) or a TF "
                        "checkpoint dumped to npz")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="smoke mode without trained weights (random G/F for "
                        "inference, random VGG19 for training)")
    # inference
    p.add_argument("--input_dir_LR", default=None)
    p.add_argument("--input_dir_HR", default=None)
    p.add_argument("--input_video", default=None,
                   help="decode LR frames from a video file (Motion JPEG or "
                        "MPEG-4 Part 2 in .avi/.mp4/.m4v/.mkv) instead of a PNG "
                        "directory")
    p.add_argument("--output_video", default=None,
                   help="encode the HR output to this video file (.avi, .mp4, "
                        ".m4v, .mkv; relative paths land under "
                        "output_dir/output_pre) instead of per-frame PNGs")
    p.add_argument("--output_video_fps", type=float, default=0.0,
                   help="HR video frame rate (default: the source's, else 24)")
    p.add_argument("--output_pre", default="",
                   help="subfolder of output_dir for this scene")
    p.add_argument("--output_name", default="output")
    p.add_argument("--output_ext", default="png")
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--infer_chunk", type=int, default=None)
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="shard frame height over N devices at inference "
                        "(parallel/spatial.py): the first N visible CUDA "
                        "devices, or the CPU standing for them with --device cpu")
    p.add_argument("--pipeline", action="store_true",
                   help="pipeline the flow stage onto a second device "
                        "(parallel/pipeline.py): the first two visible CUDA "
                        "devices, or the CPU standing for both with --device cpu")
    p.add_argument("--no_mesh", action="store_true",
                   help="train on this process's device alone, without data "
                        "parallelism over a torchrun process group")
    # model / train
    p.add_argument("--vgg_npz", default=None,
                   help="VGG19 weights for the perceptual loss (an npz keyed "
                        "by the TF-slim names, vgg_19/conv1/conv1_1/weights ...)")
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


def run_inference(args, config, mesh_devices=None) -> dict:
    """Streaming inference over a PNG directory or a video file (reference
    main.py:180-270): decode (and blur, on the HR route) up front, stream
    the chunks through :class:`StreamingSR` on the device (one captured
    CUDA graph per chunk on the card, its capture inside the stream's
    seconds), encode the HR PNGs on ``queue_thread`` threads, or the HR
    video on one thread per core, while the next chunk computes. Returns
    the wall seconds of each stage and the counts. ``mesh_devices``: as
    :func:`main`'s."""
    from tecogan_tpu_torch.data.inference import FrameWriter, load_inference_frames
    from tecogan_tpu_torch.parallel import PipelinedStreamingSR, make_mesh
    from tecogan_tpu_torch.recurrent import WARMUP_FRAMES, StreamingSR

    if args.pipeline and args.spatial_shards > 1:
        # Before the (potentially minutes-long) sequence decode.
        raise SystemExit(
            "--pipeline and --spatial_shards are mutually exclusive "
            "parallelism strategies; pass exactly one"
        )
    device = resolve_device(args.device)
    if mesh_devices is None:
        # The CPU stands for as many devices as a mesh asks for; on the card
        # a mesh takes the visible CUDA devices and raises with too few.
        mesh_devices = "cpu" if device.type == "cpu" else None
    spatial_mesh = stages = None
    if args.spatial_shards > 1:
        spatial_mesh = make_mesh({config.sp_axis: args.spatial_shards}, mesh_devices)
    if args.pipeline:
        stages = make_mesh({"stage": 2}, mesh_devices).axis_devices("stage")
    # The weights and the writer first: a missing weight source, a non-PNG
    # --output_ext or an unknown video extension fails before any decode.
    gen, fnet, config = load_inference_params(args, config)
    out_dir = os.path.join(args.output_dir, args.output_pre)
    writer = video_path = None
    if args.output_video:
        from tecogan_tpu_torch.data.video_io import VideoFrameWriter, video_kind

        video_path = args.output_video
        if not os.path.isabs(video_path):
            video_path = os.path.join(out_dir, video_path)
        video_kind(video_path)
    else:
        writer = FrameWriter(out_dir, name=args.output_name, ext=args.output_ext,
                             warmup=WARMUP_FRAMES, num_threads=config.queue_thread)
    try:
        t0 = time.perf_counter()
        data = load_inference_frames(
            input_dir_lr=args.input_dir_LR, input_dir_hr=args.input_dir_HR,
            max_frames=args.max_frames, as_uint8=True, device=device,
            num_threads=config.queue_thread, input_video=args.input_video)
        decode = time.perf_counter() - t0
        if video_path is not None:
            fps = args.output_video_fps or data.fps or 24.0
            writer = VideoFrameWriter(video_path, fps=fps, warmup=WARMUP_FRAMES)
        if stages is not None:
            sr = PipelinedStreamingSR(config, gen, fnet, output="uint8",
                                      flow_device=stages[0], recurrent_device=stages[1])
        else:
            sr = StreamingSR(config, gen, fnet, output="uint8", device=device,
                             spatial_mesh=spatial_mesh)
        _, secs = sr.run(data.inputs, warmup=WARMUP_FRAMES, on_chunk=writer.submit)
    finally:
        t0 = time.perf_counter()
        written = writer.close() if writer is not None else 0
        flush = time.perf_counter() - t0
    n = data.inputs.shape[0]
    dest = video_path or out_dir
    print(f"total time {secs:.2f}, frame number {n}")  # main.py:270 format
    print(f"Wrote {written} frames to {dest}")
    print(f"io: read {decode:.3f} s, stream {secs:.3f} s ({sr.route}; of which building the "
          f"chunk's program {sr.capture_s:.3f} s), writer flush {flush:.3f} s "
          f"({writer.num_threads} encode threads, {writer.encode_s:.3f} s encoding)")
    return {"decode_s": decode, "stream_s": secs, "capture_s": sr.capture_s,
            "route": sr.route, "flush_s": flush, "encode_s": writer.encode_s, "frames": n,
            "written": written, "threads": writer.num_threads, "out_dir": out_dir,
            "dest": dest, "fps": data.fps}


def run_train(args, config) -> None:
    from tecogan_tpu_torch.train.loop import train

    vgg = None
    if config.vgg_scaling > 0:
        from tecogan_tpu_torch.models.vgg19 import load_vgg19_npz, random_vgg19

        if args.vgg_npz:
            vgg = load_vgg19_npz(args.vgg_npz)
        elif args.allow_random_weights:
            print("WARNING: random VGG19 weights (smoke mode: the perceptual "
                  "term is untrained; pass --vgg_npz for the reference "
                  "vgg_19.ckpt conversion)")
            vgg = random_vgg19(seed=config.rand_seed)
        else:
            raise SystemExit("--vgg_npz (or --allow_random_weights) required "
                             "when vgg_scaling > 0")
    device = args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.no_mesh:
        from tecogan_tpu_torch.parallel import init_distributed

        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        device = resolve_device(device)
        init_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
                         int(os.environ["RANK"]),
                         backend="nccl" if device.type == "cuda" else "gloo")
    train(config, output_dir=args.output_dir, device=resolve_device(device),
          summary_dir=args.summary_dir, vgg=vgg, pre_trained_dir=args.pre_trained_dir,
          test_while_train=not args.no_test_while_train, use_mesh=not args.no_mesh)


def main(argv=None, mesh_devices=None):
    """Run the CLI; inference returns :func:`run_inference`'s dict.

    ``mesh_devices``, for a library caller (the CLI has no flag for it):
    the devices, as ``make_mesh`` takes them, of the ``--spatial_shards``
    mesh or the ``--pipeline``'s two stages, in place of the visible CUDA
    devices; a device may repeat (``[cuda:0] * 2``: both on one card)."""
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
            return run_inference(args, config, mesh_devices)
        run_train(args, config)
    finally:
        tee.uninstall()


if __name__ == "__main__":
    main()
