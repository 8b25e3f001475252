"""Multi-stream serving CLI of the port (counterpart of
``tecogan_tpu/cli/serve.py``): N sequences through one batched server.

``cli.main --mode inference`` serves one sequence per process, as the
reference's main.py:253-270 does. This CLI runs several at once through
:class:`tecogan_tpu_torch.serve.MultiGeometryServer`: one slot pool per LR
geometry, streams admitted as slots free up (continuous batching), each
stream's HR frames written as PNGs by its own ``FrameWriter`` from the
server's ``fetch=False`` frames, so the downloads and the encoding overlap
the next ticks. It can instead write the exported frame step
(serve/export.py).

Sources are LR PNG directories or video files (Motion JPEG or MPEG-4
Part 2 in AVI, MP4 or MKV), of different geometries if need be; each
stream writes ``<output_dir>/<name>/<output_name>_%04d.png``, or with
``--output_videos`` ``<output_dir>/<name>.mp4`` at the source's frame rate
(24 for a PNG directory); ``<name>`` is the directory's basename or the
file's without its extension.

    python -m tecogan_tpu_torch.cli.serve --device cuda \\
        --input_dirs LR/calendar,LR/walk --output_dir results \\
        --params_npz params.npz --max_streams 4

    python -m tecogan_tpu_torch.cli.serve --device cuda --export step.pt2 \\
        --batch 4 --height 144 --width 180 --params_npz params.npz

Flag names are the JAX CLI's. ``--device`` (default ``cuda``) names the one
device to run on, with no fallback to the CPU. The JAX CLI's persistent
compilation cache is TPU tuning and has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from tecogan_tpu_torch.cli.main import load_inference_params, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tecogan_tpu_torch.cli.serve")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on, e.g. cuda, cuda:1, cpu")
    p.add_argument("--input_dirs", default=None,
                   help="comma-separated LR PNG directories or video files, one "
                        "stream each")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--output_name", default="output")
    p.add_argument("--output_videos", action="store_true",
                   help="write each stream as <output_dir>/<name>.mp4 (source fps "
                        "when known) instead of a PNG directory")
    p.add_argument("--max_streams", type=int, default=4,
                   help="slot-pool size PER GEOMETRY bucket: K distinct input "
                        "resolutions keep K*max_streams slots of state on the "
                        "device (bounded by --state_budget_mb)")
    p.add_argument("--state_budget_mb", type=float, default=2048.0,
                   help="cap on the serving state across geometry buckets; idle "
                        "buckets are evicted least recently used first to admit "
                        "new geometries, and an open that still does not fit is "
                        "refused with the computed bytes (<=0 disables)")
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--lookahead", type=int, default=16,
                   help="per-stream decoded-frame buffer depth (host memory is "
                        "O(streams * lookahead); sources decode on worker threads)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the reversed-frame warm-up padding (live-source "
                        "semantics; reference dataloader.py:42-44 pads offline "
                        "sequences)")
    # weights (the sources of cli.main)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--tf_npz", default=None)
    p.add_argument("--params_npz", default=None)
    p.add_argument("--allow_random_weights", action="store_true")
    # model
    p.add_argument("--num_resblock", type=int, default=16)
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--rand_seed", type=int, default=1)
    # export mode
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write the exported serving step (.pt2) and exit")
    p.add_argument("--batch", type=int, default=4, help="export batch size")
    p.add_argument("--height", type=int, default=144)
    p.add_argument("--width", type=int, default=180)
    return p


def config_from_args(args):
    from tecogan_tpu_torch.config import TecoConfig

    over = {"num_resblock": args.num_resblock, "rand_seed": args.rand_seed}
    if args.compute_dtype:
        over["compute_dtype"] = args.compute_dtype
    return TecoConfig().replace(**over)


def run_export(args, config, device: torch.device) -> None:
    from tecogan_tpu_torch.serve import export_frame_step, save_frame_step

    gen, fnet, config = load_inference_params(args, config)
    exported = export_frame_step(config, gen, fnet, batch=args.batch, height=args.height,
                                 width=args.width, device=device)
    save_frame_step(exported, args.export)
    size = os.path.getsize(args.export)
    print(f"Exported serving step ({args.batch}x{args.height}x{args.width}, "
          f"{config.compute_dtype}, {device}) -> {args.export} ({size / 1e6:.1f} MB)")


def run_serve(args, config, device: torch.device) -> dict:
    """Serve every source to its PNG directory or video file; returns the
    wall seconds of each stage and the counts."""
    from tecogan_tpu_torch.data.inference import FrameWriter
    from tecogan_tpu_torch.data.video_io import VideoFrameWriter
    from tecogan_tpu_torch.recurrent import WARMUP_FRAMES
    from tecogan_tpu_torch.serve import EOS, PENDING, FrameSource, MultiGeometryServer

    def stream_name(src: str) -> str:
        base = os.path.basename(os.path.normpath(src))
        return os.path.splitext(base)[0] if os.path.isfile(src) else base

    dirs = [d for d in args.input_dirs.split(",") if d]
    names = [stream_name(d) for d in dirs]
    if len(set(names)) != len(names):
        raise SystemExit("input_dirs basenames must be unique "
                         "(they name the output subdirectories)")
    warmup = 0 if args.no_warmup else WARMUP_FRAMES
    # The weights first: a missing weight source fails before any decode.
    gen, fnet, config = load_inference_params(args, config)
    sources = {name: FrameSource(d, lookahead=args.lookahead, warmup=not args.no_warmup,
                                 max_frames=args.max_frames, device=device)
               for d, name in zip(dirs, names)}
    srv = MultiGeometryServer(config, gen, fnet, slots_per_geometry=args.max_streams,
                              output="uint8", device=device,
                              state_budget_mb=(args.state_budget_mb
                                               if args.state_budget_mb > 0 else None))

    pending = list(sources)     # admission queue (FIFO per geometry bucket)
    cursor = {n: 0 for n in sources}
    writers = {}
    warming = {}                # geometry -> (background prewarm thread, start)

    def close_all() -> dict:
        """Close every writer even if one fails; the first error wins."""
        done, errs = {}, []
        for n, wtr in writers.items():
            try:
                done[n] = wtr.close()
            except Exception as exc:  # raised below, after the others closed
                errs.append(exc)
        if errs:
            raise errs[0]
        return done

    t0 = time.perf_counter()
    ticks = frames_done = 0
    tick_s = idle_s = 0.0
    try:
        while pending or srv.open_streams:
            # Admit while slots are free: a stream waits only on its own
            # geometry's bucket, and a new geometry is warmed in the
            # background while the warm buckets keep serving.
            for name in list(pending):
                src = sources[name]
                if not src.ready:
                    continue  # geometry unknown until the first frame
                h, w = src.geometry()
                geo = (h, w)
                if geo in warming:
                    th, t_w = warming[geo]
                    if th.is_alive():
                        continue
                    del warming[geo]
                    print(f"[serve] prewarmed {h}x{w} in {time.perf_counter() - t_w:.1f}s")
                elif geo not in srv.geometries:
                    warming[geo] = (srv.prewarm([geo], background=True), time.perf_counter())
                    continue
                if srv.free_slots(h, w) <= 0:
                    continue
                pending.remove(name)
                srv.open(name, h, w)
                if args.output_videos:
                    writers[name] = VideoFrameWriter(
                        os.path.join(args.output_dir, f"{name}.mp4"), fps=src.fps or 24.0,
                        warmup=warmup)
                else:
                    writers[name] = FrameWriter(os.path.join(args.output_dir, name),
                                                name=args.output_name, warmup=warmup,
                                                num_threads=2)
                used = args.max_streams - srv.free_slots(h, w)
                print(f"[serve] +{name} ({h}x{w} bucket {used}/{args.max_streams} slots)")
            # Collect whatever each stream has decoded; a lagging source
            # skips the tick (its slot state stays as it is).
            tick_frames = {}
            for name in srv.open_streams:
                f = sources[name].try_next()
                if f is PENDING:
                    continue
                if f is EOS:
                    srv.close(name)
                    print(f"[serve] -{name} done")
                    continue
                tick_frames[name] = f
            if not tick_frames:
                if pending or srv.open_streams:
                    t_i = time.perf_counter()
                    time.sleep(0.002)  # decoders or a prewarm lagging; do not spin hot
                    idle_s += time.perf_counter() - t_i
                continue
            # fetch=False: the downloads are waited for on the writer
            # threads, while the next tick computes.
            t_s = time.perf_counter()
            out = srv.step(tick_frames, fetch=False)
            tick_s += time.perf_counter() - t_s
            ticks += 1
            for name, hr in out.items():
                idx = cursor[name]
                if idx >= warmup:  # drop the warm-up (reference main.py:262-269)
                    writers[name].submit([hr], idx)
                    frames_done += 1
                cursor[name] += 1
    except BaseException:
        for src in sources.values():
            src.stop()
        for wtr in writers.values():  # the original error wins
            try:
                wtr.close()
            except Exception:
                pass
        raise
    secs = time.perf_counter() - t0
    t_f = time.perf_counter()
    written = close_all()
    flush = time.perf_counter() - t_f
    decode = sum(src.decode_s for src in sources.values())
    encode = sum(wtr.encode_s for wtr in writers.values())
    print(f"total time {secs:.2f}, frame number {sum(written.values())}")
    print(f"{ticks} ticks, {frames_done / secs:.1f} frames/sec aggregate; wrote {written}")
    print(f"io: decode {decode:.3f} s on the source threads, ticks {tick_s:.3f} s, "
          f"waiting for decode or a prewarm {idle_s:.3f} s, encode {encode:.3f} s on the "
          f"writer threads, writer flush {flush:.3f} s")
    return {"secs": secs, "ticks": ticks, "frames": frames_done, "written": written,
            "decode_s": decode, "tick_s": tick_s, "idle_s": idle_s, "encode_s": encode,
            "flush_s": flush}


def main(argv=None):
    """Run the CLI; serving returns :func:`run_serve`'s dict."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    device = resolve_device(args.device)
    if args.export:
        run_export(args, config, device)
        return None
    if not args.input_dirs or not args.output_dir:
        raise SystemExit("serving needs --input_dirs and --output_dir (or use --export)")
    os.makedirs(args.output_dir, exist_ok=True)
    return run_serve(args, config, device)


if __name__ == "__main__":
    main()
