"""Training-dataset preparation (counterpart of
``tecogan_tpu/data/prepare.py``; reference dataPrepare.py +
lib/data/video.py).

Pipeline parity with reference dataPrepare.py:90-152:
- download the curated Vimeo videos (28 ids with hand-picked scene-cut-free
  start frames, dataPrepare.py:26-62) via youtube-dl/yt-dlp when available,
- reject videos narrower than 400 px (dataPrepare.py:130-137),
- cut ``duration``-frame scenes from each start frame at half resolution
  (INTER_AREA 0.5x, reference lib/data/video.py:168-173),
- write ``scene_%04d/col_high_%04d.png`` (dataPrepare.py:98-99),
- TEST dry-run (2 frames/scene) and REMOVE (delete source videos) options.

:func:`extract_scene` cuts a scene with the port's own decoder
(``data/video_io.py``: Motion JPEG and MPEG-4 Part 2 in AVI, MP4 or MKV on
the host; H.264 and VP9, what Vimeo serves, on the card's NVDEC
(unverified: ROADMAP item 12b), so
``extract_scene`` and :func:`prepare` take ``device``, the card unless the
caller asks for the CPU, where those raise; HEVC, AV1 and other codecs
raise NotImplementedError), seeks to the start frame as
``CAP_PROP_POS_FRAMES`` does (on the exact frame with B-frames), resizes 0.5x with
:func:`tecogan_tpu_torch.ops.resize.resize_area` (bit-equal to OpenCV's
``INTER_AREA``) and writes the PNGs with the port's codec.

Offline path: ``--synthetic N`` materializes N procedural scenes in the same
layout via :mod:`tecogan_tpu_torch.data.synthetic`, written with the port's
PNG codec — no network, deterministic, sufficient for training smoke and
CI (SURVEY.md §4.6).

    python -m tecogan_tpu_torch.data.prepare --synthetic 4 --duration 14 \
        --output_dir TrainingDataPath
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

# Curated Vimeo ids -> scene-cut-free start frames (reference
# dataPrepare.py:26-62; the frame lists are dataset metadata, duration=120).
VIDEO_DATA_DICT: Dict[str, List[int]] = {
    "121649159": [0, 310, 460, 720, 860],
    "40439273": [90, 520, 700, 1760, 2920, 3120, 3450, 4750, 4950, 5220, 6500,
                 6900, 9420, 9750],
    "87389090": [100, 300, 500, 800, 1000, 1200, 1500, 1900, 2050, 2450, 2900],
    "335874600": [287, 308, 621, 1308, 1538, 1768, 2036, 2181, 2544, 2749,
                  2867, 3404, 3543, 3842, 4318, 4439, 4711, 4900, 7784, 8811,
                  9450],
    "114053015": [30, 1150, 2160, 2340, 3190, 3555],
    "160578133": [550, 940, 1229, 1460, 2220, 2900, 3180, 4080, 4340, 4612,
                  4935, 5142, 5350, 5533, 7068],
    "148058982": [80, 730, 970, 1230, 1470, 1740],
    "150225201": [0, 560, 1220, 1590, 1780],
    "145096806": [0, 300, 550, 800, 980, 1500],
    "125621327": [240, 900, 1040, 1300, 1970, 2130, 2530, 3020, 3300, 3620,
                  3830, 4300, 4700, 4960],
    "162166758": [120, 350, 540, 750, 950, 1130, 1320, 1530, 1730, 1930],
    "115829238": [140, 450, 670, 910, 1100, 1380, 1520, 1720],
    "159455925": [40, 340, 490, 650, 850, 1180, 1500, 1800, 2000, 2300, 2500,
                  2800, 3200],
    "193873193": [0, 280, 1720],
    "133842385": [300, 430, 970, 1470, 1740, 2110, 2240, 2760, 3080, 3210,
                  3400, 3600],
    "97692560": [0, 210, 620, 930, 1100, 1460, 1710, 2400, 2690, 3200, 3400,
                 3560, 3780],
    "142480565": [835, 1380, 1520, 1700, 2370, 4880],
    "174952003": [480, 680, 925, 1050, 1200, 1380, 1600, 1800, 2100, 2350,
                  2480, 2680, 3000, 3200, 3460, 4500, 4780, 5040, 5630, 5830,
                  6400, 6680, 7300, 7500, 7800],
    "165643973": [300, 600, 1000, 1500, 1700, 1900, 2280, 2600, 2950, 3200,
                  3500, 3900, 4300, 4500],
    "163736142": [120, 400, 700, 1000, 1300, 1500, 1750, 2150, 2390, 2550,
                  3100, 3400, 3800, 4100, 4400, 4800, 5100, 5500, 5800, 6300],
    "189872577": [0, 170, 340, 4380, 4640, 5140, 7300, 7470, 7620, 7860, 9190,
                  9370],
    "181180995": [30, 160, 400, 660, 990, 2560, 2780, 3320, 3610, 5860, 6450,
                  7260, 7440, 8830, 9020, 9220, 9390],
    "167892347": [220, 1540, 2120, 2430, 5570, 6380, 6740],
    "146484162": [1770, 2240, 3000, 4800, 4980, 5420, 6800],
    "204313990": [110],
    "169958461": [140, 700, 1000, 1430, 1630, 1900, 2400, 2600, 2800, 3000,
                  3200, 3600, 3900, 4200, 4600, 5000, 5700, 6000, 6400, 6800,
                  7100, 7600, 7900, 8200],
    "198634890": [200, 320, 440, 1200, 1320, 1560, 1680, 1800, 1920, 3445],
    "89936769": [1260, 1380, 1880],
}


def extract_scene(video_path: str, start_frame: int, out_dir: str,
                  duration: int = 120, resize: float = 0.5,
                  test_only: bool = False, device=None) -> int:
    """Cut one scene from a video file into ``out_dir`` as
    ``col_high_%04d.png`` at ``resize`` scale (INTER_AREA, reference
    video.py:168-173; 0.5 or 1.0). Returns frames written. A file that
    does not open raises FileNotFoundError, as the JAX package's does; one
    in a codec the port does not decode raises NotImplementedError.
    ``device`` is where H.264 and VP9 decode (None: the card)."""
    from tecogan_tpu_torch.data.png import write_png
    from tecogan_tpu_torch.data.video_io import VideoReader
    from tecogan_tpu_torch.ops.resize import resize_area

    if resize != 1.0 and resize != 0.5:
        raise ValueError(f"resize {resize}: INTER_AREA is ported at 0.5 only")
    try:
        reader = VideoReader(video_path, device=device)
    except ValueError as exc:  # not a container the port reads: cv2 fails to open
        raise FileNotFoundError(f"{video_path}: {exc}") from exc
    with reader:
        os.makedirs(out_dir, exist_ok=True)
        reader.seek(start_frame)
        n = 2 if test_only else duration
        written = 0
        for i in range(n):
            frame = reader.read()
            if frame is None:
                break
            if resize != 1.0:
                frame = resize_area(frame, resize)
            write_png(os.path.join(out_dir, f"col_high_{i:04d}.png"), frame)
            written += 1
    return written


def _downloader():
    try:
        import yt_dlp as ydl_mod
        return ydl_mod
    except ImportError:
        pass
    try:
        import youtube_dl as ydl_mod
        return ydl_mod
    except ImportError:
        return None


def download_video(vid: str, video_dir: str) -> Optional[str]:
    """Fetch one Vimeo video (reference dataPrepare.py:109-121); returns the
    local path or None."""
    ydl_mod = _downloader()
    if ydl_mod is None:
        print("youtube-dl/yt-dlp not installed; cannot download. "
              "Place videos as <video_dir>/<id>.mp4 or use --synthetic.")
        return None
    os.makedirs(video_dir, exist_ok=True)
    out_tmpl = os.path.join(video_dir, "%(id)s.%(ext)s")
    opts = {"format": "bestvideo/best", "outtmpl": out_tmpl, "quiet": True}
    with ydl_mod.YoutubeDL(opts) as ydl:
        info = ydl.extract_info(f"https://vimeo.com/{vid}", download=True)
    w = info.get("width") or 0
    if w < 400:  # reference dataPrepare.py:130-137 size gate
        print(f"Video {vid} too small ({w}px wide); skipping")
        return None
    return os.path.join(video_dir, f"{info['id']}.{info['ext']}")


def prepare(output_dir: str, video_dir: str, duration: int = 120,
            resize: float = 0.5, start_id: int = 2000,
            test_only: bool = False, remove: bool = False,
            download: bool = True, device=None) -> int:
    """Full preparation run; returns the number of scenes written. ``device``
    is where H.264 and VP9 sources decode (None: the card)."""
    scene_idx = start_id
    for vid, starts in VIDEO_DATA_DICT.items():
        path = None
        for ext in ("mp4", "mkv", "webm"):
            cand = os.path.join(video_dir, f"{vid}.{ext}")
            if os.path.exists(cand):
                path = cand
                break
        if path is None and download:
            path = download_video(vid, video_dir)
        if path is None:
            print(f"Skipping video {vid} (unavailable)")
            continue
        for start in starts:
            out = os.path.join(output_dir, f"scene_{scene_idx:04d}")
            n = extract_scene(path, start, out, duration=duration,
                              resize=resize, test_only=test_only, device=device)
            print(f"scene_{scene_idx:04d}: {n} frames from {vid}@{start}")
            scene_idx += 1
        if remove:
            os.remove(path)
    return scene_idx - start_id


def main(argv=None) -> None:
    p = argparse.ArgumentParser("tecogan_tpu_torch.data.prepare")
    p.add_argument("--output_dir", default="TrainingDataPath")
    p.add_argument("--video_dir", default="VideoData")
    p.add_argument("--duration", type=int, default=120)
    p.add_argument("--resize", type=float, default=0.5)
    p.add_argument("--start_id", type=int, default=2000)
    p.add_argument("--TEST", action="store_true",
                   help="dry run: 2 frames per scene")
    p.add_argument("--REMOVE", action="store_true",
                   help="delete source videos after cutting")
    p.add_argument("--no_download", action="store_true")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N procedural scenes instead (offline)")
    args = p.parse_args(argv)

    # stdout tee (reference dataPrepare.py:72-85).
    from tecogan_tpu_torch.utils.logging import Tee

    os.makedirs(args.output_dir, exist_ok=True)
    tee = Tee(os.path.join(args.output_dir, "logfile.txt")).install()
    try:
        print("[Configurations]:")
        for k, v in sorted(vars(args).items()):
            print(f"\t{k}: {v}")
        print("End of configuration")

        if args.synthetic > 0:
            from tecogan_tpu_torch.data.synthetic import write_synthetic_scenes

            write_synthetic_scenes(
                args.output_dir, num_scenes=args.synthetic,
                num_frames=args.duration, height=288, width=352,
                start_index=args.start_id, content="natural",
            )
            print(f"Wrote {args.synthetic} synthetic scenes to {args.output_dir}")
            return
        n = prepare(args.output_dir, args.video_dir, duration=args.duration,
                    resize=args.resize, start_id=args.start_id,
                    test_only=args.TEST, remove=args.REMOVE,
                    download=not args.no_download)
        print(f"Prepared {n} scenes")
    finally:
        tee.uninstall()


if __name__ == "__main__":
    main()
