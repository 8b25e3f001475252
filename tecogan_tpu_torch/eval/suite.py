"""The metrics suite: PSNR / SSIM / LPIPS / tOF / tLP100 -> ``metrics.csv``
(counterpart of ``tecogan_tpu/eval/suite.py``; reference metrics.py:109-240).

Per result/target folder pair, frames ``[CUTFR, N - CUTFR)`` are scored;
the per-frame series go to ``metrics.csv`` as ``<KEY>_<folder_idx>``
columns, followed by three summary blocks: ``Avg_*`` (per-folder means),
``FolderAvg_*`` (mean of the folder means) and ``FrameAvg_*`` (mean over
all frames). Log lines and the CSV's layout are the JAX package's.

Temporal metrics:

- tOF = mean L2 norm of (flow(GT pair) - flow(output pair)), the flows
  centre-cropped by :func:`crop_8x8` (reference metrics.py:143-168). The
  flow is OpenCV's Farneback, computed in torch on ``device``
  (``eval/farneback.py``), from OpenCV's RGB -> grey conversion done in
  integers (``farneback.rgb_to_gray``);
- tLP100 = |LPIPS(GT_{t-1}, GT_t) - LPIPS(out_{t-1}, out_t)| * 100
  (reference metrics.py:194-200), on the torch :class:`LPIPS`.

Where the JAX package reads frames with ``cv2.imread`` and writes the CSV
with pandas, this module uses the port's PNG reader
(``data/inference.read_rgb``) and :func:`write_csv`, which writes what
``DataFrame.to_csv`` writes for these tables.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from tecogan_tpu_torch.data.inference import read_rgb
from tecogan_tpu_torch.eval.farneback import farneback_flow, rgb_to_gray
from tecogan_tpu_torch.eval.lpips import LPIPS
from tecogan_tpu_torch.eval.quality import crop_8x8, psnr, ssim
from tecogan_tpu_torch.ops.image import list_png_in_dir

__all__ = ["CUTFR", "evaluate_folders", "write_csv"]

CUTFR = 2  # boundary frames skipped (reference metrics.py:117,135)

# Stages timed by evaluate_folders(timings=...), in seconds summed over frames.
STAGES = ("read", "psnr_ssim", "farneback", "lpips")


def write_csv(path: str, columns: Mapping[str, np.ndarray], mode: str = "w") -> None:
    """``pd.DataFrame({name: pd.Series(values)}).to_csv(path, mode=mode)``
    for 1-D float columns: a header row led by an empty cell, an integer
    index, each cell numpy's shortest repr of the value in its column's
    dtype (``0.33333334`` for float32, ``inf``), and an empty cell where a
    column is shorter than the longest."""
    cols = {k: np.asarray(v) for k, v in columns.items()}
    rows = max((len(v) for v in cols.values()), default=0)
    text = {k: v.astype(str) for k, v in cols.items()}
    lines = [",".join(["", *cols])]
    for i in range(rows):
        cells = [str(i)]
        for k, v in cols.items():
            cells.append("" if i >= len(v) or np.isnan(v[i]) else text[k][i])
        lines.append(",".join(cells))
    with open(path, mode) as f:
        f.write("\n".join(lines) + "\n")


def _score_folder(
    res_dir: str,
    tar_dir: str,
    keys: Sequence[str],
    lpips_model: Optional[LPIPS],
    verbose: bool,
    device: torch.device,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Score one result/target folder pair: {key: float32 per-frame values}
    for frames [CUTFR, N - CUTFR); the temporal keys (tOF, tLP100) have one
    entry fewer. The per-frame log line is the reference's."""
    clock = dict.fromkeys(STAGES, 0.0) if timings is None else timings

    def lap(stage, t0):
        now = time.perf_counter()
        clock[stage] = clock.get(stage, 0.0) + now - t0
        return now

    result = list_png_in_dir(res_dir)
    target = list_png_in_dir(tar_dir)
    image_no = len(target)  # reference metrics.py:129
    if len(result) < len(target):
        print(f"[eval] {res_dir}: {len(result)} frames vs "
              f"{len(target)} targets; scoring the overlap")
        image_no = len(result)

    values: Dict[str, list] = {k: [] for k in keys}
    prev_grey = None      # (out_grey, tar_grey) for tOF
    prev_tensors = None   # (tar_tensor, out_tensor) for tLP100

    for i in range(CUTFR, image_no - CUTFR):
        t = time.perf_counter()
        output_img = read_rgb(result[i])
        target_img = read_rgb(target[i])
        t = lap("read", t)
        parts = [f"frame {i}", f"tar {target_img.shape}",
                 f"out {output_img.shape}"]
        if (target_img.shape[0] < output_img.shape[0]) or (
            target_img.shape[1] < output_img.shape[1]
        ):  # target not divisible by 4 (reference metrics.py:139-140)
            output_img = output_img[: target_img.shape[0], : target_img.shape[1]]

        if "tOF" in keys:
            greys = tuple(torch.from_numpy(rgb_to_gray(im)).to(device)
                          for im in (output_img, target_img))
            if prev_grey is not None:
                output_of = farneback_flow(prev_grey[0], greys[0]).cpu().numpy()
                target_of = farneback_flow(prev_grey[1], greys[1]).cpu().numpy()
                of_diff = crop_8x8(target_of)[0] - crop_8x8(output_of)[0]
                tof = np.sqrt(np.sum(np.square(of_diff), axis=-1)).mean()
                values["tOF"].append(tof)
                parts.append("tOF %02.2f" % tof)
            prev_grey = greys
            t = lap("farneback", t)

        target_img, ofy, ofx = crop_8x8(target_img)
        output_img, ofy, ofx = crop_8x8(output_img)

        if "PSNR" in keys:
            values["PSNR"].append(psnr(target_img, output_img))
            parts.append("psnr %02.2f" % values["PSNR"][-1])
        if "SSIM" in keys:
            values["SSIM"].append(ssim(target_img, output_img))
            parts.append("ssim %02.2f" % values["SSIM"][-1])
        t = lap("psnr_ssim", t)

        if "LPIPS" in keys or "tLP100" in keys:
            tensors = (LPIPS.im2tensor(target_img), LPIPS.im2tensor(output_img))
            if "LPIPS" in keys:
                d01 = lpips_model(*tensors).cpu().numpy()
                values["LPIPS"].append(float(d01[0]))
                parts.append("lpips %02.2f" % d01[0])
            if "tLP100" in keys and prev_tensors is not None:
                d_tar = lpips_model(prev_tensors[0], tensors[0]).cpu().numpy()
                d_out = lpips_model(prev_tensors[1], tensors[1]).cpu().numpy()
                tlp = np.absolute(d_tar - d_out) * 100.0
                values["tLP100"].append(float(tlp[0]))
                parts.append("tLPx100 %02.2f" % tlp[0])
            prev_tensors = tensors
            lap("lpips", t)

        parts.append("crop (%d, %d)" % (ofy, ofx))
        if verbose:
            print(", ".join(parts))

    return {k: np.float32(v) for k, v in values.items()}


def evaluate_folders(
    result_dirs: Sequence[str],
    target_dirs: Sequence[str],
    output_dir: str,
    keys: Optional[List[str]] = None,
    lpips_model: Optional[LPIPS] = None,
    verbose: bool = True,
    device: Union[str, torch.device, None] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Score each result folder against its target folder; write
    ``<output_dir>/metrics.csv``.

    Args:
      keys: subset of ["PSNR", "SSIM", "LPIPS", "tOF", "tLP100"]; the LPIPS
        keys are dropped when ``lpips_model`` is None.
      device: where the Farneback flows run (default: the LPIPS model's
        device, else the CPU).
      timings: if given, seconds are added to its ``read``, ``psnr_ssim``,
        ``farneback`` and ``lpips`` entries (each stage ends on the host, so
        the device's work is inside).

    Returns:
      {"FrameAvg_<key>": value} overall averages (reference metrics.py:231-236).
    """
    keys = list(keys or ["PSNR", "SSIM", "LPIPS", "tOF", "tLP100"])
    if lpips_model is None:
        dropped = [k for k in keys if k in ("LPIPS", "tLP100")]
        if dropped and verbose:
            print(f"[eval] no LPIPS weights available; skipping {dropped}")
        keys = [k for k in keys if k not in ("LPIPS", "tLP100")]
    if device is None:
        device = lpips_model.device if lpips_model is not None else "cpu"
    device = torch.device(device)

    os.makedirs(output_dir, exist_ok=True)
    csv_path = os.path.join(output_dir, "metrics.csv")

    folder_values: List[Dict[str, np.ndarray]] = []
    for folder_i, (res_dir, tar_dir) in enumerate(zip(result_dirs, target_dirs)):
        vals = _score_folder(res_dir, tar_dir, keys, lpips_model, verbose,
                             device, timings)
        folder_values.append(vals)
        block = {}
        for key in keys:
            col = f"{key}_%02d" % folder_i
            cur = vals[key]
            block[col] = cur
            if verbose:
                print("%s, max %02.4f, min %02.4f, avg %02.4f"
                      % (col, cur.max(), cur.min(), cur.sum() / cur.shape[0]))
        # The first folder starts the file; each later block appends with
        # its own header and index, the reference's CSV shape.
        write_csv(csv_path, block, mode="w" if folder_i == 0 else "a")

    # Summaries, in the JAX package's float32 order: python-float starts
    # are weak under NEP 50, sums left to right in folder order.
    folder_means = {
        k: [v[k].sum() / v[k].shape[0] for v in folder_values] for k in keys
    }
    total_frames = {k: sum(v[k].shape[0] for v in folder_values) for k in keys}
    frame_avg = {
        k: sum((v[k].sum() for v in folder_values), 0.0) / total_frames[k]
        for k in keys
    }
    folder_avg = {
        k: sum(folder_means[k], 0.0) / len(result_dirs) for k in keys
    }

    if verbose:
        for key in keys:
            print("%s, total frame %d, total avg %02.4f, folder avg %02.4f"
                  % (key, total_frames[key], frame_avg[key], folder_avg[key]))

    write_csv(csv_path, {"Avg_" + k: np.float32(folder_means[k]) for k in keys}, "a")
    write_csv(csv_path, {"FolderAvg_" + k: np.asarray([folder_avg[k]]) for k in keys}, "a")
    write_csv(csv_path, {"FrameAvg_" + k: np.asarray([frame_avg[k]]) for k in keys}, "a")
    if verbose:
        print("Finished.")
    return {"FrameAvg_" + k: float(frame_avg[k]) for k in keys}
