"""Run-case orchestration CLI (counterpart of ``tecogan_tpu/cli/run.py``;
reference runGan.py).

    python -m tecogan_tpu_torch.cli.run <case> [--root DIR] [options]

Cases mirror reference runGan.py:19-296:
  0  download pretrained models + Vid4/ToS test data (network-gated)
  1  inference on the test scenes with the pretrained model
  2  metric evaluation -> results/metric_log/metrics.csv
  3  full TecoGAN adversarial training
  4  FRVSR training

Training cases wrap the trainer in the same SIGINT-safe pattern as the
reference (runGan.py:237-244: Ctrl-C reaches the trainer, which saves a
final checkpoint) and prompt before reusing a non-empty output folder
(``folder_check``, runGan.py:25-39).

Every option this CLI does not know goes on to the children, which run
``python -m tecogan_tpu_torch.cli.main``: ``--device`` among them (default
``cuda``; ``--device cpu`` for a CPU smoke). Case 2 scores on that device
too. Case 0 downloads nothing without ``--allow_network``.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys

PRETRAINED_URLS = [
    # (url, unzip_dir) — reference runGan.py:41-65
    ("https://ge.in.tum.de/download/data/TecoGAN/model.zip", "model"),
    ("https://ge.in.tum.de/download/data/TecoGAN/vid3_LR.zip", "LR"),
    ("https://ge.in.tum.de/download/data/TecoGAN/tos_LR.zip", "LR"),
    ("https://ge.in.tum.de/download/data/TecoGAN/vid4_HR.zip", "HR"),
    ("https://ge.in.tum.de/download/data/TecoGAN/tos_HR.zip", "HR"),
    # Training dependencies of case 3 (reference fetches them lazily inside
    # the case, runGan.py:113-121,128-134; listed here so one case-0 run
    # documents the complete layout):
    # TF-slim VGG19 classification checkpoint -> model/vgg_19.ckpt
    ("http://download.tensorflow.org/models/vgg_19_2016_08_28.tar.gz",
     "model"),
    # published pretrained FRVSR -> model/ourFRVSR.*
    ("http://ge.in.tum.de/download/2019-TecoGAN/FRVSR_Ours.zip", "model"),
]

# TF checkpoints this framework consumes after npz conversion (case 0
# prints the recipe; case 3 auto-wires them when present).
VGG_NPZ = os.path.join("model", "vgg_19.npz")
FRVSR_NPZ = os.path.join("model", "ourFRVSR.npz")


def _print_npz_recipe(ckpt: str, npz: str) -> None:
    print(f"  (with any TF install) convert {ckpt} -> {npz}:")
    print(f"    reader = tf.train.load_checkpoint('{ckpt}')")
    print(f"    np.savez('{npz}', **{{n: reader.get_tensor(n)")
    print("        for n in reader.get_variable_to_shape_map()})")


def folder_check(path: str) -> str:
    """Prompt before writing into an existing non-empty folder
    (reference runGan.py:25-39)."""
    try_num = 1
    oripath = path.rstrip("/")
    while os.path.exists(path) and os.listdir(path):
        print(f"Delete {path} or Rename the folder")
        ans = input(f"Output folder {path} exists, keep using it? (y/n): ")
        if ans.lower().startswith("y"):
            return path
        path = f"{oripath}_{try_num}/"
        try_num += 1
    return path


def case0(root: str, allow_network: bool) -> None:
    """Download models + data; offline-safe (prints instructions instead)."""
    if not allow_network:
        print("Network downloads disabled (no egress in this environment).")
        print("To populate the data layout, fetch these into", root, ":")
        for url, d in PRETRAINED_URLS:
            print(f"  {url} -> extract into {os.path.join(root, d)}/")
        print("Then convert the TF checkpoints for this framework:")
        _print_npz_recipe("model/TecoGAN", "model/TecoGAN.npz")
        print("For training case 3 (reference runGan.py:113-121,128-134):")
        _print_npz_recipe("model/vgg_19.ckpt", VGG_NPZ)
        _print_npz_recipe("model/ourFRVSR", FRVSR_NPZ)
        return
    for url, d in PRETRAINED_URLS:
        dest = os.path.join(root, d)
        os.makedirs(dest, exist_ok=True)
        zpath = os.path.join(dest, os.path.basename(url))
        unpack = ("tar -xvf {z} -C {d}" if url.endswith(".tar.gz")
                  else "unzip {z} -d {d}").format(z=zpath, d=dest)
        subprocess.call(f"wget {url} -O {zpath}; {unpack}; rm {zpath}",
                        shell=True)
    print("Downloads done. Convert the TF checkpoints to npz:")
    _print_npz_recipe("model/TecoGAN", "model/TecoGAN.npz")
    _print_npz_recipe("model/vgg_19.ckpt", VGG_NPZ)
    _print_npz_recipe("model/ourFRVSR", FRVSR_NPZ)


def case1(root: str, scenes, extra) -> int:
    """Returns the max inference-subprocess return code (reference runGan.py
    ignores child failures; the parity gate must not)."""
    rc_max = 0
    dirstr = os.path.join(root, "results")
    os.makedirs(dirstr, exist_ok=True)
    model_npz = os.path.join(root, "model", "TecoGAN.npz")
    for scene in scenes:
        cmd = [
            sys.executable, "-m", "tecogan_tpu_torch.cli.main",
            "--mode", "inference",
            "--output_dir", dirstr,
            "--summary_dir", os.path.join(dirstr, "log"),
            "--input_dir_LR", os.path.join(root, "LR", scene),
            "--output_pre", scene,
            "--output_name", "output",
            "--num_resblock", "16",
            "--output_ext", "png",
        ]
        if os.path.exists(model_npz):
            cmd += ["--tf_npz", model_npz]
        else:
            print(f"note: {model_npz} missing -> random-weight smoke run "
                  "(run case 0 for instructions)")
            cmd += ["--allow_random_weights"]
        cmd += extra
        rc = subprocess.call(cmd)
        if rc != 0:  # negative rc = killed by signal — still a failure
            print(f"case1: inference subprocess for {scene} exited rc={rc}")
            rc_max = max(rc_max, abs(rc))
    return rc_max


def _device(extra) -> str:
    """The ``--device`` among the children's options (default ``cuda``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    return p.parse_known_args(extra)[0].device


def case2(root: str, scenes, extra) -> None:
    from tecogan_tpu_torch.cli.main import resolve_device
    from tecogan_tpu_torch.eval import default_lpips, evaluate_folders
    from tecogan_tpu_torch.utils.logging import Tee

    device = resolve_device(_device(extra))
    dirstr = os.path.join(root, "results")
    out = os.path.join(dirstr, "metric_log")
    os.makedirs(out, exist_ok=True)
    tee = Tee(os.path.join(out, "metricsfile.txt")).install()
    try:
        evaluate_folders(
            [os.path.join(dirstr, s) for s in scenes],
            [os.path.join(root, "HR", s) for s in scenes],
            out,
            lpips_model=default_lpips(device=device),
            device=device,
        )
    finally:
        tee.uninstall()


def read_frameavg_csv(csv_path: str) -> dict:
    """Extract the FrameAvg_* summary block from a metrics.csv written by
    either this framework's eval suite or the reference's metrics.py
    (identical stacked-block layout, reference metrics.py:231-236)."""
    out = {}
    with open(csv_path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    for i, ln in enumerate(lines):
        if "FrameAvg_" in ln and i + 1 < len(lines):
            cols = ln.split(",")
            vals = lines[i + 1].split(",")
            for c, v in zip(cols, vals):
                if c.startswith("FrameAvg_") and v:
                    out[c] = float(v)
    return out


def compare_parity(ours: dict, ref: dict,
                   psnr_tol: float = 0.1, tof_rtol: float = 0.02) -> bool:
    """North-star gate (BASELINE.md): PSNR within ``psnr_tol`` dB and tOF
    within ``tof_rtol`` of the reference implementation's numbers.

    A reference dict with NO comparable keys fails: a gate that compared
    nothing must not report PASS (malformed/wrong --ref_csv)."""
    if not any(k in ref for k in ("FrameAvg_PSNR", "FrameAvg_tOF")):
        print("PARITY: reference CSV has no FrameAvg_PSNR/FrameAvg_tOF "
              "block — wrong or malformed metrics.csv; nothing compared")
        return False
    ok = True
    if "FrameAvg_PSNR" in ref:
        d = ours["FrameAvg_PSNR"] - ref["FrameAvg_PSNR"]
        line_ok = abs(d) <= psnr_tol
        ok &= line_ok
        print(f"PSNR: ours {ours['FrameAvg_PSNR']:.4f} vs ref "
              f"{ref['FrameAvg_PSNR']:.4f} (delta {d:+.4f} dB, tol "
              f"{psnr_tol}) -> {'PASS' if line_ok else 'FAIL'}")
    if "FrameAvg_tOF" in ref:
        r = abs(ours["FrameAvg_tOF"] - ref["FrameAvg_tOF"]) / ref["FrameAvg_tOF"]
        line_ok = r <= tof_rtol
        ok &= line_ok
        print(f"tOF: ours {ours['FrameAvg_tOF']:.4f} vs ref "
              f"{ref['FrameAvg_tOF']:.4f} (rel {r:.4f}, tol {tof_rtol}) "
              f"-> {'PASS' if line_ok else 'FAIL'}")
    return ok


def case_parity(root: str, scenes, extra, ref_csv=None) -> int:
    """One-command pretrained-parity gate (BASELINE.md north star; VERDICT
    r2 #5): with ``model/TecoGAN.npz`` dropped in place (case 0 prints the
    conversion recipe), runs inference -> metrics and compares FrameAvg
    PSNR/tOF against the reference implementation's metrics.csv.

    ``ref_csv``: a metrics.csv produced by the reference's metrics.py on its
    own case-1 outputs (same scenes). Defaults to ``<root>/ref_metrics.csv``
    if present; without one, prints our numbers and the recipe.
    """
    model_npz = os.path.join(root, "model", "TecoGAN.npz")
    if not os.path.exists(model_npz):
        print(f"parity gate needs {model_npz}; run "
              "`python -m tecogan_tpu_torch.cli.run 0` for the conversion recipe")
        return 2
    rc = case1(root, scenes, extra)
    if rc != 0:
        print(f"PARITY GATE: INCONCLUSIVE (inference failed, rc={rc}); "
              "results/ may hold stale frames — not evaluating them")
        return 2
    from tecogan_tpu_torch.cli.main import resolve_device
    from tecogan_tpu_torch.eval import evaluate_folders

    dirstr = os.path.join(root, "results")
    out = os.path.join(dirstr, "metric_log")
    ours = evaluate_folders(
        [os.path.join(dirstr, s) for s in scenes],
        [os.path.join(root, "HR", s) for s in scenes],
        out, keys=["PSNR", "tOF"], verbose=False,
        device=resolve_device(_device(extra)),
    )
    ref_csv = ref_csv or os.path.join(root, "ref_metrics.csv")
    if not os.path.exists(ref_csv):
        print(f"ours: PSNR {ours['FrameAvg_PSNR']:.4f}, "
              f"tOF {ours['FrameAvg_tOF']:.4f}")
        print(f"no {ref_csv}: run the reference's `runGan.py 1; runGan.py 2` "
              "on the same scenes and place its metrics.csv there to close "
              "the gate")
        return 2
    ok = compare_parity(ours, read_frameavg_csv(ref_csv))
    print("PARITY GATE:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _find_frvsr_weights(root: str):
    """Locate FRVSR weights for the case-3 warm start: the converted
    published model (``model/ourFRVSR.npz``, reference runGan.py:128-134)
    or, failing that, the newest case-4 run's checkpoints
    (``ex_FRVSR*/checkpoints``, the reference's documented alternative
    'FRVSRModel = ex_FRVSRmm-dd-hh/model-500000', runGan.py:126-127)."""
    from tecogan_tpu_torch.train.checkpoint import latest_step

    npz = os.path.join(root, FRVSR_NPZ)
    if os.path.exists(npz):
        return npz
    cands = [os.path.join(d, "checkpoints")
             for d in glob.glob(os.path.join(root, "ex_FRVSR*"))]
    cands = [c for c in cands if os.path.isdir(c)]
    for ck in sorted(cands, key=os.path.getmtime, reverse=True):
        if latest_step(ck) is not None:
            return ck
    return None


def _case3_chain_flags(root: str, extra, from_scratch: bool):
    """The canonical case-3 wiring (reference runGan.py:107-244): VGG19
    weights for the perceptual loss and the pretrained FRVSR warm start are
    auto-passed when their converted files are present, and the case refuses
    with instructions when not — mirroring the reference, which downloads
    both before launching training (runGan.py:113-121,128-134).

    Returns the extra flags, or None to refuse (instructions printed).
    """
    flags = []
    if "--vgg_npz" not in extra and "--vgg_scaling" not in extra:
        vgg = os.path.join(root, VGG_NPZ)
        if os.path.exists(vgg):
            flags += ["--vgg_npz", vgg]
            print(f"case 3: VGG19 perceptual weights <- {vgg}")
        elif "--allow_random_weights" not in extra:
            print(f"case 3 needs {vgg} (the reference downloads vgg_19.ckpt "
                  "here, runGan.py:113-121; no egress in this environment):")
            print("  fetch http://download.tensorflow.org/models/"
                  "vgg_19_2016_08_28.tar.gz, extract into model/")
            _print_npz_recipe("model/vgg_19.ckpt", VGG_NPZ)
            print("or pass --allow_random_weights for an untrained "
                  "perceptual term (smoke runs only).")
            return None
    if (not from_scratch and "--pre_trained_dir" not in extra
            and "--checkpoint" not in extra):
        src = _find_frvsr_weights(root)
        if src is None:
            print("case 3 warm-starts from an FRVSR model (reference "
                  "runGan.py:128-134,200-203). None found — either:")
            print(f"  fetch http://ge.in.tum.de/download/2019-TecoGAN/"
                  f"FRVSR_Ours.zip, extract into {os.path.join(root, 'model')}/")
            _print_npz_recipe("model/ourFRVSR", FRVSR_NPZ)
            print("  or train one: python -m tecogan_tpu_torch.cli.run 4")
            print("  or pass --from_scratch to skip the warm start.")
            return None
        flags += ["--pre_trained_dir", src]
        print(f"case 3: FRVSR warm start <- {src}")
    return flags


def _train_case(root: str, preset: str, output_name: str, extra,
                from_scratch: bool = False) -> int:
    if preset == "tecogan":
        chain = _case3_chain_flags(root, extra, from_scratch)
        if chain is None:
            return 2
        extra = chain + list(extra)
    train_dir = folder_check(os.path.join(root, output_name))
    cmd = [
        sys.executable, "-m", "tecogan_tpu_torch.cli.main",
        "--mode", "train",
        "--preset", preset,
        "--output_dir", train_dir,
        "--summary_dir", os.path.join(train_dir, "log"),
        "--input_video_dir", os.path.join(root, "TrainingDataPath"),
    ] + extra
    try:
        return subprocess.call(cmd)
    except KeyboardInterrupt:
        return 0  # trainer saves its own final checkpoint (main.py:423-429)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("tecogan_tpu_torch.cli.run")
    p.add_argument("case", choices=["0", "1", "2", "3", "4", "parity"],
                   help="0-4 mirror reference runGan.py; 'parity' = the "
                        "one-command pretrained-parity gate (case 1 -> 2 -> "
                        "compare vs the reference's metrics.csv)")
    p.add_argument("--root", default=".", help="data/model/results root")
    p.add_argument("--scenes", default="calendar",
                   help="comma-separated test scene names")
    p.add_argument("--allow_network", action="store_true")
    p.add_argument("--ref_csv", default=None,
                   help="reference metrics.csv for the parity gate")
    p.add_argument("--from_scratch", action="store_true",
                   help="case 3: skip the canonical FRVSR warm start "
                        "(reference runGan.py:128-134) and train from init")
    args, extra = p.parse_known_args(argv)
    scenes = args.scenes.split(",")

    if args.case == "parity":
        raise SystemExit(case_parity(args.root, scenes, extra, args.ref_csv))
    case = int(args.case)
    if case == 0:
        case0(args.root, args.allow_network)
    elif case == 1:
        raise SystemExit(case1(args.root, scenes, extra))
    elif case == 2:
        case2(args.root, scenes, extra)
    elif case == 3:
        raise SystemExit(_train_case(args.root, "tecogan",
                                     "ex_TecoGANmm-dd-hh", extra,
                                     from_scratch=args.from_scratch))
    elif case == 4:
        raise SystemExit(_train_case(args.root, "frvsr",
                                     "ex_FRVSRmm-dd-hh", extra))


if __name__ == "__main__":
    main()
