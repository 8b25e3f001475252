"""Metrics CLI of the port (counterpart of ``tecogan_tpu/cli/metrics.py``;
reference metrics.py:9-15 flag surface):

    python -m tecogan_tpu_torch.cli.metrics --output <dir> \\
        --results <dir1,dir2,...> --targets <dir1,dir2,...> --device cuda

Writes ``metrics.csv`` and the log tee ``metricsfile.txt`` in the
reference's format through :mod:`tecogan_tpu_torch.eval.suite`. The
Farneback flows (tOF) and LPIPS run on ``--device`` (default ``cuda``; a
CUDA device that is not there raises, there is no fallback); LPIPS and
tLP100 are skipped unless its weights are found (``eval.lpips.default_lpips``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Run the CLI; returns the FrameAvg values."""
    p = argparse.ArgumentParser("tecogan_tpu_torch.cli.metrics")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--results", required=True,
                   help="comma-separated result directories")
    p.add_argument("--targets", required=True,
                   help="comma-separated target (GT) directories")
    p.add_argument("--lpips_backbone", default=None,
                   help="AlexNet backbone weights (.pth/.npz) for LPIPS")
    p.add_argument("--device", default="cuda",
                   help="torch device for the flows and LPIPS, e.g. cuda, cpu")
    args = p.parse_args(argv)

    from tecogan_tpu_torch.cli.main import resolve_device
    from tecogan_tpu_torch.eval import default_lpips, evaluate_folders
    from tecogan_tpu_torch.utils.logging import Tee

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    tee = Tee(os.path.join(args.output, "metricsfile.txt")).install()
    try:
        print("[Configurations]:")
        for k, v in sorted(vars(args).items()):
            print(f"\t{k}: {v}")
        print("End of configuration")
        return evaluate_folders(
            args.results.split(","),
            args.targets.split(","),
            args.output,
            lpips_model=default_lpips(backbone_path=args.lpips_backbone, device=device),
            device=device,
        )
    finally:
        tee.uninstall()


if __name__ == "__main__":
    main()
