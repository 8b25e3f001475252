"""The knee of a live serving cell, by a sweep over the number of streams:

    python3 portbench/sweep_serve.py --workload serve_1080p_live --streams 2,4,6,8 \
        [--seconds 10] [--seed 1] [--limit-ms 100]

For each K the cell's traffic runs with K streams (and a pool of K slots)
for ``--seconds``, as ``run.py`` runs it, and one JSON line gives the p50
and p95 latency, the ticks' fill, and whether the backlog grew: the
lateness of the frames due in the window's last fifth against its first
fifth (a lateness that keeps growing is a queue that never drains). The
knee K* is the most streams whose backlog does not grow and whose p95 is
within ``--limit-ms``; the cell runs floor(0.8 K*), at least 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="serve_1080p_live")
    parser.add_argument("--streams", default="2,4,6,8")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--limit-ms", type=float, default=100.0)
    args = parser.parse_args(argv)

    from portbench.harness.manifest import ROOT, Manifest
    from portbench.harness.runner import set_cache_dirs

    set_cache_dirs(ROOT)
    import numpy as np
    import torch

    from portbench.harness.trace import Tracer

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest()
    spec = manifest.workload(args.workload)
    config = manifest.config(spec["config"])
    base = manifest.traffic(spec["traffic"])
    kind = manifest.kind(base["kind"])
    knee = 0
    for k in (int(s) for s in args.streams.split(",")):
        traffic = dict(base, streams=k)
        cell = kind.Cell(config, traffic, args.seed, torch.device("cuda"), 1)
        cell.setup()
        cell.window(args.seconds, Tracer(False))
        lat = cell.latencies * 1e3
        # Latencies are in the order frames were served, which is the
        # order they were due in: the first and the last fifth.
        fifth = max(1, len(lat) // 5)
        early, late = float(np.mean(lat[:fifth])), float(np.mean(lat[-fifth:]))
        grows = late > 1.5 * early + 1000.0 / traffic["fps"]
        p95 = float(np.percentile(lat, 95))
        fill = sum(f for f, _ in cell.ticks) / (len(cell.ticks) * k) * 100.0
        ok = not grows and p95 <= args.limit_ms and cell.failed == 0
        if ok:
            knee = k
        print(json.dumps({"streams": k, "p50_ms": float(np.percentile(lat, 50)), "p95_ms": p95,
                          "ticks": len(cell.ticks), "fill_pct": fill, "early_ms": early,
                          "late_ms": late, "backlog_grows": grows, "failed": cell.failed,
                          "sustained": ok, "device": torch.cuda.get_device_name(0)}),
              flush=True)
        cell.release()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"knee_streams": knee, "cell_streams": max(1, math.floor(0.8 * knee))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
