"""One run of one cell: set-up, the measured window, the per-layer readers
on a traced run, the correctness check, and the result line.

A cell's module (``traffic/<kind>.py``) defines ``Cell(config, traffic,
seed, device, chips)`` with:

- ``setup()``: weights, program, inputs, warm-up of every shape the
  window uses; ends just before the window's first timed item;
- ``window(seconds, tracer)``: the measured window; sets ``end_to_end``
  (name -> value), ``attempted`` and ``failed``; starts and stops the
  tracer around the items it traces;
- ``counters()``: the program's counters and the harness's spans, for the
  per-layer readers, which also get the cell itself (``ctx["cell"]``) and
  so reach every counter of the program it holds;
- ``release()``: frees the program's state;
- ``check()``: the comparison with the plain reference, a list of
  :class:`Check`.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "tecogan_tpu")


class Check(NamedTuple):
    """One number compared with its limit: correct when ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``tecogan_tpu_torch`` is not ``tecogan_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (10 ms steps)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(chips: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(torch.device("cuda", i))
                                         for i in range(chips)))}


def run_cell(manifest, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             traffic_overrides: Optional[Dict] = None) -> Dict:
    """Run one cell once and return the result (with ``checks`` last).
    ``device="cpu"`` is for the tests: it skips the look for a card."""
    import torch

    from portbench.harness.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    cell_spec = manifest.workload(workload)
    config = manifest.config(cell_spec["config"])
    traffic = dict(manifest.traffic(cell_spec["traffic"]), **(traffic_overrides or {}))
    chips = int(cell_spec["chips"])
    cell = manifest.kind(traffic["kind"]).Cell(config, traffic, seed, torch.device(device), chips)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        for i in range(chips):
            torch.cuda.reset_peak_memory_stats(torch.device("cuda", i))
    cell.setup()
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(trace and on_card)
    cell.window(seconds, tracer)
    result: Dict = {"correct": False, "attempted": int(cell.attempted),
                    "failed": int(cell.failed)}
    metrics = {}
    if trace:
        ctx = {"trace": tracer.summary, "counters": cell.counters(), "config": config,
               "traffic": traffic, "workload": cell_spec, "cell": cell}
        for spec in manifest.per_layer(workload):
            value = manifest.reader(spec["name"])(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    else:
        values = dict(cell.end_to_end, setup_s=setup_s)
        for spec in manifest.end_to_end(workload):
            if spec["name"] in values:
                metrics[spec["name"]] = {"value": float(values[spec["name"]]),
                                         "unit": spec["unit"]}
    result["metrics"] = metrics
    if on_card:
        result["device"] = device_info(chips)
        if tracer.summary is not None:
            result["device"]["busy_s"] = tracer.summary["busy_s"]
            result["device"]["window_s"] = tracer.summary["window_s"]
            result["breakdown"] = tracer.summary["breakdown"]
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = cell.check()
    result["correct"] = bool(checks) and all(c.ok for c in checks) and cell.failed == 0
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench.harness.manifest import ROOT, Manifest

    set_cache_dirs(ROOT)
    manifest = Manifest()
    chips = int(manifest.workload(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}; "
              "no result", file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
