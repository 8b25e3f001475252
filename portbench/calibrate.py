"""The readings a cell's correctness limits are set from, on the card, in
one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2] [--out FILE]

For each seed of ``--seeds`` the cell runs as ``run.py`` runs it (set-up, a
short window, release) and its check's numbers are printed: the program's
readings, from which the lower reading is taken. For each seed of
``--control-seeds`` the control is read in the program's place:

- a streaming or serving cell (bfloat16): the plain reference computed in
  fp8 (each convolution's inputs and weights rounded to float8 e4m3 with a
  per-tensor scale), at the same frames;
- a training cell (float32 with TF32): the program's own bfloat16 path
  (``compute_dtype="bfloat16"``) through the same three steps.

For a training cell ``--fault-seeds`` also reads the fault of half the
batch left out (the loss's mean taken over the rest), planted in the
program's batch preparation. Every reading is one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _numbers(checks):
    return {c.name: c.value for c in checks}


def _cell(manifest, workload, seed, config_overrides=None):
    import torch

    spec = manifest.workload(workload)
    config = dict(manifest.config(spec["config"]), **(config_overrides or {}))
    traffic = manifest.traffic(spec["traffic"])
    return manifest.kind(traffic["kind"]).Cell(config, traffic, seed, torch.device("cuda"),
                                               int(spec["chips"]))


def _run(manifest, workload, seed, seconds, config_overrides=None, control=False):
    import torch

    from portbench.harness.trace import Tracer

    cell = _cell(manifest, workload, seed, config_overrides)
    cell.setup()
    cell.window(seconds, Tracer(False))
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    if control:  # the fp8 reference in the program's place
        checks = cell.check(got=cell.reference("fp8"))
    else:
        checks = cell.check()
    nums = _numbers(checks)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def _half_batch():
    """Plant the fault: the trainer prepares only the first half of each batch."""
    from tecogan_tpu_torch.train import trainer as T

    original = T.prepare_batch

    def half(hr_seq, config):
        return original(hr_seq[: hr_seq.shape[0] // 2], config)

    T.prepare_batch = half
    return lambda: setattr(T, "prepare_batch", original)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    from portbench.harness.manifest import ROOT, Manifest
    from portbench.harness.runner import set_cache_dirs

    set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest()
    kind = manifest.traffic(manifest.workload(args.workload)["traffic"])["kind"]
    out = open(args.out, "a") if args.out else None

    def emit(role, seed, nums, t0):
        line = json.dumps({"workload": args.workload, "role": role, "seed": seed,
                           "numbers": nums, "s": round(time.perf_counter() - t0, 2),
                           "device": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        emit("program", seed, _run(manifest, args.workload, seed, args.seconds), t0)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        if kind == "train":
            nums = _run(manifest, args.workload, seed, args.seconds,
                        config_overrides={"compute_dtype": "bfloat16"})
        else:
            nums = _run(manifest, args.workload, seed, args.seconds, control=True)
        emit("control", seed, nums, t0)
    for seed in (int(s) for s in args.fault_seeds.split(",") if s):
        t0 = time.perf_counter()
        undo = _half_batch()
        try:
            nums = _run(manifest, args.workload, seed, args.seconds)
        finally:
            undo()
        emit("fault_half_batch", seed, nums, t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
