"""The arithmetic of the per-layer readers (``portbench/metrics/*.py``),
from the traced window's summary (``harness/trace.py``) and the cell's
counters. Each returns None where it finds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.harness.flops import chain_launch_bound, peak_flops


def counter(ctx: Dict, name: str) -> Optional[float]:
    value = ctx["counters"].get(name)
    return None if value is None else float(value)


def idle_pct(ctx: Dict) -> Optional[float]:
    """The traced window's share in which no operation ran on the device."""
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return (tr["window_s"] - tr["busy_s"]) / tr["window_s"] * 100.0


def glue_pct(ctx: Dict) -> Optional[float]:
    """Device time of the glue (every kernel outside the port's kernels,
    cuDNN/cuBLAS, Adam and copies) over the device's busy time."""
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return tr["groups_s"]["glue"] / tr["busy_s"] * 100.0


def device_ms_per(ctx: Dict, items: str) -> Optional[float]:
    """Device busy time over the traced window's frames or steps."""
    tr, n = ctx["trace"], ctx["counters"].get(items)
    if not tr or not n:
        return None
    return tr["busy_s"] * 1e3 / n


def mfu_pct(ctx: Dict) -> Optional[float]:
    """The model's FLOPs in the traced window over the window, against the
    tensor cores' peak for the configuration's dtype."""
    tr, flops = ctx["trace"], ctx["counters"].get("model_flops")
    if not tr or not flops or tr["window_s"] <= 0:
        return None
    peak = peak_flops(ctx["counters"]["compute_dtype"])
    return flops / tr["window_s"] / peak * 100.0


def chain_roofline_pct(ctx: Dict) -> Optional[float]:
    """Each chain launch's bound over its profiled time, summed over the
    launches: every launch of a cell is one residual block on the cell's
    chain shape."""
    tr = ctx["trace"]
    if not tr or not tr["chain_s"]:
        return None
    c = ctx["counters"]
    bound, _ = chain_launch_bound(c["chain_shape"], c["chain_itemsize"], c["compute_dtype"])
    return bound * len(tr["chain_s"]) / sum(tr["chain_s"]) * 100.0
