"""The device trace of a traced run, reduced to what the per-layer readers
need: the traced window, the device's busy time (the union of every
operation's interval, so overlapping kernels count once), the same union
per group of kernels, the time of each kernel by name, the chain kernel's
launches, and the longest idle gaps named by the host op under them.

The grouping is the one ``chip_smoke.py`` uses (a kernel goes to the first
group one of whose needles is in its name); copies and fills are a group
of their own, and what is left is the glue.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import torch

GROUPS = {
    "chain": ("resblock_kernel",),
    "k2": ("upsample4_bwd_kernel",),
    "k1": ("upsample4_kernel",),
    "library": ("conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad", "cutlass", "sm90"),
    "adam": ("multi_tensor", "adam"),
    "copies": ("memcpy", "memset"),
}
GLUE = "glue"
HARNESS_SPAN = "portbench."


def group_of(name: str) -> str:
    key = name.lower()
    return next((g for g, needles in GROUPS.items() if any(n in key for n in needles)), GLUE)


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6


def _gaps(spans: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between the union of ``spans``."""
    out, cursor = [], lo
    for s, e in sorted(spans):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(prof, window_s: float, lo_us: float, hi_us: float) -> Dict:
    """The reduction of a ``torch.profiler.profile`` over a window whose
    host clock length is ``window_s``; ``lo_us``/``hi_us`` bound it on the
    profiler's clock."""
    from torch.autograd import DeviceType

    spans: Dict[str, List[Tuple[float, float]]] = {g: [] for g in [*GROUPS, GLUE]}
    kernels: Dict[str, List[float]] = {}
    chain: List[float] = []
    host: List[Tuple[float, float, str]] = []
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False):
                continue
            g = group_of(evt.name)
            spans[g].append((s, e))
            kernels.setdefault(evt.name, [0, 0.0])
            kernels[evt.name][0] += 1
            kernels[evt.name][1] += (e - s) * 1e-6
            if g == "chain":
                chain.append((e - s) * 1e-6)
        else:
            host.append((s, e, evt.name))
    every = [iv for group in spans.values() for iv in group]
    busy = union_s(every)
    gaps = sorted(_gaps(every, lo_us, hi_us), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        # What the host was doing: the shortest host op that covers the
        # gap's middle (the most specific), else the one overlapping most.
        mid, best, best_key = (a + b) / 2, "host", None
        for s, e, name in host:
            overlap = min(b, e) - max(a, s)
            if overlap <= 0:
                continue
            key = (s <= mid <= e, -(e - s) if s <= mid <= e else overlap)
            if best_key is None or key > best_key:
                best, best_key = name, key
        named.append([best, (b - a) * 1e-6])
    ops = sorted(([n, v[1]] for n, v in kernels.items()), key=lambda x: -x[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy,
        "groups_s": {g: union_s(s) for g, s in spans.items()},
        "kernels": kernels,
        "chain_s": chain,
        "breakdown": {"device_ops": ops, "idle_gaps": named},
    }


class Tracer:
    """Profiles the device from :meth:`start` to :meth:`stop`; both wait for
    the device, so the window holds whole work. Disabled, it does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[Dict] = None
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        with torch.profiler.record_function("portbench.trace_start"):
            pass
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        with torch.profiler.record_function("portbench.trace_stop"):
            pass
        self._prof.__exit__(None, None, None)
        marks = {e.name: e.time_range.start for e in self._prof.events()
                 if e.name in ("portbench.trace_start", "portbench.trace_stop")}
        lo = marks.get("portbench.trace_start", 0.0)
        hi = marks.get("portbench.trace_stop", lo + window_s * 1e6)
        self.summary = summarize(self._prof, window_s, lo, hi)
        self._prof = None


def span(name: str):
    """A harness span around a call into a layer, seen in the trace."""
    return torch.profiler.record_function(HARNESS_SPAN + name)
