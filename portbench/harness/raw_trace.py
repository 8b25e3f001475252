"""A traced window read from the profiler's raw events: ``trace.Tracer``'s
window, profiler and summary (``trace.summarize``), without the profiler's
own Python post-processing of every event (its ``events()``), which a
TecoGAN step's ~17,800 kernels make the slow part of a traced run."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

from portbench.harness.trace import Tracer


class _Range(NamedTuple):
    start: float
    end: float


class _Event(NamedTuple):
    name: str
    device_type: object
    time_range: _Range
    is_user_annotation: bool


def raw_events(prof) -> List[_Event]:
    """The events of a finished ``torch.profiler.profile`` as
    ``trace.summarize`` reads them (``name``, ``device_type``,
    ``time_range`` in us from the trace's start, ``is_user_annotation``),
    with the names, the filter and the order of the profiler's own
    ``events()``, taken straight from its results. ``events()`` builds a
    full Python event with its parents and children for each: on an H100,
    10 TecoGAN steps (182,301 events) took it 11.2 s, and this 2.4 s. The
    device's events are the same; of the host's, this
    keeps the ops that ``events()`` folds into a parent of the same name
    and no other child (``aten::sum`` inside ``aten::sum``), which name an
    idle gap as their parent does."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    names: Dict[str, str] = {}
    out = []
    for e in result.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(raw, with_wildcard=True)
        out.append(_Event(name, e.device_type(),
                          _Range((e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000),
                          e.is_user_annotation()))
    out.sort(key=lambda ev: (ev.time_range.start, -ev.time_range.end))
    return out


class _Finished:
    """A running profile whose ``events()``, once it has exited, are
    :func:`raw_events`."""

    def __init__(self, prof):
        self.prof = prof
        self._events: Optional[List[_Event]] = None

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self) -> List[_Event]:
        if self._events is None:
            self._events = raw_events(self.prof)
        return self._events


class RawTracer(Tracer):
    """``trace.Tracer`` (the same window, profiler and summary) reading the
    profile's events through :func:`raw_events`."""

    def stop(self) -> None:
        if self._prof is not None:
            self._prof = _Finished(self._prof)
        super().stop()
