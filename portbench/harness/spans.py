"""The arithmetic of the per-layer readers that read the port's own spans
(``tecogan_tpu_torch/utils/profiling.py:span``). The port records a span
only while a profiler runs on the thread that opens it, so its records are
those of the traced window: each with its name, its start and end on the
profiler's clock, the ``id`` of the span around it (``parent``), its item
(the clip, tick or step) and its attributes. Each function returns None
where the program recorded no such span: a program without spans, or a cell
that does not cross that boundary."""

from __future__ import annotations

from typing import Callable, List, Optional


def records() -> List:
    """The port's span records, or none where the port keeps none."""
    from tecogan_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return [] if read is None else list(read())


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def mean_ms(name: str) -> Optional[float]:
    """Mean milliseconds of the ``name`` spans."""
    return _mean([_ms(r) for r in records() if r.name == name])


def self_ms(root: str, excluded: Callable[[str], bool]) -> Optional[float]:
    """Mean milliseconds of the ``root`` spans, each less the spans inside
    it whose name ``excluded`` accepts (an excluded span inside another is
    counted once, with the outer one)."""
    recs = records()
    by_id = {r.id: r for r in recs}
    left = {r.id: _ms(r) for r in recs if r.name == root}
    for r in recs:
        if r.name == root or not excluded(r.name):
            continue
        up = by_id.get(r.parent)
        while up is not None and up.name != root and not excluded(up.name):
            up = by_id.get(up.parent)
        if up is not None and up.id in left:
            left[up.id] -= _ms(r)
    return _mean(list(left.values()))


def sum_per_item_ms(name: str, per: str) -> Optional[float]:
    """Milliseconds of the ``name`` spans summed over the items of the
    ``per`` spans, over the number of those items."""
    recs = records()
    items = {r.item for r in recs if r.name == per}
    if not items:
        return None
    return sum(_ms(r) for r in recs if r.name == name and r.item in items) / len(items)


def attr_mean(name: str, attr: str) -> Optional[float]:
    """Mean of the attribute ``attr`` over the ``name`` spans that carry it."""
    return _mean([float(r.attrs[attr]) for r in records()
                  if r.name == name and attr in r.attrs])
