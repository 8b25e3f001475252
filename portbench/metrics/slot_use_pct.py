"""Real frames over ticks times slots: the share of computed slot-frames that were kept."""

from portbench.harness import readers


def read(ctx):
    return readers.counter(ctx, "slot_use_pct")
