"""The traced window's share in which the device ran nothing."""

from portbench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
