"""The glue's share of the device's busy time."""

from portbench.harness import readers


def read(ctx):
    return readers.glue_pct(ctx)
