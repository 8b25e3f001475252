"""Device busy milliseconds over the traced steps."""

from portbench.harness import readers


def read(ctx):
    return readers.device_ms_per(ctx, "steps")
