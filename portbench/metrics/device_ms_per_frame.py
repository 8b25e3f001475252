"""Device busy milliseconds over the frames the traced clips processed."""

from portbench.harness import readers


def read(ctx):
    return readers.device_ms_per(ctx, "frames_processed")
