"""Seconds the program spent warming up and capturing its CUDA graph(s):
``StreamingSR.capture_s``, ``Trainer.capture_s``, or the harness's clock
around ``VSRServer.prewarm``."""

from portbench.harness import readers


def read(ctx):
    return readers.counter(ctx, "capture_s")
