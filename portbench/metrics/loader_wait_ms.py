"""Milliseconds the window waited on BatchLoader.next_batch, a step on average."""

from portbench.harness import readers


def read(ctx):
    return readers.counter(ctx, "loader_wait_ms")
