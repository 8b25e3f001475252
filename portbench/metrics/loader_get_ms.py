"""Milliseconds a step inside ``BatchLoader.next_batch``, from its span
``loader.wait``: the port's own counterpart of ``loader_wait_ms``."""

from portbench.harness import spans


def read(ctx):
    return spans.mean_ms("loader.wait")
