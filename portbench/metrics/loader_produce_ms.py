"""Milliseconds the loader's producer took to plan and decode each batch the
window took, as it stamped them (``loader.wait``'s ``produce_ms``)."""

from portbench.harness import spans


def read(ctx):
    return spans.attr_mean("loader.wait", "produce_ms")
