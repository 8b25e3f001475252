"""The chain kernel's share of its roofline, over its launches."""

from portbench.harness import readers


def read(ctx):
    return readers.chain_roofline_pct(ctx)
