"""The model's FLOPs over the traced window against the tensor cores' peak."""

from portbench.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
