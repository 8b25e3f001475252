"""Milliseconds a tick that the frames' reads (``HostFrame``) waited for the
tick's copy to the host: the ``serve.fetch_wait`` spans of a tick, summed."""

from portbench.harness import spans


def read(ctx):
    return spans.sum_per_item_ms("serve.fetch_wait", per="serve.step")
