"""Host milliseconds inside VSRServer.step, the harness's clock, a tick on average."""

from portbench.harness import readers


def read(ctx):
    return readers.counter(ctx, "serve_host_ms")
