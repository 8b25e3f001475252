"""Host milliseconds a tick inside ``VSRServer.step``, from its span
``serve.step`` less its wait for the staging buffer (``serve.stage_wait``):
the port's own counterpart of ``serve_host_ms``."""

from portbench.harness import spans


def read(ctx):
    return spans.self_ms("serve.step", lambda n: n == "serve.stage_wait")
