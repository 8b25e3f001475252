"""Seconds ``VSRServer`` counted warming up and capturing its tick
(``VSRServer.capture_s``): the port's own counterpart of the harness's
clock around ``prewarm``."""


def read(ctx):
    value = getattr(getattr(ctx.get("cell"), "server", None), "capture_s", None)
    return None if value is None else float(value)
