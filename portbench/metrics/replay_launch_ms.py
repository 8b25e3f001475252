"""Host milliseconds a replay of a captured CUDA graph takes to launch: the
mean ``graph.replay`` span of ``CapturedProgram``."""

from portbench.harness import spans


def read(ctx):
    return spans.mean_ms("graph.replay")
