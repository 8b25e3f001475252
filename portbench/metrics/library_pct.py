"""The libraries' share of the device's busy time: cuDNN's and cuBLAS's
kernels (the trace's "library" group: convolutions and matrix products,
fprop, dgrad and wgrad) over the busy time."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return tr["groups_s"]["library"] / tr["busy_s"] * 100.0
