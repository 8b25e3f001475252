"""The share of the window's steps in which the discriminator's gate was
open and its update applied: the program's gate counter (the training
state's ``counter_with_d``) read after the window, less its reading before,
over the window's steps."""


def read(ctx):
    c = ctx["counters"]
    if c.get("d_updates") is None or not c.get("window_steps"):
        return None
    return c["d_updates"] / c["window_steps"] * 100.0
