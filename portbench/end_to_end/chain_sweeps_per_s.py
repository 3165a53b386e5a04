"""Chains × sweeps completed in the window over the window's seconds."""


def read(ctx):
    return ctx.n_chains * ctx.sweeps / ctx.window_s
