"""Process start to the first timed sweep: imports, the kernel libraries'
load (or build), the cube, ``Run`` with its problem and chain states, and
the warm-up sweeps."""


def read(ctx):
    return ctx.setup_s
