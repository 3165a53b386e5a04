"""The whole sweep's share of the card's peak: the least time of one sweep
(``roofline.sweep_bound``, max of float32 operations and HBM bytes) over
the wall time of a sweep in the window's segments that run without the
profiler, host work and segment ends included; it bounds every kernel's
roofline share from below."""


def read(ctx):
    if not ctx.dev or not ctx.plain_sweeps:
        return None
    return 100.0 * ctx.bound["bound_ms"] / 1e3 * ctx.plain_sweeps / ctx.plain_s
