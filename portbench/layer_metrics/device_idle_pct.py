"""Share of a sweep's wall time in which no device operation runs: the
device time of a sweep in the profiled segments (the union of the
profiler's device intervals) against the wall time of a sweep in the
window's later segments, which run without the profiler, so that its
slowing of the host's loop is not read as idle."""


def read(ctx):
    if not ctx.dev or not ctx.plain_sweeps:
        return None
    busy = ctx.busy_s / ctx.traced_sweeps
    return 100.0 * (1.0 - busy * ctx.plain_sweeps / ctx.plain_s)
