"""Mean device ms from a segment's last sweep launch to the next
segment's first (``segment.gap``, CUDA events): all the card does or
idles between the sweeps of two segments, coarse passes and χ²
rebaselines included.  Read between the window's unprofiled segments (the
gap into the first of them holds the profiler's stop)."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "segment.gap", "device_ms", "between_plain")
