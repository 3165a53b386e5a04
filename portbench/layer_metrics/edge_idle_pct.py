"""Share of a sweep's wall time in which the card idles at a segment's
edges (``spans.edge_idle_pct``): the port's ``segment.gap`` between the
window's unprofiled segments (CUDA ms from a segment's last sweep launch
to the next segment's first: its tail, the coarse pass or rebaseline, the
end in ``Run.run``, the next head) less the device work the profile shows
there, per sweep, over the unprofiled wall time of a sweep, as
``device_idle_pct``; the rest of that idle lies between sweeps."""

from portbench import spans


def read(ctx):
    return spans.edge_idle_pct(ctx)
