"""Mean device ms of the window's χ² rebaselines, from the port's own span
``rebaseline`` (CUDA events inside ``sampler.rebaseline_chi2``)."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "rebaseline", "device_ms", "window")
