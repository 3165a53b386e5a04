"""Mean device ms of the window's coarse passes, from the port's own span
``coarse_pass`` (CUDA events inside ``sampler.apply_coarse_pass``)."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "coarse_pass", "device_ms", "window")
