"""The resident kernel (``csrc/resident_sweep.cu``): the least time of one
sweep (``roofline.sweep_bound``) over the profiled device time per sweep of
``resident_<sampler>_kernel``."""


def read(ctx):
    busy = ctx.device_seconds(f"resident_{ctx.sampler}_kernel")
    if not busy:
        return None
    return 100.0 * ctx.bound["bound_ms"] / 1e3 * ctx.traced_sweeps / busy
