"""Classic K1 (``csrc/mh_sweep.cu``, ``csrc/gibbs_sweep.cu``): the least
time of one sweep of the chain batch (``roofline.sweep_bound``) over the
profiled device time per sweep of ``<sampler>_sweep_kernel``."""


def read(ctx):
    busy = ctx.device_seconds(f"{ctx.sampler}_sweep_kernel")
    if not busy:
        return None
    return 100.0 * ctx.bound["bound_ms"] / 1e3 * ctx.traced_sweeps / busy
