"""The any-rank sweep kernels (``kS = kMaxRank``, the instantiation that
``launch_variant`` in ``csrc/sweep_common.cuh`` takes for an FSF of rank S
> 1): the least time of one sweep (``roofline.sweep_bound``, which takes S
and the swept spaxels from the problem) over the profiled device time per
sweep of the any-rank instantiation of the sweep kernel the run launched
(``resident_<sampler>_kernel``, ``<sampler>_sweep_kernel`` or
``tiled_<sampler>_kernel``).  The profile names an instantiation by its
template arguments, ``…_kernel<8, false>(…)``; the rank-1 build is
``<1, …>``.

None where the port counts no any-rank launch: its tracer has no counters
(``deconv3d_tpu_torch.metrics.counters``), the problem's FSF rank
(``problem.fsf_rank``) is 1, or ``sweep.launches.rank_any`` is 0."""

import re


def _counters():
    from deconv3d_tpu_torch import metrics

    read = getattr(metrics, "counters", None)
    return read() if read is not None else None


def read(ctx):
    counts = _counters()
    if (not counts or counts.get("problem.fsf_rank", 1) <= 1
            or not counts.get("sweep.launches.rank_any")):
        return None
    s = re.escape(ctx.sampler)
    kernel = re.compile(rf"\b(resident_{s}_kernel|{s}_sweep_kernel|"
                        rf"tiled_{s}_kernel)[<_](\d+)[,_]")
    busy = {}
    for name, a, b in ctx.dev or ():
        m = kernel.search(name)
        if m and int(m.group(2)) > 1:
            busy[m.group(1)] = busy.get(m.group(1), 0.0) + (b - a) / 1e6
    if not busy:
        return None
    seconds = max(busy.values())
    return 100.0 * ctx.bound["bound_ms"] / 1e3 * ctx.traced_sweeps / seconds
