"""Mean host ms of a segment's head (``segment.head``, the port's span in
``ops/sweep.py::_run_segment`` from its entry to the first sweep's launch:
the layouts, the sweep counter's sync, the schedules, the monitored
voxels) over the window's unprofiled segments."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "segment.head", "host_ms", "plain")
