"""Mean host ms of a segment's tail (``segment.tail``, the port's span in
``ops/sweep.py::_run_segment`` from the end of the sweep loop to the
return: the gathers, the Kahan χ² pass, the traces, the new state) over
the window's unprofiled segments."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "segment.tail", "host_ms", "plain")
