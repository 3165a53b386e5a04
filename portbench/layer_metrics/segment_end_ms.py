"""Mean host ms of a segment's end in ``Run.run`` (``run.segment_end``:
from the segment's return to the next segment, or to ``run``'s return
after the last: the NaN guard's sync, the traces to the host, the metrics
line, the closing acceptance and mixing checks) over the window's
unprofiled segments."""

from portbench import spans


def read(ctx):
    return spans.mean_of(ctx, "run.segment_end", "host_ms", "plain")
