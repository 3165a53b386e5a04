"""Host seconds of the cube and its variance moved to the card and
``Cube.sanitized`` over them (the port's span ``setup.sanitize``, inside
``setup.weights``, ended by a device sync while the tracer is on): the
set-up that a whole exposure's two 1.33-GB cubes cost before any weight
is made.  None without the span."""

from portbench import spans


def read(ctx):
    return spans.total_s(ctx, "setup.sanitize")
