"""Host seconds of ``chains.init_chain_states`` (the port's span
``setup.states``, ended by a device sync while the tracer is on): the
initial clean cube, residual and χ² of every chain."""

from portbench import spans


def read(ctx):
    return spans.total_s(ctx, "setup.states")
