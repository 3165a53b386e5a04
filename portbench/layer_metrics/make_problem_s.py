"""Host seconds of ``sampler.make_problem`` (the port's span
``setup.problem``, ended by a device sync while the tracer is on): the
banks, the FSF's factors, the weights and ``quad``."""

from portbench import spans


def read(ctx):
    return spans.total_s(ctx, "setup.problem")
