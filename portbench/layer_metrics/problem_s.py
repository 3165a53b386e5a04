"""Host seconds of ``Run(...)`` (``sampler.make_problem``) and its chain
states (``init_state``), ending in a device sync."""


def read(ctx):
    return ctx.setup.get("problem_s")
