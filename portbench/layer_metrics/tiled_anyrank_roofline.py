"""The tiled kernel K2's any-rank build (``tiled_<sampler>_kernel<8, …>``,
the instantiation ``launch_variant`` takes for an FSF of rank S > 1): the
least time of one sweep at this run's S and swept spaxels
(``roofline.sweep_bound``) over the profiled device time per sweep of
that build alone.  ``anyrank_roofline``'s reading, held to the tiled
kernel's operations, so that a chromatic field's sweep is read apart from
the rank-1 build that the other field cells time.

None where the port counts no any-rank launch (``anyrank_roofline``'s
rule) or the profile holds no any-rank tiled kernel."""

import copy
from pathlib import Path

from portbench import spec

_ANYRANK = spec.reader("anyrank_roofline", Path(__file__).resolve().parent)


def read(ctx):
    name = f"tiled_{ctx.sampler}_kernel"
    tiled = copy.copy(ctx)
    tiled.dev = [op for op in ctx.dev or () if name in op[0]]
    return _ANYRANK.read(tiled)
