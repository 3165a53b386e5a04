"""Mean ms of the window's χ² rebaselines (``sampler.rebaseline_chi2``, a
from-scratch χ² by the λ-chunked forward model), CUDA events around each
call."""

SPANS = [("deconv3d_tpu_torch.sampler", "rebaseline_chi2", "rebaseline")]


def read(ctx):
    ms = ctx.spans.get("rebaseline")
    return sum(ms) / len(ms) if ms else None
