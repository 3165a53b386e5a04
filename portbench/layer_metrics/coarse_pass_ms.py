"""Mean ms of the window's coarse passes (``sampler.apply_coarse_pass``),
CUDA events around each call."""

SPANS = [("deconv3d_tpu_torch.sampler", "apply_coarse_pass", "coarse_pass")]


def read(ctx):
    ms = ctx.spans.get("coarse_pass")
    return sum(ms) / len(ms) if ms else None
