"""The card's peak allocated memory during the window's χ² rebaselines
(``sampler.rebaseline_chi2``), in 1e9 bytes: the allocator's peak is
reset before each call and read after it, so a rebaseline that allocates
more shows here even where the sweeps set the window's peak."""

SPANS = [("deconv3d_tpu_torch.sampler", "rebaseline_chi2", "rebaseline")]


def read(ctx):
    peaks = ctx.span_peaks.get("rebaseline")
    return max(peaks) / 1e9 if peaks else None
