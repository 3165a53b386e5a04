"""The card's peak allocated memory over the window alone, in 1e9 bytes:
the allocator's peak is reset after the warm-up, so the workspaces of the
sweeps, coarse passes and χ² rebaselines show here even where set-up's
peak sets ``peak_mem_gb``."""


def read(ctx):
    return ctx.window_peak_bytes / 1e9 if ctx.window_peak_bytes else None
