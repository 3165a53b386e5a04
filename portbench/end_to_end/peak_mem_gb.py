"""The card's peak allocated memory over set-up and window, in 1e9 bytes,
read before the comparison allocates anything."""


def read(ctx):
    return ctx.memory_peak_bytes / 1e9 if ctx.memory_peak_bytes else None
