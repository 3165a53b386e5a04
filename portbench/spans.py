"""The port's own spans (``deconv3d_tpu_torch.metrics``) in a traced run.

The harness turns the port's tracer on, cleared, in ``--trace 1`` runs
before the kernels load and off once the window has closed, and hands its
spans to the readers as ``ctx.tracer_records``; untraced runs, which give
every end-to-end metric, never turn it on.  A reader of spans returns None
where the run has none.

The window's segments are told apart by the absolute sweep each span
carries (its segment's first): the window holds the last ``ctx.sweeps``
sweeps, and its unprofiled stretch the last ``ctx.plain_sweeps``.  Host
times are read there only: the profiler slows the host.
"""

from __future__ import annotations

from . import trace


def records(ctx):
    """The run's spans (``ctx.tracer_records``), or None where there is no
    device profile to read them beside or no span."""
    if not ctx.dev:
        return None
    return ctx.tracer_records or None


def window(ctx, recs):
    """(the window's first sweep, the first unprofiled sweep), from the
    last segment's end; None without segments."""
    heads = [r for r in recs
             if r["name"] == "segment.head" and r["sweep"] is not None]
    if not heads:
        return None
    end = max(r["sweep"] + r["sweeps"] for r in heads)
    return end - ctx.sweeps, end - ctx.plain_sweeps


def kept(ctx, name: str, field: str, where: str) -> list:
    """The spans ``name`` with a ``field`` of the segments ``where``:
    ``"window"``, ``"plain"`` (the unprofiled segments), ``"profiled"``,
    or ``"between_plain"`` (closed by an unprofiled segment after the
    first, for a span that reaches back into the segment before)."""
    recs = records(ctx)
    bounds = recs and window(ctx, recs)
    if not bounds:
        return []
    first, plain = bounds
    keep = {"window": lambda s: s >= first, "plain": lambda s: s >= plain,
            "profiled": lambda s: first <= s < plain,
            "between_plain": lambda s: s > plain}[where]
    return [r for r in recs if r["name"] == name and r["sweep"] is not None
            and keep(r["sweep"]) and r[field] is not None]


def mean_of(ctx, name: str, field: str, where: str):
    """The mean ``field`` (``host_ms`` or ``device_ms``) of the spans
    ``name`` of the segments ``where`` (:func:`kept`); None without one."""
    vals = [r[field] for r in kept(ctx, name, field, where)]
    return sum(vals) / len(vals) if vals else None


def total_s(ctx, name: str):
    """Host seconds of every span ``name``; None without one."""
    recs = records(ctx)
    vals = [r["host_ms"] for r in recs or () if r["name"] == name]
    return sum(vals) / 1e3 if vals else None


def busy_at_edges(ctx):
    """Mean device ms busy at a segment's edges in the profile: outside
    its sweep loops, that is before the first sweep kernel (the device
    operation with the most time, one launch a sweep), between a segment's
    last and the next one's first, and after the last, over the profiled
    segments (which hold a head and a tail each).  None where the profile
    does not hold one sweep kernel a sweep."""
    segments = sorted({(r["sweep"], r["sweeps"]) for r in kept(
        ctx, "segment.head", "sweeps", "profiled")})
    total = {}
    for name, a, b in ctx.dev or ():
        total[name] = total.get(name, 0.0) + b - a
    if not segments or not total:
        return None
    top = max(total, key=total.get)
    kernels = [(a, b) for name, a, b in ctx.dev if name == top]
    if not len(kernels) == sum(n for _, n in segments) == ctx.traced_sweeps:
        return None
    edges, i, lo = [], 0, float("-inf")
    for _, n in segments:
        edges.append((lo, kernels[i][0]))
        i += n
        lo = kernels[i - 1][1]
    edges.append((lo, float("inf")))
    cover = trace.union(ctx.dev)
    busy = sum(max(0.0, min(hi, y) - max(lo, x))
               for lo, hi in edges for x, y in cover)
    return busy / len(segments) / 1e3


def edge_idle_pct(ctx):
    """Share of a sweep's wall time in which the card idles at a segment's
    edges: the mean ``segment.gap`` (CUDA ms from a segment's last sweep
    launch to the next segment's first) between unprofiled segments, less
    the device's busy time there (:func:`busy_at_edges`), per sweep
    of those segments, over the unprofiled wall time of a sweep (the
    denominator of ``device_idle_pct``), in %."""
    gaps = kept(ctx, "segment.gap", "device_ms", "between_plain")
    busy = busy_at_edges(ctx) if gaps else None
    if busy is None or not ctx.plain_sweeps:
        return None
    gap_ms = sum(r["device_ms"] for r in gaps) / len(gaps)
    sweeps = sum(r["sweeps"] for r in gaps) / len(gaps)
    idle_s = (gap_ms - busy) / 1e3 / sweeps
    return 100.0 * idle_s * ctx.plain_sweeps / ctx.plain_s
