"""Observability: JSONL metrics stream + stdlib logging (SURVEY.md §5.5),
and the spans that say where a run's time goes.

Reference parity: deconv3d logs progress percentages and saves chi²/
acceptance traces at the end; here every segment emits a structured JSONL
record (machine-readable) and a human log line, during the run.

Spans and counters are off by default.  Off, :func:`span` returns one
shared no-op and :func:`count` returns, each after a single test of a
module flag: nothing is recorded, allocated or synchronised.
:func:`tracing` turns them on for the process, as
``logging`` is configured for it; ``Run(metrics_path=...)`` does so for
its own ``run`` calls, and each segment's JSONL line then carries the
milliseconds of the spans that ended since the line before.  On, a span
records

- its host interval on ``time.time_ns()``, the clock to which
  ``torch.profiler`` converts its host and device events: a span minus the
  profile's ``trace_start_ns()`` lies on the profile's timeline;
- with ``device`` a CUDA device, a pair of CUDA events on that device's
  current stream, read once they have completed;
- the absolute sweep at which the latest segment began, and its sweeps
  (None before any segment).

Never ``torch.profiler.record_function``: the profiler mirrors such an
annotation onto the device's timeline, where it reads as device work.
Never ``torch.cuda.reset_peak_memory_stats``: a caller may be reading the
allocator's peak.  While tracing is on, Python's garbage collections are
spans too (``gc``).  Memory stays bounded: totals per span name and the
last :data:`KEEP` spans of each name (a flood of collections, as parsing a
profile makes, evicts no other span).

Counters (:func:`count`, :func:`counters`) add up what a run did, by
name: the problem's FSF rank and swept spaxels at set-up, the sweep
kernels' launches by the instantiation they took.
"""

from __future__ import annotations

import gc
import json
import logging
import time
from collections import deque
from typing import Optional

import torch

logger = logging.getLogger("deconv3d_tpu_torch")

#: the spans of each name that :func:`records` keeps, the newest
KEEP = 10_000

#: the one flag a span tests while tracing is off
_ON = False


class _Span:
    """One span: start it, stop it, or use it as a context manager."""

    __slots__ = ("name", "sync", "stream", "events", "t0", "t1", "sweep",
                 "sweeps", "device_ms")

    def __init__(self, name: str, device=None, sync=None):
        self.name = name
        self.sync = sync if _is_cuda(sync) else None
        self.stream = (torch.cuda.current_stream(device) if _is_cuda(device)
                       else None)
        self.events = None
        self.t0 = self.t1 = None
        self.sweep = self.sweeps = self.device_ms = None

    def start(self) -> "_Span":
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.time_ns()
        return self

    def stop(self) -> None:
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        if self.events is not None:
            self.events[1].record(self.stream)
        self.t1 = time.time_ns()
        _TRACER.add(self)

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()


class _NullSpan:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def start(self) -> "_NullSpan":
        return self

    def stop(self) -> None:
        pass

    __enter__ = start

    def __exit__(self, *exc) -> None:
        pass


#: the shared no-op span
NULL = _NullSpan()


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class _Tracer:
    """The process's spans: the newest :data:`KEEP` of each name, totals
    per name ``[count, host ns, device ms]``, the spans whose CUDA events
    are not read yet, the latest segment ``(first absolute sweep,
    sweeps)``, the open ``segment.gap``, the running garbage
    collection's start and the counters."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.spans = {}
        self.totals = {}
        self.pending = deque()
        self.segment = (None, None)
        self.gap = None
        self.gc_t0 = None
        self.counters = {}

    def add(self, s: _Span, poll: bool = True) -> None:
        s.sweep, s.sweeps = self.segment
        kept = self.spans.get(s.name)
        if kept is None:
            kept = self.spans[s.name] = deque(maxlen=KEEP)
        kept.append(s)
        tot = self.totals.setdefault(s.name, [0, 0, 0.0])
        tot[0] += 1
        tot[1] += s.t1 - s.t0
        if s.events is not None:
            self.pending.append(s)
        if poll:
            self.read_events(wait=False)

    def read_events(self, wait: bool) -> None:
        """The device ms of pending spans, oldest first: those whose end
        event has completed, or with ``wait`` all of them."""
        while self.pending:
            s = self.pending[0]
            if wait:
                s.events[1].synchronize()
            elif not s.events[1].query():
                return
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            self.totals[s.name][2] += s.device_ms
            s.events = None
            self.pending.popleft()

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc_t0 = time.time_ns()
        elif self.gc_t0 is not None:
            s = _Span("gc")
            s.t0, s.t1, self.gc_t0 = self.gc_t0, time.time_ns(), None
            # a collection can start inside read_events: read none here
            self.add(s, poll=False)


_TRACER = _Tracer()


def tracing(on: bool) -> bool:
    """Turn the spans on or off for the process; returns whether they were
    on.  Turning them on or off keeps what was recorded (:func:`reset`
    clears it)."""
    global _ON
    was, _ON = _ON, bool(on)
    if _ON and not was:
        gc.callbacks.append(_TRACER.on_gc)
    elif was and not _ON:
        gc.callbacks.remove(_TRACER.on_gc)
        _TRACER.gc_t0 = None
    return was


def span(name: str, device=None, sync=None):
    """A span named ``name``, not yet started; :data:`NULL` while tracing
    is off.  ``device``: a CUDA device whose current stream the span also
    times with CUDA events.  ``sync``: a CUDA device synchronised before
    the span ends, so that its host interval holds the device work it
    issued."""
    if not _ON:
        return NULL
    return _Span(name, device, sync)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _ON:
        return
    _TRACER.counters[name] = _TRACER.counters.get(name, 0) + int(n)


def counters() -> dict:
    """``{name: total}`` of every counter since the last :func:`reset`."""
    return dict(_TRACER.counters)


def segment_began(sweep: int, sweeps: int, device) -> None:
    """A segment of ``sweeps`` sweeps from absolute sweep ``sweep`` is
    about to launch its first sweep on ``device``: later spans carry it,
    and the open ``segment.gap`` (from the previous segment's last launch)
    ends here."""
    if not _ON:
        return
    _TRACER.segment = (int(sweep), int(sweeps))
    gap, _TRACER.gap = _TRACER.gap, None
    if gap is None or gap.stream is not None and not (
            _is_cuda(device)
            and torch.cuda.current_stream(device).device == gap.stream.device):
        return          # none open, or opened on another device: dropped
    gap.stop()


def segment_launched(device) -> None:
    """A segment has launched its last sweep on ``device``: the span
    ``segment.gap`` opens, to end at the next segment's first launch."""
    if _ON:
        _TRACER.gap = _Span("segment.gap", device).start()


def records() -> list:
    """The kept spans, by start, as dicts: ``name``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``), ``host_ms``, ``device_ms`` (None
    without CUDA events), ``sweep`` and ``sweeps`` (the segment's, or
    None).  Waits for the device work the spans enclose."""
    _TRACER.read_events(wait=True)
    # copied first: a collection while the dicts are built adds a span
    kept = sorted((s for d in tuple(_TRACER.spans.values()) for s in tuple(d)),
                  key=lambda s: s.t0)
    return [{"name": s.name, "start_ns": s.t0, "end_ns": s.t1,
             "host_ms": (s.t1 - s.t0) / 1e6, "device_ms": s.device_ms,
             "sweep": s.sweep, "sweeps": s.sweeps} for s in kept]


def totals() -> dict:
    """``{name: (count, host ms, device ms)}`` over every span since the
    last :func:`reset`.  Waits for the device work the spans enclose."""
    _TRACER.read_events(wait=True)
    return {k: (n, ns / 1e6, ms)
            for k, (n, ns, ms) in dict(_TRACER.totals).items()}


def reset() -> None:
    """Forget every span and counter, the latest segment and the open
    gap."""
    _TRACER.reset()


class MetricsWriter:
    """Append-only JSONL metrics file + mirrored log lines.  With tracing
    on, each line written to the file also carries ``span_ms`` (host ms by
    span name) and ``span_device_ms`` (CUDA ms of the spans timed on the
    device) of the spans that ended since the line before."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.t0 = time.perf_counter()
        self._seen = totals() if self._fh else {}

    def write(self, **record) -> dict:
        record.setdefault("t", round(time.perf_counter() - self.t0, 3))
        if self._fh and _ON:
            now = totals()
            was = {k: self._seen.get(k, (0, 0.0, 0.0)) for k in now}
            record["span_ms"] = {k: round(now[k][1] - was[k][1], 3)
                                 for k in now if now[k][0] > was[k][0]}
            record["span_device_ms"] = {
                k: round(now[k][2] - was[k][2], 3) for k in now
                if now[k][0] > was[k][0] and now[k][2] > was[k][2]}
            self._seen = now
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        logger.info(
            "sweep %s: chi2=%.6g acc=%.3f (%.1f sweeps/s)",
            record.get("sweep", "?"), record.get("chi2", float("nan")),
            record.get("acceptance", float("nan")),
            record.get("sweeps_per_sec", float("nan")),
        )
        return record

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
