"""What the traced run's profile says: device intervals, busy time, the
device operations that took most time and the idle gaps by what the host
was doing.

``torch.profiler`` (CPU and CUDA activities) records every device
operation with its name and interval and every host operation.  The busy
time is the length of the union of the device intervals, so overlapping
operations count once.  An idle gap between two device intervals is named
after the first host operation that began in it, or, where none did (the
host was in Python between operations), after the device operation that
ended the gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

#: entries of each list of the ``breakdown``
TOP = 10


def device_events(events) -> list:
    """(name, start µs, end µs) of every device operation, by start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and e.time_range.end > e.time_range.start]
    return sorted(out, key=lambda t: t[1])


def host_events(events) -> list:
    """(name, start µs) of every host operation, by start."""
    cpu = torch.autograd.DeviceType.CPU
    out = [(e.name, e.time_range.start) for e in events
           if e.device_type == cpu and not e.is_user_annotation]
    return sorted(out, key=lambda t: t[1])


def union(intervals) -> list:
    """The disjoint (start, end) cover of ``(name, start, end)`` sorted by
    start."""
    merged = []
    for _, a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(dev) -> float:
    return sum(b - a for a, b in union(dev)) / 1e6


def top_device_ops(dev, n: int = TOP) -> list:
    """[[name, seconds], ...]: the device operations that took most time,
    summed by name."""
    total = defaultdict(float)
    for name, a, b in dev:
        total[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]


def idle_gaps(dev, host, n: int = TOP) -> list:
    """[[label, seconds], ...]: the idle time between device intervals,
    summed by what the host was doing (see the module's docstring), the
    largest first."""
    cover = union(dev)
    starts = [t for _, t in host]
    nxt = {}
    for name, a, _ in dev:
        nxt.setdefault(a, name)
    total = defaultdict(float)
    for (_, end), (start, _) in zip(cover, cover[1:]):
        i = bisect.bisect_left(starts, end)
        if i < len(host) and host[i][1] < start:
            label = "host: " + host[i][0]
        else:
            label = "before: " + nxt.get(start, "?")
        total[label] += (start - end) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]


def device_seconds(dev, name: str) -> float:
    """Seconds of device operations whose name contains ``name``."""
    return sum(b - a for n, a, b in dev if name in n) / 1e6
