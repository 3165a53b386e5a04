"""The profile's reduction on a hand-made timeline (µs)."""

from __future__ import annotations

from pytest import approx

from portbench import trace

DEV = [("k1", 0.0, 10.0), ("copy", 5.0, 12.0), ("k1", 20.0, 30.0),
       ("small", 31.0, 32.0), ("k1", 40.0, 50.0)]
HOST = [("aten::add", 1.0), ("aten::sum", 14.0), ("cudaLaunchKernel", 35.0)]


def test_busy_counts_overlaps_once():
    assert trace.union(DEV) == [[0.0, 12.0], [20.0, 30.0], [31.0, 32.0],
                                [40.0, 50.0]]
    assert trace.busy_seconds(DEV) == 33e-6
    assert trace.device_seconds(DEV, "k1") == 30e-6


def test_top_ops_and_idle_gaps():
    ops = trace.top_device_ops(DEV, 2)
    assert [n for n, _ in ops] == ["k1", "copy"]
    assert [t for _, t in ops] == approx([30e-6, 7e-6])
    # 12→20 holds aten::sum; 30→31 none, ended by "small"; 32→40 holds the
    # launch
    assert trace.idle_gaps(DEV, HOST) == [
        ["host: aten::sum", 8e-6], ["host: cudaLaunchKernel", 8e-6],
        ["before: small", 1e-6]]
