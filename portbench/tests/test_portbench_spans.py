"""The readers of the port's spans on hand-made contexts (the profile's
device operations in µs), and the tracer left off by an untraced run and
after a traced one."""

from __future__ import annotations

import pytest
from pytest import approx

from deconv3d_tpu_torch import metrics
from portbench import harness, spans, spec

from .conftest import BENCH

#: warm-up sweeps 0-9; the window's segments 10, 20 (profiled), 30, 40;
#: one sweep kernel ``k`` a sweep, a small operation between sweeps, and
#: at the edges 10 µs before the first, 30 between the segments and 40
#: after the last of other device work
KERNELS = [("k", t, t + 90.0) for t in
           [100.0 * i for i in range(10)] + [1200.0 + 100 * i
                                             for i in range(10)]]
DEV = sorted(KERNELS + [("layout", -50.0, -40.0), ("flux", 95.0, 98.0),
                        ("copy", 1000.0, 1010.0),
                        ("add", 1100.0, 1120.0), ("copy", 2200.0, 2240.0)],
             key=lambda t: t[1])


def _rec(name, sweep, a_us, b_us, device_ms=None):
    return {"name": name, "start_ns": int(a_us * 1e3),
            "end_ns": int(b_us * 1e3), "host_ms": (b_us - a_us) / 1e3,
            "device_ms": device_ms, "sweep": sweep,
            "sweeps": None if sweep is None else 10}


def _ctx(recs, dev=DEV, **kw):
    fields = dict(dev=dev, sweeps=40, traced_sweeps=20, plain_sweeps=20,
                  plain_s=0.02, tracer_records=recs)
    fields.update(kw)
    return harness.Context(**fields)


RECS = [
    _rec("setup.problem", None, -900.0, -400.0),
    _rec("setup.states", None, -400.0, -300.0),
    _rec("segment.head", 0, -200.0, -100.0),
    _rec("coarse_pass", 0, -100.0, -50.0, device_ms=40.0),
    # the profiled segments 10 and 20
    _rec("segment.head", 10, 90.0, 160.0),
    _rec("segment.gap", 20, 990.0, 1200.0, device_ms=0.21),
    _rec("segment.head", 20, 1150.0, 1190.0),
    _rec("coarse_pass", 10, 160.0, 170.0, device_ms=8.0),
    _rec("segment.tail", 20, 290.0, 420.0),
    _rec("gc", 20, 380.0, 390.0),
    _rec("run.segment_end", 20, 500.0, 520.0),
    # the unprofiled segments 30 and 40 (the gap into 30 holds the
    # profiler's stop)
    _rec("segment.gap", 30, 520.0, 600.0, device_ms=100.0),
    _rec("segment.head", 30, 600.0, 700.0),
    _rec("segment.tail", 30, 700.0, 705.0),
    _rec("coarse_pass", 30, 705.0, 710.0, device_ms=10.0),
    _rec("segment.gap", 40, 710.0, 720.0, device_ms=2.04),
    _rec("segment.head", 40, 720.0, 722.0),
    _rec("segment.tail", 40, 800.0, 803.0),
    _rec("rebaseline", 40, 803.0, 810.0, device_ms=6.0),
]


def _read(name, ctx):
    return spec.reader(name, BENCH / "layer_metrics").read(ctx)


def test_edge_idle_is_the_unprofiled_gap_less_the_busy_at_edges():
    # busy at the edges: 10 + 30 + 40 µs over 2 profiled segments (the
    # flux between sweeps is not at an edge); the gap between unprofiled
    # segments 2.04 ms: 2 ms idle over 10 sweeps, against 1 ms a sweep
    assert spans.busy_at_edges(_ctx(RECS)) == approx(0.04)
    assert _read("edge_idle_pct", _ctx(RECS)) == approx(20.0)


def test_edge_idle_needs_one_sweep_kernel_a_sweep():
    ctx = _ctx(RECS, dev=[d for d in DEV if d != KERNELS[3]])
    assert spans.edge_idle_pct(ctx) is None


@pytest.mark.parametrize("name, value", [
    ("segment_head_ms", (0.1 + 0.002) / 2),      # sweeps 30 and 40
    ("segment_tail_ms", (0.005 + 0.003) / 2),
    ("segment_gap_ms", 2.04),                    # closed by sweep 40 only
    ("coarse_span_ms", (8.0 + 10.0) / 2),        # the window: 10 and 30
    ("rebaseline_span_ms", 6.0),
    ("make_problem_s", 0.5e-3),
    ("init_state_s", 0.1e-3),
])
def test_readers_take_the_window_or_its_unprofiled_segments(name, value):
    assert _read(name, _ctx(RECS)) == approx(value)


@pytest.mark.parametrize("name", [
    "segment_gap_ms", "segment_head_ms", "segment_tail_ms", "segment_end_ms",
    "edge_idle_pct", "coarse_span_ms", "rebaseline_span_ms",
    "make_problem_s", "init_state_s"])
@pytest.mark.parametrize("case", ["only_gc", "no_profile", "no_spans"])
def test_none_where_there_is_nothing_to_read(name, case):
    recs = {"only_gc": [_rec("gc", None, 0.0, 1.0)], "no_profile": RECS,
            "no_spans": []}[case]
    ctx = _ctx(recs, dev=[] if case == "no_profile" else DEV)
    assert _read(name, ctx) is None


def test_no_unprofiled_segment_end_no_reading():
    # the only run.segment_end is a profiled segment's
    assert _read("segment_end_ms", _ctx(RECS)) is None
    assert _read("coarse_span_ms", _ctx(
        [r for r in RECS if r["name"] != "coarse_pass"])) is None


def test_untraced_run_leaves_the_tracer_off(tiny):
    root, bench = tiny
    metrics.reset()
    harness.run_cell(root, "tiny_mh", 2**31 + 11, 0.2, False, "cpu",
                     bench=bench)
    assert metrics.records() == []
    assert metrics.tracing(False) is False


def test_traced_run_turns_the_tracer_on_and_off(tiny):
    root, bench = tiny
    harness.run_cell(root, "tiny_mh", 2**31 + 11, 0.2, True, "cpu",
                     bench=bench)
    names = {r["name"] for r in metrics.records()}
    assert {"setup.problem", "setup.states", "segment.head",
            "segment.tail", "run.segment_end"} <= names
    assert metrics.tracing(False) is False
    metrics.reset()


def test_loading_the_readers_leaves_the_tracer_off():
    metrics.tracing(False)
    for path in sorted((BENCH / "layer_metrics").glob("*.py")):
        spec.reader(path.stem, BENCH / "layer_metrics")
    assert metrics.tracing(False) is False


def test_a_traced_context_carries_the_spans_and_the_profile_start(tiny):
    """Readers dropped in as files see ``ctx.tracer_records`` (the port's
    spans of the run) and ``ctx.trace_start_ns`` (the profile's start on
    the spans' clock, ``time.time_ns()``)."""
    import json
    import time

    root, bench = tiny
    probes = {"probe_spans": "len(ctx.tracer_records)",
              "probe_start_s": "ctx.trace_start_ns / 1e9"}
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for name, expr in probes.items():
        (bench / "layer_metrics" / f"{name}.py").write_text(
            f"def read(ctx):\n    return {expr}\n")
        doc["per_layer"].append({
            "name": name, "unit": "n", "better": "higher",
            "source": "program_span", "layer": "facade (Run.run)",
            "moves": "chain_sweeps_per_s", "workloads": ["tiny_mh"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    t0 = time.time()
    result, _, _ = harness.run_cell(root, "tiny_mh", 2**31 + 17, 0.2, True,
                                    "cpu", bench=bench)
    values = {k: v["value"] for k, v in result["metrics"].items()}
    assert values["probe_spans"] == len(metrics.records()) > 0
    assert t0 < values["probe_start_s"] < time.time()
    assert metrics.tracing(False) is False
    metrics.reset()
