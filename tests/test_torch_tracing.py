"""The port's spans (``deconv3d_tpu_torch/metrics.py``): off by default
and then a shared no-op that records nothing; on, one span per segment
edge, coarse pass, χ² rebaseline and set-up step, each with its segment's
first sweep; in ``Run(metrics_path=...)``'s JSONL lines; on the clock of
``torch.profiler``'s events; and never on the profile's own list.  The
counters: off, nothing; on, the problem's FSF rank and swept spaxels at
set-up, and the sweep kernels' launches by instantiation, never the plain
sweeps'."""

import gc
import json

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import metrics
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import sweep as tsw

SEGMENT = ("segment.head", "segment.tail", "run.segment_end")


@pytest.fixture(autouse=True)
def _tracer_off():
    metrics.tracing(False)
    metrics.reset()
    yield
    metrics.tracing(False)
    metrics.reset()


def _run(metrics_path=None, every=4):
    """A two-segment CPU ``Run`` (2 × 4 sweeps), a coarse pass and a χ²
    rebaseline after every ``every`` sweeps."""
    rng = np.random.default_rng(3)
    data = 0.2 * rng.standard_normal((12, 10, 10))
    data[6, 5, 5] += 5.0
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.04),
                             crval=4750.0, cdelt=1.25, dtype=np.float64)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=1.2),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    run = d3.Run(cube, inst, max_iterations=8, burn_in=2, fsf_size=5,
                 lsf_width=5, seed=1, device="cpu", dtype=np.float64,
                 coarse_every=every, chi2_rebaseline_every=every,
                 segment_size=4, metrics_path=metrics_path)
    return run.run()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


@pytest.mark.parametrize("kw", [{}, {"device": "cpu"}, {"sync": "cpu"}])
def test_off_span_is_the_shared_no_op(kw):
    span = metrics.span("probe", **kw)
    assert span is metrics.NULL
    with span:
        pass
    assert span.start() is metrics.NULL
    span.stop()
    assert metrics.records() == [] and metrics.totals() == {}


def test_off_a_run_records_nothing():
    _run()
    assert metrics.records() == [] and metrics.totals() == {}
    assert metrics.tracing(False) is False
    assert metrics._TRACER.on_gc not in gc.callbacks


def test_on_every_segment_edge_pass_and_rebaseline(monkeypatch):
    """One head, tail and end per segment, each with the segment's first
    sweep; one coarse-pass and one rebaseline span per call of the module
    attribute; the gap from segment 1's last launch to segment 2's first;
    set-up once."""
    calls = {"apply_coarse_pass": [], "rebaseline_chi2": []}
    for name, seen in calls.items():
        orig = getattr(tsm, name)
        monkeypatch.setattr(tsm, name, lambda p, s, *a, _o=orig, _s=seen: (
            _s.append(int(s.sweep.reshape(-1)[0])), _o(p, s, *a))[1])
    metrics.tracing(True)
    _run()
    by = _by_name(metrics.records())
    for name in SEGMENT:
        assert [(r["sweep"], r["sweeps"]) for r in by[name]] == [(0, 4),
                                                                 (4, 4)]
    assert calls["apply_coarse_pass"] == calls["rebaseline_chi2"] == [4, 8]
    assert [r["sweep"] for r in by["coarse_pass"]] == [0, 4]
    assert [r["sweep"] for r in by["rebaseline"]] == [0, 4]
    assert [r["sweep"] for r in by["segment.gap"]] == [4]
    assert len(by["setup.problem"]) == len(by["setup.states"]) == 1
    for r in metrics.records():
        assert r["end_ns"] >= r["start_ns"]
        assert r["host_ms"] == (r["end_ns"] - r["start_ns"]) / 1e6
        assert r["device_ms"] is None            # no CUDA events on the CPU
    totals = metrics.totals()
    assert totals["segment.head"][0] == 2 and totals["coarse_pass"][0] == 2


def test_metrics_path_writes_spans_into_each_line(tmp_path):
    path = tmp_path / "m.jsonl"
    _run(metrics_path=str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["sweep"] for x in lines] == [4, 8]
    for line in lines:
        assert {"segment.head", "segment.tail", "coarse_pass",
                "rebaseline"} <= set(line["span_ms"])
        assert all(v >= 0 for v in line["span_ms"].values())
        assert line["span_device_ms"] == {}
    # the second line holds the first segment's end and the gap into it
    assert {"run.segment_end", "segment.gap"} <= set(lines[1]["span_ms"])
    assert "run.segment_end" not in lines[0]["span_ms"]
    # on for the run's own calls only
    assert metrics.tracing(False) is False


def test_span_lies_on_the_profile_clock():
    """A span around a matrix product, placed with the profile's trace
    start, covers the product's profiled interval to within 1 ms; the
    profile lists no event of the span."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(384, 384, dtype=torch.float64)
    metrics.tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("probe"):
            torch.mm(a, a)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (r,) = [r for r in metrics.records() if r["name"] == "probe"]
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    s0, s1 = ((r["start_ns"] - start_ns) / 1e3, (r["end_ns"] - start_ns) / 1e3)
    assert abs(s0 - mm.time_range.start) < 1e3
    assert abs(s1 - mm.time_range.end) < 1e3
    assert not [e for e in prof.events() if "probe" in e.name]


def test_gc_is_a_span_while_on():
    metrics.tracing(True)
    assert metrics._TRACER.on_gc in gc.callbacks
    gc.collect()
    assert "gc" in _by_name(metrics.records())
    metrics.tracing(False)
    assert metrics._TRACER.on_gc not in gc.callbacks


def test_memory_stays_bounded_per_name():
    """The last KEEP spans of each name: a flood of one name (collections
    while a profile is parsed) evicts no span of another."""
    metrics.tracing(True)
    metrics.span("setup").start().stop()
    gc.disable()
    try:
        for _ in range(metrics.KEEP + 5):
            metrics.span("x").start().stop()
    finally:
        gc.enable()
    by = _by_name(metrics.records())
    assert len(by["x"]) == metrics.KEEP and len(by["setup"]) == 1
    assert metrics.totals()["x"][0] == metrics.KEEP + 5


@pytest.mark.gpu
def test_tracer_leaves_the_allocators_peak_alone():
    """Spans with CUDA events and syncs move no peak of the allocator and
    time the device work they enclose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' CUDA events")
    dev = torch.device("cuda")
    big = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    del big
    peak = torch.cuda.max_memory_allocated(dev)
    x = torch.randn(1 << 20, device=dev)
    metrics.tracing(True)
    with metrics.span("probe", device=dev, sync=dev):
        for _ in range(10):
            x = x * 1.0001
    metrics.segment_began(0, 1, dev)
    metrics.segment_launched(dev)
    metrics.segment_began(1, 1, dev)
    recs = _by_name(metrics.records())
    assert torch.cuda.max_memory_allocated(dev) == peak
    assert recs["probe"][0]["device_ms"] > 0
    assert recs["segment.gap"][0]["device_ms"] >= 0


def test_off_count_records_nothing():
    metrics.count("probe")
    metrics.count("probe", 5)
    assert metrics.counters() == {}
    _run()
    assert metrics.counters() == {}


def test_on_counts_add_up_and_reset_clears_them():
    metrics.tracing(True)
    metrics.count("probe")
    metrics.count("probe", 4)
    metrics.count("other", 0)
    assert metrics.counters() == {"probe": 5, "other": 0}
    metrics.tracing(False)
    assert metrics.counters() == {"probe": 5, "other": 0}   # kept when off
    metrics.reset()
    assert metrics.counters() == {}


def _chromatic_cube(device="cpu"):
    """A 12 × 10 × 10 cube, an FSF whose FWHM grows with λ (rank > 1),
    rows 2-3 × columns 6-7 masked, column 0 NaN on every plane and rows 5-6
    × columns 2-3 NaN on planes 0-2, and a variance with a sky line and a
    factor per spaxel."""
    rng = np.random.default_rng(5)
    L, Y, X = 12, 10, 10
    lam = 4750.0 + 1.25 * np.arange(L)
    var = ((1.0 + 4.0 * np.exp(-0.5 * ((lam - 4757.5) / 1.06) ** 2))[:, None,
                                                                       None]
           * rng.uniform(0.5, 2.0, (1, Y, X)))
    data = rng.standard_normal((L, Y, X)) * np.sqrt(var)
    data[6, 5, 5] += 50.0
    data[:, :, 0] = var[:, :, 0] = np.nan
    data[:3, 5:7, 2:4] = var[:3, 5:7, 2:4] = np.nan
    mask = np.zeros((Y, X), dtype=bool)
    mask[2:4, 6:8] = True
    cube = d3.Cube.from_data(data.astype(np.float32),
                             variance=var.astype(np.float32), mask=mask,
                             crval=4750.0, cdelt=1.25, device=device)
    inst = tins.MUSE(fsf=tins.MoffatPointSpreadFunction(
        fwhm=0.2, beta=2.6, fwhm_slope=2e-3, lambda_ref=4750.0))
    return cube, inst


def test_on_make_problem_counts_rank_and_swept_spaxels_in_its_spans():
    """A chromatic, masked, NaN cube: the FSF's rank (> 1), the swept
    spaxels (the problem's ``n_valid``) and the rest of Y·X; the FSF bank
    and the weights as spans inside ``setup.problem``."""
    cube, inst = _chromatic_cube()
    metrics.tracing(True)
    problem = tsm.make_problem(cube, inst, tsm.RunConfig(
        sampler="mh", fsf_size=5, lsf_width=11), device="cpu")
    counts = metrics.counters()
    S = int(problem.fsf_spec.shape[0])
    assert S > 1 and counts["problem.fsf_rank"] == S
    assert counts["problem.swept_spaxels"] == problem.n_valid == 86
    assert (counts["problem.swept_spaxels"]
            + counts["problem.unswept_spaxels"]) == problem.Y * problem.X
    by = _by_name(metrics.records())
    (outer,) = by["setup.problem"]
    for name in ("setup.fsf_bank", "setup.weights"):
        (inner,) = by[name]
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
            <= outer["end_ns"]
    assert by["setup.fsf_bank"][0]["end_ns"] <= by["setup.weights"][0][
        "start_ns"]
    assert not [k for k in counts if k.startswith("sweep.launches")]


@pytest.mark.parametrize("on", [True, False])
def test_sanitize_span_once_per_problem_inside_weights(on):
    """``setup.sanitize`` (the cube moved and ``Cube.sanitized``) lies
    inside ``setup.weights``, once per ``make_problem``; with tracing off
    no span is recorded."""
    cube, inst = _chromatic_cube()
    metrics.tracing(on)
    for _ in range(2):
        tsm.make_problem(cube, inst, tsm.RunConfig(
            sampler="gibbs", fsf_size=5, lsf_width=11), device="cpu")
    by = _by_name(metrics.records())
    if not on:
        assert by == {}
        return
    spans = list(zip(by["setup.weights"], by["setup.sanitize"]))
    assert len(spans) == len(by["setup.sanitize"]) == 2
    for outer, inner in spans:
        assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
            <= outer["end_ns"]


def test_plain_segment_counts_no_launch():
    """Only kernel launches count: a traced CPU run, whose sweeps are the
    plain torch ones, adds no ``sweep.launches.*``."""
    metrics.tracing(True)
    _run()
    counts = metrics.counters()
    assert counts["problem.fsf_rank"] >= 1
    assert not [k for k in counts if k.startswith("sweep.launches")]


@pytest.mark.parametrize("S, name", [(1, "sweep.launches.rank1"),
                                     (3, "sweep.launches.rank_any"),
                                     (8, "sweep.launches.rank_any")])
def test_launch_counts_by_the_instantiation_taken(S, name):
    """``_count_launch`` follows ``launch_variant``: rank 1 takes the
    ``kS = 1`` build, any other rank the ``kMaxRank`` one; the module
    counter counts as before, traced or not."""
    import types

    k = types.SimpleNamespace(spec=torch.zeros(S, 4), w=torch.zeros(4))
    counter = types.SimpleNamespace(launches=0, resident_launches=0)
    tsw._count_launch(k, counter, "resident_launches")
    assert counter.resident_launches == 1 and metrics.counters() == {}
    metrics.tracing(True)
    tsw._count_launch(k, counter, "launches")
    tsw._count_launch(k, counter, "launches")
    assert counter.launches == 2 and metrics.counters() == {name: 2}


@pytest.mark.parametrize("dtype, counted", [(torch.bfloat16, 2),
                                             (torch.float32, 0)])
def test_launch_counts_bfloat16_weights(dtype, counted):
    """``sweep.launches.w_bf16`` counts the launches whose weights are
    bfloat16 (classic K1's and the tiled kernel's), beside the rank
    counters, and none of the resident kernel's float32 ones."""
    import types

    k = types.SimpleNamespace(spec=torch.zeros(3, 4),
                              w=torch.zeros(4, dtype=dtype))
    counter = types.SimpleNamespace(launches=0)
    tsw._count_launch(k, counter, "launches")
    assert metrics.counters() == {}
    metrics.tracing(True)
    tsw._count_launch(k, counter, "launches")
    tsw._count_launch(k, counter, "launches")
    counts = metrics.counters()
    assert counter.launches == 3 and counts["sweep.launches.rank_any"] == 2
    assert counts.get("sweep.launches.w_bf16", 0) == counted


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_kernel_launches_count_by_instantiation_on_card(sampler):
    """On the card the chromatic cube's sweeps launch the any-rank build,
    one count a sweep; the same cube with a constant FSF the rank-1
    build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels")
    for slope, name in ((2e-3, "sweep.launches.rank_any"),
                        (0.0, "sweep.launches.rank1")):
        cube, inst = _chromatic_cube("cuda")
        inst = tins.MUSE(fsf=tins.MoffatPointSpreadFunction(
            fwhm=0.2, beta=2.6, fwhm_slope=slope, lambda_ref=4750.0))
        metrics.reset()
        metrics.tracing(True)
        run = d3.Run(cube, inst, seed=1, device="cuda", dtype=np.float32,
                     fsf_size=5, lsf_width=11, sampler=sampler, burn_in=0,
                     segment_size=3)
        run.run(3)
        torch.cuda.synchronize()
        counts = metrics.counters()
        metrics.tracing(False)
        assert (counts["problem.fsf_rank"] > 1) == (slope != 0.0)
        launches = {k: v for k, v in counts.items()
                    if k.startswith("sweep.launches")}
        assert launches == {name: 3}


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_ring_launches_count_bfloat16_weights_on_card(sampler):
    """On the card every tiled-kernel launch copies bfloat16 weights, one
    ``sweep.launches.w_bf16`` a sweep, and the resident kernel's none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels")
    for tile, bf16 in (((1, 1), 3), (None, 0)):
        cube, inst = _chromatic_cube("cuda")
        metrics.reset()
        metrics.tracing(True)
        run = d3.Run(cube, inst, seed=1, device="cuda", dtype=np.float32,
                     fsf_size=5, lsf_width=11, sampler=sampler, burn_in=0,
                     segment_size=3, tile=tile)
        run.run(3)
        torch.cuda.synchronize()
        counts = metrics.counters()
        metrics.tracing(False)
        assert counts["sweep.launches.rank_any"] == 3
        assert counts.get("sweep.launches.w_bf16", 0) == bf16
