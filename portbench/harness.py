"""One run of a cell of the benchmark of ``deconv3d_tpu_torch``.

Set-up: the kernel libraries load (built once per checkout, under the
port's ``build/`` directory), the cube is made on the device from the
seed (``scene``), ``Run`` builds its problem and chain states, and the
traffic's warm-up sweeps run.  Then ``Run.run(segment_size)`` runs back
to back until ``seconds`` have passed; the window ends after a device sync
at the end of a segment, so every rate is all the work of the window over
all its time.  With ``trace`` the profiler covers the window's first
segments, at least :data:`TRACE_SECONDS`, the calls that the per-layer
readers name are timed with CUDA events over the whole window, and the
port's own spans (``deconv3d_tpu_torch.metrics``) are on from before the
kernels load until the window has closed.

Once the window has closed and the peak memory is read, the program's
set-up products and end state are held against the plain reference
(``reference.check``) on the inputs made again from the seed.  The core
knows no cell, configuration or metric by name: the cell's files say what
to run and ``end_to_end/<name>.py`` and ``layer_metrics/<name>.py`` what
to read.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import roofline, scene, spec, trace
from .reference import check

#: seconds of whole segments from the window's start that a traced run's
#: profile covers (the whole window of a fast cell holds ~10⁶ events)
TRACE_SECONDS = 3.0

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "deconv3d_tpu")


def forbidden_modules() -> list:
    """The names of :data:`FORBIDDEN` that ``sys.modules`` holds, compared
    by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric's reader may read.

    ``sampler``, ``n_chains``: the cell's traffic.
    ``setup_s``: process start to the first timed sweep; ``setup``: its
    parts (``start_s``: interpreter and imports, ``kernel_load_s``,
    ``inputs_s``: the cube with the card's context, ``problem_s``,
    ``warmup_s``).  ``window_s`` and ``sweeps`` (per chain) of the
    measured window; ``memory_peak_bytes`` over set-up and window, and
    ``window_peak_bytes`` over the window alone.  In a traced run also
    ``dev`` (device operations: name, start and end µs) and ``host`` (host
    operations) of the profiled segments, ``busy_s``, ``traced_s`` and
    ``traced_sweeps`` of them, ``plain_s`` and ``plain_sweeps`` of the
    window's segments after them, which run without the profiler and so
    give the wall time of a sweep, ``bound`` (the roofline bound of one
    sweep, ``roofline.sweep_bound``, at their acceptance), ``spans``
    (ms of each timed call, by span name) with ``span_peaks`` (the
    allocator's peak bytes during each, on the card), ``tracer_records``
    (the port's spans, ``metrics.records()``) and ``trace_start_ns`` (the
    profile's start on ``time.time_ns()``, the spans' clock).  Untraced,
    ``dev``, ``tracer_records`` and ``trace_start_ns`` are None."""

    def __init__(self, **fields):
        self.dev = self.host = None
        self.tracer_records = self.trace_start_ns = None
        self.spans, self.span_peaks = {}, {}
        self.__dict__.update(fields)

    def device_seconds(self, name: str) -> float:
        """Profiled device seconds of the operations whose name contains
        ``name`` (0 untraced)."""
        return trace.device_seconds(self.dev or [], name)


#: the keys of a configuration's Moffat ``fsf`` and MUSE ``lsf``, each
#: onto the port's keyword of the same name
FSF_KEYS = ("fwhm", "beta", "fwhm_slope", "lambda_ref")
LSF_KEYS = ("c2", "c1", "c0")


def _kernel(cls, spec: dict, kind: str, keys: tuple):
    if spec.get("kind") != kind:
        raise ValueError(f"no {cls.__name__} of kind {spec.get('kind')!r}")
    unknown = sorted(set(spec) - {"kind", *keys})
    if unknown:
        raise ValueError(f"the keys {unknown} map onto nothing of the "
                         f"port's {cls.__name__}")
    return cls(**{k: None if spec[k] is None else float(spec[k])
                  for k in keys if k in spec})


def instrument_of(config: dict):
    """The port's instrument for the configuration's Moffat FSF and MUSE
    LSF, the kinds a configuration of the benchmark states: every key of
    each maps onto the port's keyword (:data:`FSF_KEYS`,
    :data:`LSF_KEYS`), and a key that maps onto nothing raises
    ``ValueError``, so that no key is lost silently."""
    from deconv3d_tpu_torch import instruments as ins

    return ins.MUSE(fsf=_kernel(ins.MoffatFSF, config["fsf"], "moffat",
                                FSF_KEYS),
                    lsf=_kernel(ins.MUSELSF, config["lsf"], "muse", LSF_KEYS),
                    pixel_scale=float(config["pixel_scale"]))


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def install_spans(calls, cuda: bool):
    """Wrap each ``(module, attribute, span)`` of ``calls`` so that every
    call records its time: CUDA events on the card, the host clock
    elsewhere.  On the card a call also records the allocator's peak
    during it: the peak is reset before the call and read after it, and
    the peak before the reset is kept in ``earlier[0]`` so that the
    window's own peak is ``max(earlier[0], max_memory_allocated())``.
    Returns (records by span, peaks by span, earlier, the originals to
    restore)."""
    records, peaks, earlier, originals = (defaultdict(list),
                                          defaultdict(list), [0], [])
    for module, attr, span in dict.fromkeys(calls):
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)

        def timed(*args, _orig=orig, _span=span, **kwargs):
            if cuda:
                earlier[0] = max(earlier[0], torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _orig(*args, **kwargs)
                end.record()
                records[_span].append((start, end))
                peaks[_span].append(torch.cuda.max_memory_allocated())
            else:
                t = time.perf_counter()
                out = _orig(*args, **kwargs)
                records[_span].append((time.perf_counter() - t) * 1e3)
            return out

        setattr(mod, attr, timed)
        originals.append((mod, attr, orig))
    return records, peaks, earlier, originals


def _span_ms(records) -> dict:
    return {k: [r if isinstance(r, float) else r[0].elapsed_time(r[1])
                for r in v] for k, v in records.items()}


def shapes_of(problem) -> dict:
    """The problem's sizes that ``roofline.sweep_bound`` reads."""
    return {"f": problem.f, "L": problem.L,
            "S": int(problem.fsf_spec.shape[0]),
            "lw": int(problem.lsf.shape[1]), "n_valid": problem.n_valid,
            "Hp": problem.Hp, "Wp": problem.Wp,
            "n_colors": problem.n_colors, "ny": problem.ny,
            "nx": problem.nx, "sampler": problem.config.sampler,
            "positivity": problem.config.positivity}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device="cuda", t0=None, bench: Path = spec.HERE):
    """Run the cell ``workload`` once: (the result line as a dict, the
    compared numbers with their limits).  ``t0``: the process's start on
    ``time.perf_counter``'s clock (default: now)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(spec.load(root), workload, root, bench)
    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    metrics = cell["per_layer"] if traced else cell["end_to_end"]
    folder = "layer_metrics" if traced else "end_to_end"
    readers = [(m, spec.reader(m["name"], bench / folder)) for m in metrics]

    import deconv3d_tpu_torch as d3
    from deconv3d_tpu_torch import _build

    tracer = None
    if traced:
        from deconv3d_tpu_torch import metrics as tracer

        tracer.reset()
        tracer.tracing(True)
    setup = {}
    t = time.perf_counter()
    setup["start_s"] = t - t0
    if cuda:
        _build.load_library()
    setup["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    data, variance, mask = scene.make_inputs(config, seed, device)
    cube = d3.Cube.from_data(data, variance=variance, mask=mask,
                             crval=float(config["crval"]),
                             cdelt=float(config["cdelt"]), device=device)
    del data, variance, mask
    _sync(cuda)
    setup["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run = d3.Run(cube, instrument_of(config), seed=int(seed), device=device,
                 dtype=np.dtype(config["dtype"]),
                 fsf_size=int(config["fsf_size"]),
                 lsf_width=int(config["lsf_width"]),
                 segment_size=int(traffic["segment_size"]), **traffic["run"])
    run.states
    _sync(cuda)
    setup["problem_s"] = time.perf_counter() - t
    problem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    warmup = int(traffic["warmup_sweeps"])
    t = time.perf_counter()
    run.run(warmup)
    _sync(cuda)
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    clean_start = run.states.clean.to("cpu", copy=True)
    records, span_peaks, earlier, originals = install_spans(
        [c for _, r in readers for c in getattr(r, "SPANS", ())], cuda)
    prof, profiled = None, None
    seg = int(traffic["segment_size"])
    sweeps = 0
    try:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            # started, and its first start-up paid, before the clock runs
            prof = profile(activities=acts)
            prof.__enter__()
            _sync(cuda)
        tw = time.perf_counter()
        ends = []
        while True:
            run.run(seg)
            _sync(cuda)
            sweeps += seg
            elapsed = time.perf_counter() - tw
            ends.append(elapsed)
            if prof is not None and profiled is None and (
                    elapsed >= TRACE_SECONDS or elapsed >= seconds):
                prof.__exit__(None, None, None)
                # the plain stretch starts once the profiler has stopped
                profiled = (sweeps, elapsed, time.perf_counter() - tw)
            if elapsed >= seconds:
                break
        window_s = time.perf_counter() - tw
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
        if tracer is not None:
            tracer.tracing(False)
    window_peak = (max(earlier[0], torch.cuda.max_memory_allocated(device))
                   if cuda else 0)
    peak = max(setup_peak, window_peak)

    shapes = shapes_of(run.problem)
    ctx = Context(sampler=run.config.sampler, n_chains=run.n_chains,
                  setup_s=setup_s, setup=setup,
                  window_s=window_s, sweeps=sweeps, memory_peak_bytes=peak,
                  window_peak_bytes=window_peak)
    if prof is not None:
        events = prof.events()
        ctx.dev, ctx.host = trace.device_events(events), trace.host_events(
            events)
        ctx.traced_sweeps, ctx.traced_s, plain_start = profiled
        ctx.plain_sweeps = sweeps - ctx.traced_sweeps
        ctx.plain_s = ends[-1] - plain_start
        ctx.busy_s = trace.busy_seconds(ctx.dev)
        accept = run.trace("accept")[:, warmup:warmup + ctx.traced_sweeps]
        ctx.bound = roofline.sweep_bound(shapes, run.n_chains,
                                         float(np.mean(accept)))
        ctx.spans = _span_ms(records)
        ctx.span_peaks = dict(span_peaks)
        ctx.tracer_records = tracer.records()
        ctx.trace_start_ns = prof.profiler.kineto_results.trace_start_ns()
        del prof, events

    accept = np.mean(run.trace("accept")[:, warmup:], axis=1)
    problem, state = run.problem, run.states
    out = {"fsf": problem.fsf, "lsf": problem.lsf, "w_pad": problem.w_pad,
           "quad": problem.quad, "qvox": problem.qvox, "clean": state.clean,
           "resid": state.resid, "chi2": state.chi2,
           "clean_start": clean_start,
           "accept": accept.tolist() if ctx.sampler == "mh" else None,
           "target": run.config.target_acceptance}
    del run, cube, problem, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    data, variance, mask = scene.make_inputs(config, seed, device)
    nums = check.compare(config, data, variance, out, mask=mask)
    del out, data, variance, mask
    correct, compared = check.judge(nums, limits)

    values = {}
    for m, r in readers:
        v = r.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = ctx.n_chains * sweeps
    failed = check.chains_failed(nums, limits) * sweeps
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else device.type),
                "count": int(cell["entry"]["chips"]) if cuda else 1,
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": values, "device": dev_info}
    if ctx.dev is not None:
        dev_info["busy_s"] = ctx.busy_s
        dev_info["window_s"] = ctx.traced_s
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(ctx.dev),
            "idle_gaps": trace.idle_gaps(ctx.dev, ctx.host)}
    notes = {"workload": workload, "seed": int(seed), "sweeps": sweeps,
             "window_s": window_s, "setup": setup, "setup_s": setup_s,
             "segment_s": np.diff([0.0] + ends).tolist(),
             "acceptance": float(np.mean(accept)),
             "problem_peak_bytes": problem_peak, "shapes": shapes,
             "window_peak_bytes": window_peak,
             "per_chain": nums["per_chain"]}
    if ctx.dev is not None:
        notes.update(traced_sweeps=ctx.traced_sweeps, traced_s=ctx.traced_s,
                     plain_sweeps=ctx.plain_sweeps, plain_s=ctx.plain_s,
                     bound=ctx.bound,
                     spans={k: len(v) for k, v in ctx.spans.items()})
    return result, compared, notes


def compared_lines(compared: dict) -> list:
    """One line per number: its name, value and limit."""
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            + ("" if c["value"] <= c["limit"] else " FAILED")
            for k, c in compared.items()]


def finite(obj):
    """``obj`` with every non-finite float written as a string, so that the
    line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
