"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card's name and power limit; no CUDA device is a failure.
2. build   — compile ``deconv3d_tpu_torch/csrc/*.cu`` with nvcc, one
   compiler per source, all at once (seconds).
3. kernel  — the MH sweep kernel against its plain torch version on the
   card, on the MUSE 30×30×600 bench geometry (f=17): 4 sweeps from one
   state with the same injected uniforms, comparing residual, clean cube,
   log-scales, χ² and every accept decision; then the in-kernel Philox
   draws against ``ops/philox.py``, bit for bit; then the time per sweep
   of both, the kernel launches per sweep, and a ``torch.profiler`` trace
   of 100 kernel sweeps (the kernel's share of device time, idle share).
   Then a batch of 32 chains through the kernel against the plain version
   of the same batch (2 sweeps, same injected uniforms, every chain), and
   the ms per batched sweep of both.
4. gibbs_kernel — the exact-Gibbs kernel against its plain version on the
   same geometry: 2 sweeps from one state with the same injected (u1, u2),
   comparing residual, clean cube, χ², every per-(color, spaxel) Δχ² and
   voxel count; the stream-2/3 Philox draws bit for bit; ms per sweep of
   both, launches per sweep and a profile; then a 32-chain batch against
   its plain version, as for MH.
5. main    — ``Run(cube, MUSE(), max_iterations=400, burn_in=200).run()``
   → ``diagnostics()`` → ``save()`` on the bench cube; the kernel must
   have run every sweep; running χ² against from-scratch χ² ≤ 1e-5;
   post-burn-in acceptance in [0.15, 0.35]; MH sweeps/s over the last 200.
6. gibbs_main — the same with ``sampler='gibbs'``: acceptance exactly 1.0,
   every sweep through the gibbs kernel, χ² consistency ≤ 1e-5 (also
   printed after the first 200 sweeps), gibbs sweeps/s over the last 200.
7. chains  — ``Run(n_chains=32)`` for mh and for gibbs, 64 sweeps after a
   64-sweep warm-up: one launch per sweep for the whole batch; chains 0 and
   31 equal the same chains run alone through the kernel; R̂ finite;
   aggregate chain-sweeps/s and per-chain sweeps/s.
8. full_lambda — 60×60×3681 (the full MUSE spectral range, banded LSF)
   through ``Run``: 20 MH sweeps and 10 gibbs sweeps, with the χ² check.

All phases run under PyTorch's default TF32 flags, which must hold after
them.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import _build, chains as ch, sampler as sm
from deconv3d_tpu_torch.ops import philox, sweep as sw


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bench_cube(L=600, Y=30, X=30, device="cuda"):
    """The bench.py synthetic MUSE subcube: two emission lines + noise."""
    rng = np.random.default_rng(0)
    truth = np.zeros((L, Y, X), np.float32)
    truth[min(300, L - 1), min(15, Y - 1), min(15, X - 1)] = 50.0
    truth[min(200, L - 1), min(8, Y - 1), min(20, X - 1)] = 30.0
    data = truth + rng.standard_normal((L, Y, X)).astype(np.float32)
    return d3.Cube.from_data(
        data, variance=np.ones_like(data), crval=4750.0, cdelt=1.25,
        device=device,
    )


def copy_state(s: sm.SamplerState) -> sm.SamplerState:
    return sm.SamplerState(**{k: v.clone() for k, v in vars(s).items()})


def timed(fn):
    """``fn()`` and its ms between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_sweeps(fn, n):
    """Mean ms per sweep of ``fn(n)`` with CUDA events (after a warm-up)."""
    fn(1)
    return timed(lambda: fn(n))[1] / n


def phase_kernel(n_sweeps=4):
    cube = bench_cube()
    problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(seed=0))
    check(problem.config.engine == "cuda", "engine did not resolve to cuda")
    state = sm.init_state(problem)
    L, n_colors, nij = problem.L, problem.n_colors, problem.ny * problem.nx
    rng = np.random.default_rng(1)
    u = rng.random((n_sweeps, n_colors, nij, L + 1), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24)).cuda()
    u, plain = sw.untie_uniforms(problem, state, n_sweeps, u)
    kern = sw.mh_segment(problem, copy_state(state), n_sweeps, u)
    torch.cuda.synchronize()
    ps, ks = plain.result.state, kern.result.state

    resid_err = float((ps.resid - ks.resid).abs().max())
    resid_tol = 1e-4 * float(ps.resid.abs().max())
    clean_err = float((ps.clean - ks.clean).abs().max())
    clean_tol = 1e-4 * float(ps.clean.abs().max())
    ls_err = float((ps.log_scale - ks.log_scale).abs().max())
    chi2_rel = abs(float(ps.chi2) - float(ks.chi2)) / float(ps.chi2)
    dchi_err = float((plain.dchi - kern.dchi).abs().max())
    flips = int((plain.accept != kern.accept).sum())
    emit("kernel_vs_plain", shape=[L, problem.Y, problem.X], f=problem.f,
         sweeps=n_sweeps, decisions=int(plain.accept.numel()),
         accepts_plain=int(plain.accept.sum()),
         accepts_kernel=int(kern.accept.sum()), flips=flips,
         resid_max_abs_err=resid_err, resid_tol=resid_tol,
         clean_max_abs_err=clean_err, clean_tol=clean_tol,
         log_scale_max_abs_err=ls_err, chi2_rel_err=chi2_rel,
         dchi_max_abs_err=dchi_err)
    check(flips == 0, f"{flips} accept decisions differ")
    check(resid_err <= resid_tol, "residual differs")
    check(clean_err <= clean_tol, "clean cube differs")
    check(ls_err <= 1e-6, "log-scales differ")
    check(chi2_rel <= 1e-5, "chi2 differs")

    # in-kernel Philox draws against ops/philox.py, bit for bit
    sweep = 7
    st = copy_state(state)
    st.sweep.fill_(sweep)
    seg = sw.mh_segment(problem, st, 1, record_uniforms=True)
    want = philox.sweep_uniforms(int(st.key), sweep, n_colors, nij, L,
                                 device="cuda")
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg.uniforms[0], want))
    emit("philox_bits", sweep=sweep, draws=int(want.numel()), equal=equal)
    check(equal, "in-kernel Philox draws differ from ops/philox.py")

    # time per sweep, kernel (Philox draws) and plain, from one state
    n0 = sw.mh_segment.launches
    ms = time_sweeps(lambda n: sw.mh_segment(problem, state, n), 50)
    launches_per_sweep = (sw.mh_segment.launches - n0) / 51
    plain_ms = time_sweeps(
        lambda n: sw.mh_segment_reference(problem, state, n), 5)
    emit("sweep_time", shape=[L, problem.Y, problem.X], kernel_ms=ms,
         plain_ms=plain_ms, launches_per_sweep=launches_per_sweep)
    check(launches_per_sweep == 1, "expected one kernel launch per sweep")
    phase_profile(problem, state, "mh")
    return {"max_abs_err": resid_err, "ms": ms, "plain_ms": plain_ms,
            **phase_batch_vs_plain(problem, "mh")}


def phase_gibbs_kernel(n_sweeps=2):
    cube = bench_cube()
    problem = sm.make_problem(cube, d3.MUSE(),
                              sm.RunConfig(seed=0, sampler="gibbs"))
    check(problem.config.engine == "cuda", "engine did not resolve to cuda")
    state = sm.init_state(problem)
    L, n_colors, nij = problem.L, problem.n_colors, problem.ny * problem.nx
    rng = np.random.default_rng(2)
    u = rng.random((n_sweeps, n_colors, nij, 2, L), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24)).cuda()
    plain = sw.gibbs_segment_reference(problem, state, n_sweeps, u)
    n0 = sw.gibbs_segment.launches
    kern = sw.gibbs_segment(problem, copy_state(state), n_sweeps, u)
    torch.cuda.synchronize()
    check(sw.gibbs_segment.launches - n0 == n_sweeps, "one launch per sweep")
    ps, ks = plain.result.state, kern.result.state

    # no accept decision can flip: libm's logf/cosf/rsqrtf and the sums'
    # order differ from torch's in the last ulps, so a tolerance
    resid_err = float((ps.resid - ks.resid).abs().max())
    resid_tol = 1e-4 * float(ps.resid.abs().max())
    clean_err = float((ps.clean - ks.clean).abs().max())
    clean_tol = 1e-4 * float(ps.clean.abs().max())
    chi2_rel = abs(float(ps.chi2) - float(ks.chi2)) / float(ps.chi2)
    dchi_err = float((plain.dchi - kern.dchi).abs().max())
    dchi_tol = 1e-4 * float(plain.dchi.abs().max())
    counts_equal = bool(torch.equal(plain.accept, kern.accept))
    emit("gibbs_kernel_vs_plain", shape=[L, problem.Y, problem.X],
         f=problem.f, lsf_width=int(problem.lsf.shape[1]), sweeps=n_sweeps,
         voxels_drawn=int(kern.accept.sum()), counts_equal=counts_equal,
         resid_max_abs_err=resid_err, resid_tol=resid_tol,
         clean_max_abs_err=clean_err, clean_tol=clean_tol,
         chi2_rel_err=chi2_rel, dchi_max_abs_err=dchi_err, dchi_tol=dchi_tol)
    check(counts_equal, "voxel counts differ")
    check(int(kern.accept.sum()) > 0, "no voxel drawn; the check is vacuous")
    check(resid_err <= resid_tol, "residual differs")
    check(clean_err <= clean_tol, "clean cube differs")
    check(chi2_rel <= 1e-5, "chi2 differs")
    check(dchi_err <= dchi_tol, "per-spaxel dchi2 differs")

    # in-kernel Philox streams 2/3 against ops/philox.py, bit for bit
    sweep = 7
    st = copy_state(state)
    st.sweep.fill_(sweep)
    seg = sw.gibbs_segment(problem, st, 1, record_uniforms=True)
    want = philox.gibbs_sweep_uniforms(int(st.key), sweep, n_colors, nij, L,
                                       device="cuda")
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg.uniforms[0], want))
    emit("gibbs_philox_bits", sweep=sweep, draws=int(want.numel()),
         equal=equal)
    check(equal, "in-kernel stream-2/3 draws differ from ops/philox.py")

    n0 = sw.gibbs_segment.launches
    ms = time_sweeps(lambda n: sw.gibbs_segment(problem, state, n), 50)
    launches_per_sweep = (sw.gibbs_segment.launches - n0) / 51
    plain_ms = time_sweeps(
        lambda n: sw.gibbs_segment_reference(problem, state, n), 2)
    emit("gibbs_sweep_time", shape=[L, problem.Y, problem.X], kernel_ms=ms,
         plain_ms=plain_ms, launches_per_sweep=launches_per_sweep)
    check(launches_per_sweep == 1, "expected one kernel launch per sweep")
    phase_profile(problem, state, "gibbs")
    return {"max_abs_err": resid_err, "ms": ms, "plain_ms": plain_ms,
            **phase_batch_vs_plain(problem, "gibbs")}


def phase_batch_vs_plain(problem, sampler, n_chains=32, n_sweeps=2):
    """A batch of chains through the kernel (one launch per sweep) against
    the plain version of the same batch, same injected uniforms, every
    chain; the ms per batched sweep of both (first calls at this C)."""
    states = ch.init_chain_states(problem, n_chains)
    L, n_colors, nij = problem.L, problem.n_colors, problem.ny * problem.nx
    per = (L + 1,) if sampler == "mh" else (2, L)
    rng = np.random.default_rng(3)
    u = rng.random((n_sweeps, n_chains, n_colors, nij, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, _ = sw.untie_uniforms(problem, states, n_sweeps, u)
        ref = sw.mh_segment_reference
    else:
        ref = sw.gibbs_segment_reference
    plain, plain_ms = timed(lambda: ref(problem, states, n_sweeps, u))
    seg = segment_of(sampler)
    n0 = seg.launches
    kern, ms = timed(lambda: seg(problem, states, n_sweeps, u))
    launches = seg.launches - n0
    ps, ks = plain.result.state, kern.result.state
    resid_err = float((ps.resid - ks.resid).abs().max())
    resid_tol = 1e-4 * float(ps.resid.abs().max())
    clean_err = float((ps.clean - ks.clean).abs().max())
    clean_tol = 1e-4 * float(ps.clean.abs().max())
    chi2_rel = float(((ps.chi2 - ks.chi2).abs() / ps.chi2).max())
    equal = bool(torch.equal(plain.accept, kern.accept))
    emit("batch_vs_plain", sampler=sampler, n_chains=n_chains,
         sweeps=n_sweeps, launches=launches, accept_or_counts_equal=equal,
         decisions_or_spaxels=int(kern.accept.numel()),
         resid_max_abs_err=resid_err, resid_tol=resid_tol,
         clean_max_abs_err=clean_err, clean_tol=clean_tol,
         chi2_rel_err=chi2_rel, kernel_ms_per_batched_sweep=ms / n_sweeps,
         plain_ms_per_batched_sweep=plain_ms / n_sweeps)
    check(launches == n_sweeps, "expected one launch per sweep for the batch")
    check(equal, "accept decisions / voxel counts differ")
    check(resid_err <= resid_tol, "batched residual differs")
    check(clean_err <= clean_tol, "batched clean cube differs")
    check(chi2_rel <= 1e-5, "batched chi2 differs")
    return {f"max_abs_err_n_chains_{n_chains}": resid_err,
            f"ms_n_chains_{n_chains}": ms / n_sweeps,
            f"plain_ms_n_chains_{n_chains}": plain_ms / n_sweeps}


def reset_launches():
    sw.mh_segment.launches = sw.gibbs_segment.launches = 0


def phase_profile(problem, state, sampler, n=100):
    """``torch.profiler`` over ``n`` post-burn-in sweeps of the wrapper:
    device time of the kernel and of the torch ops around it, and the
    card's idle share of the wall time (the profiler's own overhead
    included, so an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    st = copy_state(state)
    st.sweep.fill_(problem.config.resolved_burn_in())
    seg = segment_of(sampler)
    seg(problem, st, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg(problem, st, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    kern = [e for e in on_card if f"{sampler}_sweep_kernel" in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    emit("profile", sampler=sampler, shape=[problem.L, problem.Y, problem.X],
         sweeps=n,
         wall_ms=wall_ms, device_ms=device_ms, kernel_ms=kernel_ms,
         kernel_launches=len(kern),
         kernel_share_of_device=kernel_ms / max(device_ms, 1e-9),
         other_device_ops_per_sweep=(len(on_card) - len(kern)) / n,
         idle_share=1.0 - device_ms / wall_ms)
    check(len(kern) == n and kernel_ms > 0,
          "the profiler did not see one kernel launch per sweep")


def chi2_consistency(run, chain=0) -> float:
    state = ch.select_chains(run.states, chain)
    chi_full = float(sm.full_chi2(run.problem, state))
    return abs(float(state.chi2) - chi_full) / chi_full


def segment_of(sampler):
    return sw.gibbs_segment if sampler == "gibbs" else sw.mh_segment


def phase_main(tmp, sampler="mh"):
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), max_iterations=400, burn_in=200, seed=0,
                 sampler=sampler)
    check(run.problem.config.engine == "cuda", "Run did not pick the kernel")
    seg = segment_of(sampler)
    reset_launches()
    run.run(200)
    torch.cuda.synchronize()
    consistency_200 = chi2_consistency(run)
    t0 = time.perf_counter()
    run.run(200)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = seg.launches
    diag = run.diagnostics()
    out = os.path.join(tmp, f"smoke_{sampler}")
    run.save(out)
    files = [f"{out}_{s}" for s in ("clean.fits", "std.fits",
                                    "convolved.fits", "traces.npz",
                                    "stats.json")]
    clean = d3.Cube.from_fits(files[0])
    consistency = chi2_consistency(run)
    acc_post = float(np.mean(run.trace("accept")[0, 200:]))
    emit("main" if sampler == "mh" else "gibbs_main", shape=list(cube.shape),
         sampler=sampler, sweeps=diag["sweeps"], launches=launches,
         chi2=diag["chi2"], chi2_consistency=consistency,
         chi2_consistency_after_200=consistency_200,
         acceptance=diag["acceptance_rate"], acceptance_post_burn_in=acc_post,
         **{f"{sampler}_sweeps_per_sec_last_200": 200 / dt},
         proposals_per_sec=200 * run.problem.n_valid / dt)
    check(launches == 400, f"kernel launched {launches} times, expected 400")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    if sampler == "mh":
        check(0.15 <= acc_post <= 0.35, "post-burn-in acceptance out of range")
    else:
        check(diag["acceptance_rate"] == 1.0 and acc_post == 1.0,
              "gibbs acceptance is not exactly 1")
    check(all(os.path.isfile(f) for f in files), "save() files missing")
    check(clean.shape == cube.shape
          and bool(torch.isfinite(clean.data).all()), "bad clean cube")
    return launches, 200 / dt


def phase_chains(sampler, single_rate, n_chains=32, n=64):
    """``Run(n_chains=32)``: one launch per sweep for the batch, and chains
    0 and 31 equal to the same chains run alone through the kernel."""
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), max_iterations=2 * n, burn_in=n, seed=0,
                 sampler=sampler, n_chains=n_chains)
    seg = segment_of(sampler)
    init = ch.init_chain_states(run.problem, n_chains)
    reset_launches()
    run.run(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = seg.launches
    diag = run.diagnostics()
    batch = run.states
    exact, chi2_rel, accept_equal = {}, 0.0, True
    for c in (0, n_chains - 1):
        alone = sm.run_sweeps(run.problem, ch.select_chains(init, c), 2 * n)
        mine = ch.select_chains(batch, c)
        for name in ("clean", "resid", "log_scale", "sum_clean", "sum_sq",
                     "n_accept", "n_propose"):
            exact[f"{name}_{c}"] = bool(torch.equal(
                getattr(mine, name), getattr(alone.state, name)))
        chi2_rel = max(chi2_rel, abs(float(mine.chi2) - float(alone.state.chi2))
                       / float(alone.state.chi2))
        accept_equal &= bool(np.array_equal(
            run.trace("accept")[c, n:], alone.accept_trace[n:].cpu().numpy()))
    consistency = max(chi2_consistency(run, c) for c in (0, n_chains - 1))
    emit("chains", sampler=sampler, n_chains=n_chains, sweeps=2 * n,
         launches=launches, states_equal=all(exact.values()),
         not_equal=[k for k, v in exact.items() if not v],
         chi2_rel_vs_alone=chi2_rel, accept_trace_equal=accept_equal,
         rhat_chi2=diag.get("rhat_chi2"),
         rhat_monitor_max=diag.get("rhat_monitor_max"),
         chi2_consistency=consistency,
         chain_sweeps_per_sec=n_chains * n / dt, per_chain_sweeps_per_sec=n / dt,
         single_chain_sweeps_per_sec=single_rate,
         aggregate_over_single=n_chains * n / dt / single_rate)
    check(launches == 2 * n,
          f"{launches} launches for {2 * n} sweeps of {n_chains} chains")
    # the sweep's arithmetic does not depend on the batch (the kernels'
    # tasks are per chain), so the states must be bit-equal; χ² may differ
    # by float32 rounding only: the per-sweep Δχ² sum reduces a [C, f², nij]
    # tensor whose order torch may choose by C
    check(all(exact.values()), "batched chains differ from chains run alone")
    check(chi2_rel <= 1e-6, "batched chi2 differs from chains run alone")
    check(accept_equal, "batched MH decisions differ from chains run alone")
    check(np.isfinite(diag["rhat_chi2"]), "R-hat is not finite")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    return launches


def phase_full_lambda(sampler, n):
    cube = bench_cube(L=3681, Y=60, X=60)
    run = d3.Run(cube, d3.MUSE(), max_iterations=n, burn_in=n // 2, seed=0,
                 sampler=sampler)
    check(run.problem.config.engine == "cuda", "Run did not pick the kernel")
    seg = segment_of(sampler)
    reset_launches()
    t0 = time.perf_counter()
    run.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = seg.launches
    consistency = chi2_consistency(run)
    emit("full_lambda", sampler=sampler, shape=list(cube.shape),
         f=run.problem.f, lsf_width=int(run.problem.lsf.shape[1]),
         launches=launches, chi2_consistency=consistency,
         sweeps_per_sec=n / dt, acceptance=run.acceptance_rate)
    check(launches == n, "kernel did not run every sweep")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    # the phases run under PyTorch's default TF32 flags, as a user's
    # program does; the port's own guard (convolve.no_tf32) must keep χ²
    # exact and leave the flags as it found them
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         tf32_matmul=tf32[0], tf32_cudnn=tf32[1])

    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=_build.build_seconds, ptxas=ptxas)

    kernel = {"mh": phase_kernel(), "gibbs": phase_gibbs_kernel()}
    launches, rate, batched = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for sampler in ("mh", "gibbs"):
            launches[sampler], rate[sampler] = phase_main(tmp, sampler)
    for sampler in ("mh", "gibbs"):
        batched[sampler] = phase_chains(sampler, rate[sampler])
    phase_full_lambda("mh", 20)
    phase_full_lambda("gibbs", 10)
    check((torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32) == tf32,
          "the port changed the process's TF32 flags")

    print(json.dumps({"kernels": [{
        "name": f"{sampler}_sweep",
        "route": "cuda",
        "source": f"deconv3d_tpu_torch/csrc/{sampler}_sweep.cu",
        "replaces": "deconv3d_tpu/ops/pallas_sweep.py:102"
                    + (" (mode gibbs, :243-314)" if sampler == "gibbs" else ""),
        "launches": launches[sampler],
        "launches_n_chains_32": batched[sampler],
        **kernel[sampler],
    } for sampler in ("mh", "gibbs")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
