"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card's name and power limit; no CUDA device is a failure.
2. build   — compile ``deconv3d_tpu_torch/csrc`` with nvcc (seconds).
3. kernel  — the MH sweep kernel against its plain torch version on the
   card, on the MUSE 30×30×600 bench geometry (f=17): 4 sweeps from one
   state with the same injected uniforms, comparing residual, clean cube,
   log-scales, χ² and every accept decision; then the in-kernel Philox
   draws against ``ops/philox.py``, bit for bit; then the time per sweep
   of both, the kernel launches per sweep, and a ``torch.profiler`` trace
   of 100 kernel sweeps (the kernel's share of device time, idle share).
4. main    — ``Run(cube, MUSE(), max_iterations=400, burn_in=200).run()``
   → ``diagnostics()`` → ``save()`` on the bench cube; the kernel must
   have run every sweep; running χ² against from-scratch χ² ≤ 1e-5;
   post-burn-in acceptance in [0.15, 0.35]; MH sweeps/s over the last 200.
5. full_lambda — 60×60×3681 (the full MUSE spectral range, banded LSF) for
   20 sweeps through ``Run``, with the same χ² check.

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
from deconv3d_tpu_torch import _build, sampler as sm
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


def time_sweeps(fn, n):
    """Mean ms per sweep of ``fn(n)`` with CUDA events (after a warm-up)."""
    fn(1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
    phase_profile(problem, state)
    return {"max_abs_err": resid_err, "ms": ms, "plain_ms": plain_ms}


def phase_profile(problem, state, n=100):
    """``torch.profiler`` over ``n`` post-burn-in sweeps of the wrapper:
    device time of the kernel and of the torch ops around it, and the
    card's idle share of the wall time (the profiler's own overhead
    included, so an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    st = copy_state(state)
    st.sweep.fill_(problem.config.resolved_burn_in())
    sw.mh_segment(problem, st, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sw.mh_segment(problem, st, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    kern = [e for e in on_card if "mh_sweep_kernel" in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    emit("profile", shape=[problem.L, problem.Y, problem.X], sweeps=n,
         wall_ms=wall_ms, device_ms=device_ms, kernel_ms=kernel_ms,
         kernel_launches=len(kern),
         kernel_share_of_device=kernel_ms / max(device_ms, 1e-9),
         other_device_ops_per_sweep=(len(on_card) - len(kern)) / n,
         idle_share=1.0 - device_ms / wall_ms)
    check(len(kern) == n and kernel_ms > 0,
          "the profiler did not see one kernel launch per sweep")


def chi2_consistency(run) -> float:
    state = sm.SamplerState(**{k: v[0] for k, v in vars(run.states).items()})
    chi_full = float(sm.full_chi2(run.problem, state))
    return abs(float(state.chi2) - chi_full) / chi_full


def phase_main(tmp):
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), max_iterations=400, burn_in=200, seed=0)
    check(run.problem.config.engine == "cuda", "Run did not pick the kernel")
    sw.mh_segment.launches = 0
    run.run(200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(200)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sw.mh_segment.launches
    diag = run.diagnostics()
    out = os.path.join(tmp, "smoke")
    run.save(out)
    files = [f"{out}_{s}" for s in ("clean.fits", "std.fits",
                                    "convolved.fits", "traces.npz",
                                    "stats.json")]
    clean = d3.Cube.from_fits(files[0])
    consistency = chi2_consistency(run)
    acc_post = float(np.mean(run.trace("accept")[0, 200:]))
    emit("main", shape=list(cube.shape), sweeps=diag["sweeps"],
         launches=launches, chi2=diag["chi2"],
         chi2_consistency=consistency, acceptance_post_burn_in=acc_post,
         mh_sweeps_per_sec_last_200=200 / dt,
         proposals_per_sec=200 * run.problem.n_valid / dt)
    check(launches == 400, f"kernel launched {launches} times, expected 400")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    check(0.15 <= acc_post <= 0.35, "post-burn-in acceptance out of range")
    check(all(os.path.isfile(f) for f in files), "save() files missing")
    check(clean.shape == cube.shape
          and bool(torch.isfinite(clean.data).all()), "bad clean cube")
    return launches


def phase_full_lambda():
    cube = bench_cube(L=3681, Y=60, X=60)
    run = d3.Run(cube, d3.MUSE(), max_iterations=20, burn_in=10, seed=0)
    check(run.problem.config.engine == "cuda", "Run did not pick the kernel")
    n0 = sw.mh_segment.launches
    t0 = time.perf_counter()
    run.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    consistency = chi2_consistency(run)
    emit("full_lambda", shape=list(cube.shape), f=run.problem.f,
         lsf_width=int(run.problem.lsf.shape[1]),
         launches=sw.mh_segment.launches - n0,
         chi2_consistency=consistency, sweeps_per_sec=20 / dt,
         acceptance=run.acceptance_rate)
    check(sw.mh_segment.launches - n0 == 20, "kernel did not run every sweep")
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

    kernel = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main(tmp)
    phase_full_lambda()
    check((torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32) == tf32,
          "the port changed the process's TF32 flags")

    print(json.dumps({"kernels": [{
        "name": "mh_sweep",
        "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/mh_sweep.cu",
        "replaces": "deconv3d_tpu/ops/pallas_sweep.py:102",
        "launches": launches,
        **kernel,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
