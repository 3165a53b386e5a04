"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  — the card's name and power limit; no CUDA device is a failure.
2. build   — compile ``deconv3d_tpu_torch/csrc/*.cu`` with nvcc, one
   compiler per source, all at once (seconds).
3. kernel  — classic K1's MH kernel (``csrc/mh_sweep.cu``, pinned: the
   main path now runs the resident kernel) against its plain torch version
   on the card, on the MUSE 30×30×600 bench geometry (f=17): 4 sweeps from one
   state with the same injected uniforms, comparing residual, clean cube,
   log-scales, χ² and every accept decision; then the in-kernel Philox
   draws against ``ops/philox.py``, bit for bit; then the time per sweep
   of both, the kernel launches per sweep, and a ``torch.profiler`` trace
   of 100 kernel sweeps (the kernel's share of device time, idle share).
   Then a batch of 32 chains through the kernel against the plain version
   of the same batch (2 sweeps, same injected uniforms, every chain), and
   the ms per batched sweep of both.
4. gibbs_kernel — classic K1's exact-Gibbs kernel (pinned) against its
   plain version on the same geometry: 2 sweeps from one state with the
   same injected (u1, u2),
   comparing residual, clean cube, χ², every per-(color, spaxel) Δχ² and
   voxel count; the stream-2/3 Philox draws bit for bit; ms per sweep of
   both, launches per sweep and a profile; then a 32-chain batch against
   its plain version, as for MH.
4b. resident — the resident kernel (``csrc/resident_sweep.cu``), mh and
   gibbs, at 30×30×600: against the plain sweep on the kernel phases'
   injected uniforms (same checks) and its in-kernel Philox bits; against
   classic K1 on the Philox draws, 4 sweeps from one state, resid, clean,
   log-scales, χ², accept decisions / voxel counts and every per-(color,
   spaxel) Δχ² bit-equal; ms per sweep of both in turns (resident,
   classic, classic, resident); a profile; µs per grid barrier of its grid
   (``resident_barrier_launch``).
5. main    — ``Run(cube, MUSE(), max_iterations=400, burn_in=200).run()``
   → ``diagnostics()`` → ``save()`` on the bench cube; the resident kernel
   must have run every sweep (classic K1 none); running χ² against
   from-scratch χ² ≤ 1e-5;
   post-burn-in acceptance in [0.15, 0.35]; MH sweeps/s over the last 200.
6. gibbs_main — the same with ``sampler='gibbs'``: acceptance exactly 1.0,
   every sweep through the resident kernel, χ² consistency ≤ 1e-5 (also
   printed after the first 200 sweeps), gibbs sweeps/s over the last 200.
7. chains  — ``Run(n_chains=32)`` for mh and for gibbs, 64 sweeps after a
   64-sweep warm-up: one classic K1 launch per sweep for the whole batch
   (the resident plan does not fit it; resident launches 0); chains 0 and
   31 equal the same chains run alone (batch: classic K1; alone: the
   resident kernel); R̂ finite;
   aggregate chain-sweeps/s and per-chain sweeps/s; then classic K1's ms
   per batched sweep on the run's state.
8. full_lambda — 60×60×3681 (the full MUSE spectral range, banded LSF)
   through ``Run``: 20 MH sweeps and 10 gibbs sweeps (after 2 of warm-up),
   with the χ² check,
   on the whole-cube kernels (``engine='cuda'``, which the auto rule takes
   at this size) and on the tiled kernel pinned in (1, 2) tiles; the auto
   rule's engine must be the faster of the two in this run (within 5%).
9. tiled_kernel — the tiled kernel (``csrc/tiled_sweep.cu``) against its
   plain version on 68×68×600 (f=17, 4×4 spaxel blocks) cut into 8 tiles
   of (1, 2) blocks: MH 2 sweeps with the same untied injected uniforms
   (every decision; residual, clean, log-scales, χ²), gibbs 1 sweep
   (voxel counts; residual, clean, Δχ²); the in-kernel Philox bits; ms per
   sweep of both, launches per sweep, the kernel's share of device time.
   Then the same comparison and Philox bits on 34×68×3681 in 4 tiles of
   (1, 2) (L=3681, banded LSF; two spaxels per step), and on 153×306×3681
   in two tiles of (9, 9), the full field's planned tile and so its
   per-step shapes: 81 spaxels and 9396 tasks per step, about 71 per block
   through the ring, the widest slabs of gibbs phase (b).  In the first two
   geometries the wavefront schedule against the raster in (1, 1) tiles
   (two tiles per wave), 2 sweeps on the Philox draws, every output
   bit-equal.
10. tiled_vs_whole — one tile, (ny, nx), against the whole-cube kernels on
   30×30×600: 2 MH and 2 gibbs sweeps from one state with the Philox
   draws (the engines differ only in the order of their visits); the
   states must be bit-equal.
11. full_field — a 300×300×3681 MUSE field made on the card, through
   ``Run``: gibbs with the defaults (the tiled kernel in the planned
   (9, 9) tiles, χ² rebaseline every 8 sweeps) for 16 sweeps — every sweep
   one tiled launch, the rebaseline at sweeps 8 and 16 with the running χ²
   within 1e-5 of the from-scratch one just before each reset and at the
   end, acceptance exactly 1 — then MH in the default flow for 8 sweeps:
   ``coarse_every`` resolves to 8, so one global coarse pass runs after
   absolute sweep 8 (its banded Cholesky factors built once, its draws
   through the banded kernel: k·L draws, all accepted), χ² within 1e-5 of
   the from-scratch one after the pass, the sweeps' acceptance in the
   adaptation's early band [0.05, 0.35], the constants' build and
   the pass's ms (CUDA events) and peak bytes; set-up seconds, sweeps/s,
   the planned tile, peak memory of set-up, run and ``full_chi2`` — at
   each gibbs rebaseline the path's λ-chunked ``full_chi2`` and one
   monolithic evaluation on the same state, their peaks and ms: the
   chunked peak must lie below the monolithic one and the two χ² within
   1e-6 of each other —, and one sweep each of the tiled kernel,
   of the whole-cube kernel and of the tiled kernel's earlier design
   (raster of (1, 2) tiles, synchronous loads, one block per spaxel in
   gibbs phase (b)) on the run's state (CUDA events); the auto rule's
   engine must be the faster of the first two (within 5%).
11b. sharded — one chain's sweep on a mesh (``parallel/``), after
   ``coarse``: (a) ``sharded_band_launch``: the tiled kernel's band
   arguments (the TPU kernel's ``y_base``) on 68×68×600 (ny = 4) — a band
   launch on block rows [by0, by0 + nyb) of the whole buffer against one
   on a buffer cut to the band's window whose row 0 is the field's block
   row by0: top, interior and bottom, mh and gibbs, C = 1 and 2, one sweep
   on the Philox draws, residual window, clean, log-scales and outputs
   bit-equal and the cut launch's draws equal to ``ops/philox.py``'s; (b)
   ``sharded_shards_vs_plain``: two shards on one card
   (``Mesh([cuda:0] * 2)``, 136×68×600, all three bands) with
   ``interior='cuda'`` against ``interior='torch'`` (MH 2 sweeps on the
   field's untied Philox uniforms, gibbs 1 on the in-kernel draws), under
   ``compare``'s tolerances, χ² consistency ≤ 1e-5, ms of both; then 2
   chains × 2 shards, each chain bit-equal to itself alone on 1 × 2; (c)
   ``sharded_field``, after ``full_field`` on its cube: the default MH flow
   (8 sweeps and the coarse pass) through ``Run(spatial_mesh=1)`` and
   ``Run(spatial_mesh=Mesh([cuda:0] * 2))``, and 3 gibbs sweeps through
   the latter: 3 band launches per shard and sweep, sweeps/s, χ²
   consistency ≤ 1e-5, peak bytes, ms per band launch (CUDA events) and
   their sum over a sweep against the unsharded tiled sweep of
   ``full_field``, the segment's ms per sweep with its copies, and for MH
   the Run's sweeps/s against the unsharded Run's.
12. coarse — the banded kernels (``csrc/banded.cu``: Cholesky, conditional
   draw) against their plain versions at L = 3681, lw = 11 (the MUSE LSF):
   one system (the global pass's draw), four (its constants' factors) and
   324 (one color of the full field); device ms per launch of both
   (``torch.profiler``), ms per call, the plain loops' ms, the library's
   (``torch.linalg.cholesky`` at 4 systems, ``solve_triangular`` forward
   and backward for the draw at 1).  Then one global and one
   ``soft`` anchor pass on 68×68×600 on the card and on the CPU from one
   state with the same Philox draws: resid, clean, χ², counts.
12b. trunc_normal — the sweeps' truncated-normal device functions,
   elementwise (``trunc_normal_kernel``), against the plain transform on
   the card over α ∈ [−5, 1e4] and uniforms in [2⁻²⁴, 1 − 2⁻²⁴].
12c. positivity — the ``kPos`` kernels at 30×30×600 against the plain
   sweep, bit-equal to each other, in the orthant; ms with the flag off
   and on in turns (off, on, on, off) of the resident kernel, classic K1
   (C = 1 and its ``Run``'s C = 2) and K2; 400-sweep and 2-chain ``Run``s.
12d. gibbs_block — the banded kernels at its shapes (the draw's library
   time at 4 systems), its sweep on the card against the CPU, its ``Run``s.
13. direct — the direct sampler and the MAP (``ops/direct.py``): the
   banded solve kernel (``csrc/banded.cu`` ``banded_solve_kernel``)
   against its plain version on the preconditioner factors of the bench
   cube (dense, 480 frequencies, L = 600; ``torch.cholesky_solve`` on the
   dense factors beside it, and the Cholesky kernel on the bands those
   factors come from) and of 60×60×3681 (1,860 frequencies);
   ``map_estimate`` on the bench cube ('auto' τ, tol 1e-6) with the true
   float64 residual of the card's solution taken on the host (≤ 2 tol)
   and a profile of its CG iterations; 300 draws on an 8×6×6 toy against
   its dense float64 posterior (z-scores, σ ratio, every solve
   converged); ``Run(bench cube, MUSE(), sampler='direct',
   prior_precision='auto')`` for 20 draws → diagnostics → save (draws/s,
   χ² consistency, flags; the solve kernel's launches there are the
   ``kernels`` line's).  After ``full_field``, on its cube: the direct
   sampler at 300×300×3681 (τ = 1e-3, tol 1e-5, at most 600 iterations):
   the preconditioner resolves to radial, the kernel against its plain
   version on its 256 factors and 90,600 columns (and the Cholesky of its
   256 × 3681 bands), each beside its library yardstick where the dense
   factors do not fit at once (``torch.cholesky_solve`` with the columns
   grouped by factor, ``torch.linalg.cholesky`` 32 systems a call; the
   calls' times summed), one ``map_estimate`` and
   2 draws (iterations, s per draw, peak memory, a profile of 3 CG
   iterations).
13b. direct_sharded — the direct sampler and the MAP on a spatial mesh
   (``parallel/direct_sharded.py``), both shards on the one card
   (``Mesh([cuda:0] * 2)``).  On the bench cube: the sharded A(v) and
   M⁻¹(v) (dense and radial) against the unsharded ones (rel ≤ 1e-5);
   ``banded_solve_kernel`` on one slot's kx columns (600 × 480) against
   its plain version and ``torch.cholesky_solve``; ``Run(sampler=
   'direct', prior_precision='auto', spatial_mesh=...)`` for 20 draws →
   diagnostics → save (every solve converged, χ² consistency ≤ 1e-5, two
   solve launches per preconditioner application, iterations and the
   posterior mean beside phase ``direct``'s on the same normals, draws/s,
   ms per CG iteration); ``map_estimate`` on the mesh ('auto' τ, tol
   1e-6; float64 residual on the host ≤ 2 tol, distance from phase
   ``direct``'s MAP).  After ``direct_full_field``, on its cube: the
   sharded MAP (τ = 1e-3, tol 1e-5): iterations, ms per CG iteration
   beside the unsharded MAP's, peak bytes, the ms of one ragged
   all-to-all, the solve kernel at 3681 × 45,600 and 3681 × 45,000
   columns against its plain version.
13c. multihost — the port over 2 processes (``parallel/multihost.py``),
   both ranks on ``cuda:0`` (this script re-run with ``--multihost``, each
   process killed with the others if one fails or its limit passes).  The
   transport: 2 NCCL ranks on one card, then with a distinct
   ``NCCL_HOSTID`` per rank (``nccl_two_ranks_one_card``); NCCL where one
   works, else gloo staged through pinned host buffers (``backend``); a
   1-rank NCCL group through one band segment against the one-slot run.
   Then the 2 ranks, ``initialize(file://…)`` and ``global_mesh(
   local_devices=[cuda:0])``: (a) the band sweeps at 136×68×600 (MH 2,
   gibbs 1, ``run_sweeps_kernel_sharded``), bit-equal to this process's
   ``Mesh([cuda:0] * 2)`` run; (c) 2 chains on a 2 × 1 global mesh, one
   chain row per rank, each chain bit-equal to itself alone; (d) 6 direct
   draws (phase ``direct_sharded`` takes 20: across the ranks of one card
   a CG iteration costs about 15 ms) and the MAP (tol 1e-6) at the bench cube
   against this process's run of them on ``Mesh([cuda:0] * 2)``:
   iterations equal, states and MAP bit-equal (or within 1e-6), one solve
   launch per rank and application, ms per CG iteration; (b) the full field, the default MH flow (8 sweeps and the
   pass) and 3 gibbs sweeps through ``Run(spatial_mesh=global_mesh())``:
   the final state's digest equal to ``sharded_field``'s D = 2 run's, χ²
   consistency ≤ 1e-5, per rank the band launches' ms per sweep (CUDA
   events), the strip exchanges' ms, bytes and count and the segment-end
   gathers' ms (host clock, synchronised), sweeps/s, peak GB.  Every
   rank's digests equal rank 0's.

14. statistics — every sweep kernel held to the exact posterior
   (``deconv3d_tpu_torch/posterior_check.py``, the port's copy of the JAX
   package's ``tests/test_mcmc_vs_direct.py`` machinery).  (a) The
   exact-start rows on both 24×10×10 fields (f = 5; Moffat FWHM 0.7″ heavy,
   0.3″ mild): 32 chains started at exact posterior draws (the JAX
   package's 8 keys and 24 more; the starts from its start seed's normals
   through one Cholesky factor) as one batch, gibbs 300 /
   MH 600 sweeps (heavy) and gibbs 400 / MH 1200 (mild) through the
   whole-cube engine (the resident kernel where ``plan_slabs`` fits the
   batch; the plan is printed), classic K1 pinned and K2 in (1, 1) tiles;
   MH with ``coarse_every=8`` 300 sweeps (the banded draw kernel) and
   ``gibbs_block`` 80 sweeps (a draw launch per color) on the whole-cube
   engine; the JAX package's bounds: max |z_mean| < 7, q95 < 4, the
   variance ratio in (0.08, 8), on the mild field the sharp-variance gates
   (|z_var| max < 7, q95 < 4.5 over the functionals of ≥ 64 dof; at least
   50% (gibbs) / 3% (MH) of them sharp); one launch per sweep of the row's
   kernel.  Each row also prints the figures of its chains 0–7, the JAX
   package's 8-chain row, which are not held: at 8 chains the rows fail
   under the null in the JAX package too (``posterior_check.N_CHAINS``).  (b) The analytic toys of ``tests/test_sampler.py`` (8×4×4,
   float32) through the resident kernel: MH 8000 and gibbs 3000 sweeps,
   mean |z| < 0.2, max |z| < 1, median σ ratio within 0.1 of 1, MH tail
   acceptance in (0.15, 0.35).  (c) 24 seeded geometries (L ∈ {9, 37,
   130}, Y, X ∈ [5, 23], f ∈ {3, 5, 7}, lw ∈ {1, 3, 11}, a masked spaxel,
   mh / gibbs, positivity, C ∈ {1, 3}): 12 sweeps through the resident
   kernel (where it fits), classic K1 and K2 in (1, 1) and (1, 2) tiles on
   their Philox draws — the invariant at 1e-5 of the data's scale, χ²
   within 1e-5, masked spaxels at 0, clean ≥ 0 with positivity — and each
   against its plain version on the same Philox draws (MH untied; the first
   sweep).  One ``{"statistics": ...}`` line; any failure
   fails the smoke.  ``python3 chip_smoke.py --phase statistics`` runs it
   alone after the build (so does ``--phase direct_field``).
15. examples — the three example scripts (``examples/torch_*.py``) through
   their own ``main("cuda")`` at their JAX twins' depth, each in a
   temporary directory with every launch count set to 0 just before it.
   basic (400 gibbs sweeps, ``save``, ``map_estimate``): χ²/dof within
   ``CHI2_DOF_BAND`` of the JAX example's CPU figure, both reconvolved
   peaks at the JAX example's (16, 8, 8), acceptance exactly 1, χ²
   consistency ≤ 1e-5, the five saved products on disk; multichain (8
   chains, gibbs with a coarse pass every 4 sweeps): R̂ finite at every
   voxel of a free spaxel, the pooled mean's shape; sharded (the four
   topologies on slots of the one card): each chain's running χ² within
   1e-5 of its from-scratch χ², topology 3's 2 chains, topology 4's draws
   all converged.  One ``{"examples": ...}`` line: each example's wall
   seconds and the kernels it launched by name and count, with the
   expected ones it did not (``EXAMPLE_KERNELS``) under ``missing`` — a
   finding, not a failure.  ``--phase examples`` runs it alone.
16. checkpoint — checkpoints on the card, bench cube, MH: a ``Run`` (the
   resident kernel) with ``checkpoint_path`` stopped at sweep 8 and a new
   ``Run`` resumed from its NPZ for 4 more sweeps, every field bit-equal to
   12 sweeps without a break; the same state through ``save_state_dcp``
   sync and async (``torch.distributed.checkpoint``, no process group),
   bit-equal after ``load_state_dcp``, each one's seconds and bytes on
   disk; the state written in the JAX package's leaf layout (the port's
   copy of it, ``checkpoint.JAX_LEAVES``, with χ² off by 1e-3) through
   ``Run.resume``, which must rebaseline χ², then 4 sweeps with χ²
   consistency ≤ 1e-5.  One ``{"checkpoint": ...}`` line.  ``--phase
   checkpoint`` runs it alone.

All phases run under PyTorch's default TF32 flags, which must hold after
them.  Then the smoke's wall time, a ``{"kernels": [...]}`` line (the
resident, classic K1 and tiled kernels, each with its launches, ms per
sweep and bound (:func:`sweep_bound`) on its own path — ``main`` /
``gibbs_main``, ``chains``, ``full_field`` — and its error and plain ms
from its comparison phase, at the shape it names; the tiled ones with
their tile, schedule, waves, the widest wave's tiles, steps,
``previous_ms`` and their band launches (``sharded_field``, D = 2:
launches, ms and bound per band launch and per sweep; error and plain ms
at 136×68×600);
K2 with positivity on the ``positivity`` phase's shapes; the banded ones with their launches on the default MH
flow of ``full_field`` and their ms at that flow's shapes; the banded
solve with its launches on the ``direct`` run, and on the
``direct_sharded`` run with its ms at the slots' shapes; the band and solve
launches of each rank of ``multihost``), the
``nvidia-smi`` name/power-limit line, and as the last line ``{"ok": true,
"device": {...}}``.
"""

import dataclasses
import importlib.util
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import _build, chains as ch, sampler as sm
from deconv3d_tpu_torch import checkpoint as ckpt
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import posterior_check as pc
from deconv3d_tpu_torch.ops import banded as bd, coarse as co
from deconv3d_tpu_torch.ops import direct as td
from deconv3d_tpu_torch.ops import philox, sweep as sw, tiled as tl
from deconv3d_tpu_torch.ops import resident as rs
from deconv3d_tpu_torch.ops import truncnorm as tn
from deconv3d_tpu_torch.parallel import Mesh, mesh as pm
from deconv3d_tpu_torch.parallel import direct_sharded as ds
from deconv3d_tpu_torch.parallel import kernel_sharded as ks
from deconv3d_tpu_torch.tile_sweep import field_cube


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


def classic_of(sampler):
    """The whole-cube segment of ``sampler`` pinned to classic K1."""
    seg = segment_of(sampler)
    return lambda *args, **kw: seg(*args, _classic=True, **kw)


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
    kern = sw.mh_segment(problem, copy_state(state), n_sweeps, u,
                         _classic=True)
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
    seg = sw.mh_segment(problem, st, 1, record_uniforms=True, _classic=True)
    want = philox.sweep_uniforms(int(st.key), sweep, n_colors, nij, L,
                                 device="cuda")
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg.uniforms[0], want))
    emit("philox_bits", sweep=sweep, draws=int(want.numel()), equal=equal)
    check(equal, "in-kernel Philox draws differ from ops/philox.py")

    # time per sweep, kernel (Philox draws) and plain, from one state
    n0 = sw.mh_segment.launches
    ms = time_sweeps(lambda n: sw.mh_segment(problem, state, n,
                                             _classic=True), 50)
    launches_per_sweep = (sw.mh_segment.launches - n0) / 51
    plain_ms = time_sweeps(
        lambda n: sw.mh_segment_reference(problem, state, n), 2)
    emit("sweep_time", shape=[L, problem.Y, problem.X], kernel_ms=ms,
         plain_ms=plain_ms, launches_per_sweep=launches_per_sweep)
    check(launches_per_sweep == 1, "expected one kernel launch per sweep")
    phase_profile(problem, state, "mh", seg=classic_of("mh"))
    out = {"max_abs_err": resid_err, "ms": ms, "plain_ms": plain_ms,
           "bound": sweep_bound(problem, 1, kern.accept),
           "n_chains_32": phase_batch_vs_plain(problem, "mh")}
    return out, (problem, state, u, plain, plain_ms)


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
    kern = sw.gibbs_segment(problem, copy_state(state), n_sweeps, u,
                            _classic=True)
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
    seg = sw.gibbs_segment(problem, st, 1, record_uniforms=True,
                           _classic=True)
    want = philox.gibbs_sweep_uniforms(int(st.key), sweep, n_colors, nij, L,
                                       device="cuda")
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg.uniforms[0], want))
    emit("gibbs_philox_bits", sweep=sweep, draws=int(want.numel()),
         equal=equal)
    check(equal, "in-kernel stream-2/3 draws differ from ops/philox.py")

    n0 = sw.gibbs_segment.launches
    ms = time_sweeps(lambda n: sw.gibbs_segment(problem, state, n,
                                                _classic=True), 50)
    launches_per_sweep = (sw.gibbs_segment.launches - n0) / 51
    # one plain sweep, no warm-up: the comparison above ran it already
    plain_ms = timed(
        lambda: sw.gibbs_segment_reference(problem, state, 1))[1]
    emit("gibbs_sweep_time", shape=[L, problem.Y, problem.X], kernel_ms=ms,
         plain_ms=plain_ms, launches_per_sweep=launches_per_sweep)
    check(launches_per_sweep == 1, "expected one kernel launch per sweep")
    phase_profile(problem, state, "gibbs", seg=classic_of("gibbs"))
    out = {"max_abs_err": resid_err, "ms": ms, "plain_ms": plain_ms,
           "bound": sweep_bound(problem, 1, kern.accept),
           "n_chains_32": phase_batch_vs_plain(problem, "gibbs")}
    return out, (problem, state, u, plain, plain_ms)


#: the tiled kernel as it ran before its redesign: a raster of (1, 2)
#: tiles, synchronous loads, gibbs phase (b) on one block per spaxel
PREVIOUS_TILED = dict(tile=(1, 2), schedule="raster", stages=0)

#: NVIDIA H100 SXM peaks (data sheet, 700 W): float32 outside the tensor
#: cores, and HBM3 bandwidth
F32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12


def sweep_bound(problem, C, accept):
    """The least time one sweep of ``C`` chains could take on the card:
    max(flops / float32 peak, bytes / HBM bandwidth), with what bounds it.

    Flops (a multiply or add 1, an fma 2; transcendentals not counted) of
    what this run's data needs: per valid spaxel visit the patch
    contraction (f² L (1 + 2S): resid·w and S fmas) and lin (2S per λ); MH
    the jump's band and Δχ² share (2 lw + 6 per λ) and, per ACCEPTED visit
    (``accept``: the run's decisions), the commit (f² L (2S + 1)) and
    clean += jump; gibbs per λ the transpose band (2 lw), the draw (3), lw
    phase updates (4 each), the Δχ² terms (9) and clean += jump, and the
    commit of every live visit.  Bytes: each input read once, each output
    written once, of what the visits touch: resid read and written whole
    (the committed patches cover it); weights read; per valid spaxel quad,
    and for gibbs qvox and quad_lo, read; clean read and written at the
    committed visits' spaxels only (MH: the accepted ones, gibbs: every
    live visit); LSF, FSF and per-spaxel outputs.  ``accept`` is ignored
    for gibbs.  With positivity MH also reads clean at every valid visit
    and reflects (3 per λ); gibbs' truncated draw adds its mean, σ·z and
    clamp (6 per λ; the transcendentals of the transform not counted)."""
    f, L = problem.f, problem.L
    S, lw = int(problem.fsf_spec.shape[0]), int(problem.lsf.shape[1])
    valid = float(problem.valid.sum())
    visits = C * valid
    patch = f * f * L
    flops = visits * (patch * (1 + 2 * S) + L * 2 * S)
    gibbs = problem.config.sampler == "gibbs"
    if gibbs:
        committed = visits
        flops += visits * (L * (2 * lw + 3 + 4 * lw + 9 + 1)
                           + patch * (2 * S + 1))
    else:
        committed = visits * float(accept.float().mean())
        flops += visits * L * (2 * lw + 6) + committed * (
            patch * (2 * S + 1) + L)
    positivity = bool(problem.config.positivity)
    if positivity:
        flops += visits * L * (6 if gibbs else 3)
    Hp, Wp = problem.w_pad.shape[1:]
    spectrum = L * 4
    nbytes = (2 * C * Hp * Wp * spectrum + Hp * Wp * spectrum
              + valid * spectrum * (3 if gibbs else 1)
              + 2 * committed * spectrum
              + (0 if gibbs or not positivity
                 else (visits - committed) * spectrum)
              + L * lw * 4 + S * (L + f * f) * 4
              + 2 * C * problem.n_colors * problem.ny * problem.nx * 4)
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTE_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def phase_batch_vs_plain(problem, sampler, n_chains=32, n_sweeps=2,
                         states=None):
    """A batch of chains through classic K1 (pinned; one launch per sweep)
    against the plain version of the same batch, same injected uniforms, every
    chain, under ``compare``'s tolerances; the ms per batched sweep of both
    (first calls at this C).  ``states``: the batch's start (default: the
    initial states).  Returns the batch's resid error and the plain ms per
    batched sweep."""
    if states is None:
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
    kern, ms = timed(lambda: classic_of(sampler)(problem, states, n_sweeps,
                                                 u))
    launches = seg.launches - n0
    emit("batch_vs_plain", sampler=sampler, n_chains=n_chains,
         positivity=bool(problem.config.positivity), sweeps=n_sweeps,
         launches=launches, kernel_ms_per_batched_sweep=ms / n_sweeps,
         plain_ms_per_batched_sweep=plain_ms / n_sweeps)
    check(launches == n_sweeps, "expected one launch per sweep for the batch")
    errs = compare(plain, kern, sampler)
    emit("batch_vs_plain_errors", sampler=sampler, n_chains=n_chains, **errs)
    return {"max_abs_err": errs["resid_max_abs_err"],
            "plain_ms": plain_ms / n_sweeps}


def barrier_us(problem, sampler, n=2890):
    """µs per grid barrier of the resident grid at ``problem``'s plan:
    ``n`` barriers of ``resident_barrier_kernel`` on the same blocks,
    threads and shared memory, against none."""
    import ctypes

    from deconv3d_tpu_torch.ops import resident as rs

    lib = _build.load_library()
    S, lw = int(problem.fsf_spec.shape[0]), int(problem.lsf.shape[1])
    lam_b, blocks = rs.plan_slabs(1, problem.f, problem.ny, problem.nx,
                                  problem.L, S, lw, sampler,
                                  *rs.device_limits("cuda"))
    smem = lib.resident_smem_bytes(int(sampler == "gibbs"), 1, problem.f,
                                   problem.ny, problem.nx, problem.L, S, lw,
                                   lam_b)
    threads = 32 * min(problem.f, 18)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(k):
        err = lib.resident_barrier_launch(blocks, threads, smem, k, stream)
        check(err == 0, f"resident_barrier_launch failed: CUDA error {err}")

    run(n)
    times = {k: min(timed(lambda: run(k))[1] for _ in range(5))
             for k in (0, n)}
    return (times[n] - times[0]) / n * 1e3, blocks, threads, smem


def phase_resident(sampler, ctx, classic_ms, n_sweeps=4):
    """The resident kernel at 30×30×600: against the plain sweep on the
    kernel phase's injected uniforms (same tolerances as classic K1) and
    its in-kernel Philox bits; against classic K1 on the Philox draws,
    ``n_sweeps`` from one state, every output bit-equal; ms per sweep of
    both in turns (resident, classic, classic, resident); a profile; the
    µs per grid barrier of its grid."""
    problem, state, u, plain, plain_ms = ctx
    seg, classic = segment_of(sampler), classic_of(sampler)
    n0 = seg.resident_launches
    kern = seg(problem, copy_state(state), u.shape[0], u)
    torch.cuda.synchronize()
    check(seg.resident_launches - n0 == u.shape[0],
          "the resident kernel did not run every sweep")
    errs = compare(plain, kern, sampler)
    emit("resident_vs_plain", sampler=sampler,
         shape=[problem.L, problem.Y, problem.X], sweeps=int(u.shape[0]),
         **errs)

    sweep = 7
    st = copy_state(state)
    st.sweep.fill_(sweep)
    rec = seg(problem, st, 1, record_uniforms=True)
    draws = (philox.sweep_uniforms if sampler == "mh"
             else philox.gibbs_sweep_uniforms)
    want = draws(int(st.key), sweep, problem.n_colors,
                 problem.ny * problem.nx, problem.L, device="cuda")
    torch.cuda.synchronize()
    philox_equal = bool(torch.equal(rec.uniforms[0], want))
    check(philox_equal, "resident in-kernel Philox draws differ")

    res = seg(problem, copy_state(state), n_sweeps)
    cla = classic(problem, copy_state(state), n_sweeps)
    torch.cuda.synchronize()
    rs_, cs_ = res.result.state, cla.result.state
    equal = {name: bool(torch.equal(getattr(rs_, name), getattr(cs_, name)))
             for name in ("resid", "clean", "log_scale", "chi2", "n_accept")}
    equal["accept_or_live"] = bool(torch.equal(res.accept, cla.accept))
    equal["dchi"] = bool(torch.equal(res.dchi, cla.dchi))

    n_time = 50
    ms_r1 = time_sweeps(lambda n: seg(problem, state, n), n_time)
    ms_c1 = time_sweeps(lambda n: classic(problem, state, n), n_time)
    ms_c2 = time_sweeps(lambda n: classic(problem, state, n), n_time)
    ms_r2 = time_sweeps(lambda n: seg(problem, state, n), n_time)
    share = phase_profile(problem, state, sampler, seg=seg,
                          kernel_name=f"resident_{sampler}_kernel"
                          )["kernel_share_of_device"]
    us, blocks, threads, smem = barrier_us(problem, sampler)
    ms = (ms_r1 + ms_r2) / 2
    emit("resident", sampler=sampler,
         shape=[problem.L, problem.Y, problem.X], blocks=blocks,
         threads=threads, smem_bytes=smem, philox_bits_equal=philox_equal,
         vs_classic_sweeps=n_sweeps, bit_equal_to_classic=equal,
         ms_resident_classic_classic_resident=[ms_r1, ms_c1, ms_c2, ms_r2],
         resident_ms=ms, classic_ms=(ms_c1 + ms_c2) / 2,
         classic_ms_kernel_phase=classic_ms,
         speedup=(ms_c1 + ms_c2) / (ms_r1 + ms_r2),
         kernel_share_of_device=share, barrier_us=us,
         barrier_floor_ms=problem.n_colors * us / 1e3)
    check(all(equal.values()),
          f"resident differs from classic K1: {[k for k, v in equal.items() if not v]}")
    return {"max_abs_err": errs["resid_max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "classic_ms": (ms_c1 + ms_c2) / 2,
            "barrier_us": us}


def reset_launches():
    for seg in (sw.mh_segment, sw.gibbs_segment):
        seg.launches = seg.resident_launches = 0
    tl.tiled_mh.launches = tl.tiled_gibbs.launches = 0
    tl.band_mh.launches = tl.band_gibbs.launches = 0
    bd.cholesky_banded.launches = bd.sample_conditional.launches = 0
    bd.banded_solve.launches = 0


def tiled_counter(sampler):
    return tl.tiled_gibbs if sampler == "gibbs" else tl.tiled_mh


def phase_profile(problem, state, sampler, n=100, seg=None,
                  kernel_name=None, per_sweep=1):
    """``torch.profiler`` over ``n`` post-burn-in sweeps of the wrapper
    (default: the whole-cube segment of ``sampler``; ``per_sweep`` launches
    of ``kernel_name`` in each): device time of the kernel and of the torch
    ops around it, and the card's idle share of the wall time (the
    profiler's own overhead included, so an upper bound).  Returns the
    kernel's share of the device time and the ms per sweep of each."""
    from torch.profiler import ProfilerActivity, profile

    st = copy_state(state)
    st.sweep.fill_(problem.config.resolved_burn_in())
    seg = seg or segment_of(sampler)
    kernel_name = kernel_name or f"{sampler}_sweep_kernel"
    seg(problem, st, 1)
    torch.cuda.synchronize()
    # CUPTI may drop an activity record now and then (a smoke on the H100
    # saw 98 of 100 launches), so a trace that misses launches is taken
    # again once before the check fails
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            seg(problem, st, n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kern = [e for e in on_card if kernel_name in e.name]
        if len(kern) == n * per_sweep:
            break
    device_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    emit("profile", sampler=sampler, kernel=kernel_name,
         shape=[problem.L, problem.Y, problem.X], sweeps=n, attempt=attempt,
         wall_ms=wall_ms, device_ms=device_ms, kernel_ms=kernel_ms,
         kernel_launches=len(kern),
         kernel_share_of_device=kernel_ms / max(device_ms, 1e-9),
         other_device_ops_per_sweep=(len(on_card) - len(kern)) / n,
         idle_share=1.0 - device_ms / wall_ms)
    check(len(kern) == n * per_sweep and kernel_ms > 0,
          f"the profiler did not see {per_sweep} kernel launches per sweep")
    return {"kernel_share_of_device": kernel_ms / max(device_ms, 1e-9),
            "wall_ms": wall_ms / n, "device_ms": device_ms / n,
            "kernel_ms": kernel_ms / n, "idle_share": 1.0 - device_ms / wall_ms}


def chi2_consistency(run, chain=0) -> float:
    state = ch.select_chains(run.states, chain)
    chi_full = float(sm.full_chi2(run.problem, state))
    return abs(float(state.chi2) - chi_full) / chi_full


def segment_of(sampler):
    return {"mh": sw.mh_segment, "gibbs": sw.gibbs_segment,
            "gibbs_block": sw.gibbs_block_segment}[sampler]


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
    resident_launches = seg.resident_launches
    files = [f"{out}_{s}" for s in ("clean.fits", "std.fits",
                                    "convolved.fits", "traces.npz",
                                    "stats.json")]
    clean = d3.Cube.from_fits(files[0])
    consistency = chi2_consistency(run)
    acc_post = float(np.mean(run.trace("accept")[0, 200:]))
    emit("main" if sampler == "mh" else "gibbs_main", shape=list(cube.shape),
         sampler=sampler, sweeps=diag["sweeps"],
         resident_launches=resident_launches, classic_launches=launches,
         chi2=diag["chi2"], chi2_consistency=consistency,
         chi2_consistency_after_200=consistency_200,
         acceptance=diag["acceptance_rate"], acceptance_post_burn_in=acc_post,
         **{f"{sampler}_sweeps_per_sec_last_200": 200 / dt},
         proposals_per_sec=200 * run.problem.n_valid / dt)
    check(resident_launches == 400 and launches == 0,
          f"resident kernel launched {resident_launches} times and classic "
          f"K1 {launches}, expected 400 and 0")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    if sampler == "mh":
        check(0.15 <= acc_post <= 0.35, "post-burn-in acceptance out of range")
    else:
        check(diag["acceptance_rate"] == 1.0 and acc_post == 1.0,
              "gibbs acceptance is not exactly 1")
    check(all(os.path.isfile(f) for f in files), "save() files missing")
    check(clean.shape == cube.shape
          and bool(torch.isfinite(clean.data).all()), "bad clean cube")
    return {"launches": resident_launches, "rate": 200 / dt,
            "shape": list(cube.shape),
            "bound": sweep_bound(run.problem, 1, torch.tensor([acc_post]))}


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
    launches, resident_launches = seg.launches, seg.resident_launches
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
         launches=launches, resident_launches=resident_launches,
         states_equal=all(exact.values()),
         not_equal=[k for k, v in exact.items() if not v],
         chi2_rel_vs_alone=chi2_rel, accept_trace_equal=accept_equal,
         rhat_chi2=diag.get("rhat_chi2"),
         rhat_monitor_max=diag.get("rhat_monitor_max"),
         chi2_consistency=consistency,
         chain_sweeps_per_sec=n_chains * n / dt, per_chain_sweeps_per_sec=n / dt,
         single_chain_sweeps_per_sec=single_rate,
         aggregate_over_single=n_chains * n / dt / single_rate)
    # the resident plan does not fit the batch: classic K1 runs it
    check(launches == 2 * n and resident_launches == 0,
          f"classic K1 launched {launches} and the resident kernel "
          f"{resident_launches} times for {2 * n} sweeps of {n_chains} chains")
    # the sweep's arithmetic does not depend on the batch (the kernels'
    # tasks are per chain), so the states must be bit-equal; χ² may differ
    # by float32 rounding only: the per-sweep Δχ² sum reduces a [C, f², nij]
    # tensor whose order torch may choose by C
    check(all(exact.values()), "batched chains differ from chains run alone")
    check(chi2_rel <= 1e-6, "batched chi2 differs from chains run alone")
    check(accept_equal, "batched MH decisions differ from chains run alone")
    check(np.isfinite(diag["rhat_chi2"]), "R-hat is not finite")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    # classic K1's ms per batched sweep on the run's own state and shapes
    ms = time_sweeps(lambda k: classic_of(sampler)(run.problem, run.states,
                                                   k), 8)
    accept = torch.as_tensor(run.trace("accept")[:, n:])
    emit("chains_sweep_time", sampler=sampler, n_chains=n_chains,
         kernel_ms_per_batched_sweep=ms)
    return {"launches": launches, "ms": ms, "shape": list(cube.shape),
            "bound": sweep_bound(run.problem, n_chains, accept)}


#: the engine ``engine='auto'`` picks may be this much slower than the other
#: one in a run before the smoke fails: two engines level within the run's
#: noise must not fail it
AUTO_ENGINE_SLACK = 0.05


def check_auto_engine(phase, sampler, auto, ms):
    """``auto`` is the faster of the two engines timed in ``ms`` (ms per
    sweep by engine), within :data:`AUTO_ENGINE_SLACK`."""
    other = next(e for e in ms if e != auto)
    emit(f"{phase}_auto_engine", sampler=sampler, auto=auto,
         ms_per_sweep=ms, faster=min(ms, key=ms.get),
         auto_over_other=ms[auto] / ms[other])
    check(ms[auto] <= (1 + AUTO_ENGINE_SLACK) * ms[other],
          f"engine='auto' takes {auto} ({ms[auto]:.1f} ms per sweep), but "
          f"{other} takes {ms[other]:.1f}")


def phase_full_lambda(sampler, n):
    """60×60×3681 through ``Run``: the whole-cube kernel (K1, which the auto
    rule takes at this size) beside the tiled kernel pinned in (1, 2) tiles
    (K2), and the auto rule's choice held against the two rates."""
    cube = bench_cube(L=3681, Y=60, X=60)
    ms, warm = {}, 2
    for engine, kw in (("cuda", {}), ("cuda_tiled", {"tile": (1, 2)})):
        run = d3.Run(cube, d3.MUSE(), max_iterations=n + warm,
                     burn_in=(n + warm) // 2, seed=0, sampler=sampler,
                     engine=engine, **kw)
        check(run.problem.config.engine == engine,
              f"engine {engine!r} resolved to {run.problem.config.engine}")
        seg = segment_of(sampler) if engine == "cuda" else tiled_counter(sampler)
        reset_launches()
        run.run(warm)           # first launches, the allocator's growth
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = seg.launches
        consistency = chi2_consistency(run)
        ms[engine] = dt / n * 1e3
        emit("full_lambda", sampler=sampler, shape=list(cube.shape),
             engine=engine, tile=run.problem.config.tile,
             f=run.problem.f, lsf_width=int(run.problem.lsf.shape[1]),
             launches=launches, chi2_consistency=consistency,
             sweeps_per_sec=n / dt, acceptance=run.acceptance_rate)
        check(launches == n + warm, "kernel did not run every sweep")
        check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    p = run.problem
    auto, _ = sm.resolve_engine(sm.RunConfig(sampler=sampler), p.device, p.f,
                                p.ny, p.nx, p.L)
    check_auto_engine("full_lambda", sampler, auto, ms)


def compare(plain, kern, sampler):
    """Errors of a kernel segment against its plain version (same inputs)
    and the checks of PERF.md §2: MH decisions equal, resid and clean
    within 1e-4 of their scale, log-scales 1e-6, χ² rtol 1e-5; gibbs voxel
    counts equal and per-spaxel Δχ² within 1e-4 of its scale."""
    ps, ks = plain.result.state, kern.result.state
    out = {
        "resid_max_abs_err": float((ps.resid - ks.resid).abs().max()),
        "resid_tol": 1e-4 * float(ps.resid.abs().max()),
        "clean_max_abs_err": float((ps.clean - ks.clean).abs().max()),
        "clean_tol": 1e-4 * float(ps.clean.abs().max()),
        "chi2_rel_err": float(((ps.chi2 - ks.chi2).abs() / ps.chi2).max()),
        "dchi_max_abs_err": float((plain.dchi - kern.dchi).abs().max()),
        "dchi_tol": 1e-4 * float(plain.dchi.abs().max()),
        "decisions_or_counts_equal": bool(torch.equal(plain.accept,
                                                      kern.accept)),
        "decisions_or_voxels": int(plain.accept.numel() if sampler == "mh"
                                   else plain.accept.sum()),
    }
    if sampler == "mh":
        out["log_scale_max_abs_err"] = float(
            (ps.log_scale - ks.log_scale).abs().max())
    try:
        compare_checks(out, kern, sampler)
    except AssertionError:
        emit("compare_failed", sampler=sampler, **out)
        raise
    return out


def compare_checks(out, kern, sampler):
    check(out["decisions_or_counts_equal"],
          "accept decisions / voxel counts differ")
    check(out["resid_max_abs_err"] <= out["resid_tol"], "residual differs")
    check(out["clean_max_abs_err"] <= out["clean_tol"], "clean cube differs")
    check(out["chi2_rel_err"] <= 1e-5, "chi2 differs")
    if sampler == "mh":
        check(out["log_scale_max_abs_err"] <= 1e-6, "log-scales differ")
    else:
        check(out["dchi_max_abs_err"] <= out["dchi_tol"],
              "per-spaxel dchi2 differs")
        check(int(kern.accept.sum()) > 0, "no voxel drawn; check is vacuous")


def tiled_compare(cube, tile, sampler, n_sweeps, seed, **config):
    """The tiled kernel against its plain version on ``cube`` cut into
    tiles of ``tile`` spaxel blocks: ``n_sweeps`` from one state with the
    same injected uniforms (MH: untied), every decision or voxel count;
    then the in-kernel Philox bits.  Returns the problem, the state, the
    errors, and the ms per sweep of the compared kernel and plain runs.
    ``config``: more ``RunConfig`` fields (positivity)."""
    problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, tile=tile, **config))
    check(problem.config.engine == "cuda_tiled"
          and problem.config.tile == tile, "engine/tile not resolved")
    state = sm.init_state(problem)
    L, n_colors, nij = problem.L, problem.n_colors, problem.ny * problem.nx
    per = (L + 1,) if sampler == "mh" else (2, L)
    rng = np.random.default_rng(seed)
    u = rng.random((n_sweeps, n_colors, nij, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, plain = sw.untie_uniforms(problem, state, n_sweeps, u,
                                     reference=tl.tiled_segment_reference)
        plain_ms = None         # the untie passes ran it more than once
    else:
        plain, plain_ms = timed(lambda: tl.tiled_segment_reference(
            problem, state, n_sweeps, u))
        plain_ms /= n_sweeps
    counter = tiled_counter(sampler)
    n0 = counter.launches
    kern, kernel_ms = timed(lambda: tl.tiled_segment(
        problem, copy_state(state), n_sweeps, u))
    check(counter.launches - n0 == n_sweeps, "one launch per sweep")
    errs = compare(plain, kern, sampler)
    emit("tiled_kernel_vs_plain", sampler=sampler, **config,
         shape=[L, problem.Y, problem.X], f=problem.f, tile=tile,
         lsf_width=int(problem.lsf.shape[1]),
         n_tiles=(problem.ny // tile[0]) * (problem.nx // tile[1]),
         sweeps=n_sweeps, **errs)

    # in-kernel Philox draws against ops/philox.py, bit for bit
    sweep = 7
    st = copy_state(state)
    st.sweep.fill_(sweep)
    seg = tl.tiled_segment(problem, st, 1, record_uniforms=True)
    draws = (philox.sweep_uniforms if sampler == "mh"
             else philox.gibbs_sweep_uniforms)
    want = draws(int(st.key), sweep, n_colors, nij, L, device="cuda")
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg.uniforms[0], want))
    emit("tiled_philox_bits", sampler=sampler, shape=[L, problem.Y, problem.X],
         sweep=sweep, draws=int(want.numel()), equal=equal)
    check(equal, "in-kernel Philox draws differ from ops/philox.py")
    return problem, state, errs, kernel_ms / n_sweeps, plain_ms, kern


def wave_vs_raster(cube, sampler, tile=(1, 1), n_sweeps=2):
    """The tiled kernel with the wavefront schedule against the raster
    schedule on ``cube`` in ``tile`` tiles (several tiles per wave), from
    one state with the Philox draws: every output bit-equal; the ms per
    sweep of both."""
    problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, tile=tile))
    state = sm.init_state(problem)
    waves = {s: tl.wave_schedule(problem.ny // tile[0], problem.nx // tile[1],
                                 s) for s in tl.SCHEDULES}
    seg, ms = {}, {}
    for schedule in tl.SCHEDULES:
        seg[schedule], ms[schedule] = timed(lambda: tl.tiled_segment(
            problem, copy_state(state), n_sweeps, schedule=schedule))
    a, b = seg["wavefront"], seg["raster"]
    equal = {name: bool(torch.equal(getattr(a.result.state, name),
                                    getattr(b.result.state, name)))
             for name in ("resid", "clean", "log_scale", "chi2", "n_accept")}
    equal["accept_or_live"] = bool(torch.equal(a.accept, b.accept))
    equal["dchi"] = bool(torch.equal(a.dchi, b.dchi))
    emit("tiled_wave_vs_raster", sampler=sampler,
         shape=[problem.L, problem.Y, problem.X], tile=tile, sweeps=n_sweeps,
         waves={s: len(w) for s, w in waves.items()},
         widest_wave=max(map(len, waves["wavefront"])), bit_equal=equal,
         ms_per_sweep={s: v / n_sweeps for s, v in ms.items()})
    check(max(map(len, waves["wavefront"])) > 1, "no wave holds two tiles")
    check(int(a.accept.sum()) > 0, "nothing drawn; the check is vacuous")
    check(all(equal.values()), "the wavefront schedule differs from the "
          f"raster: {[k for k, v in equal.items() if not v]}")


#: the tile the planner takes at the full MUSE field (``ops/tiled.py::
#: plan_tiles`` under ``WINDOW_BUDGET_BYTES``; ``phase_full_field`` checks it)
FIELD_TILE = (9, 9)


def phase_tiled_kernel(tile=(1, 2)):
    """The tiled kernel against its plain version, MH 2 sweeps and gibbs 1,
    in three MUSE geometries (f=17).  68×68×600 in 8 tiles of (1, 2) spaxel
    blocks — then ms per sweep of both versions, launches per sweep and a
    profile.  34×68×3681 in 4 such tiles: 116 λ-chunks per spaxel and the
    banded LSF, two spaxels per step (232 tasks, at most two per block;
    narrow slabs in gibbs phase (b)).  153×306×3681 in two tiles of
    :data:`FIELD_TILE`: the full field's per-step shapes — 81 spaxels per
    step, so every block walks about 71 tasks through its ring, MH commits
    in batches, and gibbs phase (b) runs in the widest slabs — from which
    the ``kernels`` line takes the error and the plain version's time.  In
    the first two, the wavefront schedule against the raster in (1, 1)
    tiles, bit for bit."""
    out = {}
    small = bench_cube(L=600, Y=68, X=68)
    for sampler, n_sweeps, seed in (("mh", 2, 4), ("gibbs", 1, 5)):
        problem, state, errs, _, plain_ms, kern = tiled_compare(
            small, tile, sampler, n_sweeps, seed)
        counter = tiled_counter(sampler)
        n0 = counter.launches
        n_time = 20 if sampler == "mh" else 10
        ms = time_sweeps(lambda n: tl.tiled_segment(problem, state, n),
                         n_time)
        per_sweep = (counter.launches - n0) / (n_time + 1)
        if sampler == "mh":
            plain_ms = timed(
                lambda: tl.tiled_segment_reference(problem, state, 1))[1]
        share = phase_profile(problem, state, sampler, n=n_time,
                              seg=tl.tiled_segment,
                              kernel_name=f"tiled_{sampler}_kernel"
                              )["kernel_share_of_device"]
        emit("tiled_sweep_time", sampler=sampler,
             shape=[problem.L, problem.Y, problem.X], tile=tile, kernel_ms=ms,
             plain_ms=plain_ms, launches_per_sweep=per_sweep,
             kernel_share_of_device=share)
        check(per_sweep == 1, "expected one kernel launch per sweep")
        out[sampler] = {"at_600x68x68": {
            "max_abs_err": errs["resid_max_abs_err"], "ms": ms,
            "plain_ms": plain_ms,
            "bound": sweep_bound(problem, 1, kern.accept)}}
        wave_vs_raster(small, sampler)
    del small, problem, state, kern
    large = field_cube(L=3681, Y=34, X=68)
    for sampler, n_sweeps, seed in (("mh", 2, 6), ("gibbs", 1, 7)):
        t0 = time.perf_counter()
        _, _, errs, kernel_ms, plain_ms, _ = tiled_compare(
            large, tile, sampler, n_sweeps, seed)
        emit("tiled_kernel_full_lambda", sampler=sampler,
             shape=list(large.shape), tile=tile, kernel_ms_per_sweep=kernel_ms,
             plain_ms_per_sweep=plain_ms, seconds=time.perf_counter() - t0)
        out[sampler]["max_abs_err_3681x34x68"] = errs["resid_max_abs_err"]
        wave_vs_raster(large, sampler)
    del large
    wide = field_cube(L=3681, Y=153, X=306)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for sampler, n_sweeps, seed in (("mh", 1, 8), ("gibbs", 1, 9)):
        t0 = time.perf_counter()
        problem, state, errs, kernel_ms, plain_ms, _ = tiled_compare(
            wide, FIELD_TILE, sampler, n_sweeps, seed)
        if sampler == "mh":
            plain_ms = timed(lambda: tl.tiled_segment_reference(
                problem, state, 1))[1]
        spaxels = FIELD_TILE[0] * FIELD_TILE[1]
        emit("tiled_kernel_field_tile", sampler=sampler,
             shape=list(wide.shape), tile=FIELD_TILE,
             spaxels_per_step=spaxels,
             tasks_per_step=spaxels * -(-problem.L // 32),
             phase_slab=sw.phase_slab(problem.L, spaxels, n_sm),
             kernel_ms_per_sweep=kernel_ms, plain_ms_per_sweep=plain_ms,
             seconds=time.perf_counter() - t0)
        out[sampler].update(max_abs_err=errs["resid_max_abs_err"],
                            plain_ms=plain_ms, shape=list(wide.shape))
        del problem, state
    return out


def phase_tiled_vs_whole(n_sweeps=2):
    """One tile, (ny, nx), is the whole-cube kernel's sweep: K2 against K1
    on 30×30×600 from one state with the Philox draws."""
    cube = bench_cube()
    for sampler in ("mh", "gibbs"):
        whole = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler))
        check(whole.config.engine == "cuda", "bench geometry left K1")
        state = sm.init_state(whole)
        k1 = segment_of(sampler)(whole, copy_state(state), n_sweeps)
        n0 = tiled_counter(sampler).launches
        k2 = tl.tiled_segment(whole, copy_state(state), n_sweeps,
                              tile=(whole.ny, whole.nx))
        torch.cuda.synchronize()
        check(tiled_counter(sampler).launches - n0 == n_sweeps,
              "the tiled kernel did not run")
        errs = compare(k1, k2, sampler)
        bit_equal = all(torch.equal(getattr(k1.result.state, name),
                                    getattr(k2.result.state, name))
                        for name in ("resid", "clean", "log_scale", "chi2"))
        emit("tiled_vs_whole", sampler=sampler, shape=list(cube.shape),
             tile=[whole.ny, whole.nx], sweeps=n_sweeps,
             states_bit_equal=bit_equal, **errs)
        check(bit_equal, "one tile is not the whole-cube kernel bit for bit")


#: the banded kernels against their plain versions, of the output's scale
#: (float32: the sums run in another order, and the solves amplify rounding
#: by the system's condition; at the MUSE LSF, L = 3681, the plain float32
#: draw is 7e-5 and the factor 4e-6 of its scale off float64, on the CPU)
BANDED_TOL = {"cholesky": 1e-4, "sample": 1e-3}

#: the pass on the card against the pass on the CPU, same problem, state
#: and Philox draws, of each output's scale: convolutions round
#: differently on the two devices, and the global draw amplifies that by
#: its conditional's condition (a 1e-7 relative change of the weights
#: moves the global pass's clean jump by 5.5e-5 of its scale and the
#: residual by 1e-7 on the CPU, 68×68×600)
PASS_TOL = {"resid": 1e-4, "clean": 1e-3, "chi2": 1e-5}


def banded_bound(kind, n_sys, L, p):
    """The least time one banded launch could take: each input read and
    each output written once, against the HBM rate; flops per row (an fma
    2, a division or square root 1): the Cholesky (P + 1)² + 1, the draw
    4P + 4 (both solves).  Its latency form: the dependent steps of one
    system's chain (:func:`chain_steps`; the Cholesky's L rows)."""
    W = p + 1
    if kind == "cholesky":
        nbytes, flops = 2 * n_sys * L * W * 4, n_sys * L * (W * W + 1)
        steps = L
    else:
        nbytes, flops = n_sys * L * (W + 3) * 4, n_sys * L * (4 * p + 4)
        steps = chain_steps(n_sys, L, p, "sample")
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTE_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "latency_steps": steps}


def chain_steps(n, L, p, kind):
    """Dependent steps of one draw or solve launch (both solves) for ``n``
    systems or columns: 2·(2m + S − 1) for the kernels' S segments of m
    rows (the first pass, the carry's rounds, the re-run), 2·L
    unsegmented (the design before the segments)."""
    S = bd.segments(n, L, p, kind)
    return 2 * L if S == 1 else 2 * (2 * bd.segment_rows(L, S) + S - 1)


def device_ms(fn, name, n=20):
    """Mean device time of a launch of the kernels named ``name`` over
    ``n`` calls of ``fn`` (after a warm-up), from ``torch.profiler``
    (CUPTI; the launches it recorded, taken again up to 4 times while it
    records none, which CUPTI on the card now and then does): the
    kernel's own time, where CUDA events around the calls time the host
    too once a call's Python outlasts its kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        keys = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in keys)
        if count:
            break
    check(count > 0, f"the profiler saw no launch of {name}")
    return sum(e.device_time_total for e in keys) / count / 1e3


def cholesky_library_ms(bands, chunk=None):
    """ms of ``torch.linalg.cholesky`` on the dense matrices of ``bands``
    (the same function as the banded Cholesky: its lower factor is Rᵀ),
    one call after a warm-up, CUDA events.  ``chunk``: that many systems
    per call (the full field's 256 dense 3681² matrices take 13.9 GB), the
    calls' times summed; the dense matrices are built outside the timed
    calls."""
    chunk = chunk or bands.shape[0]
    ms = 0.0
    with cv.no_tf32():
        for lo in range(0, bands.shape[0], chunk):
            A = dense_bands(bands[lo:lo + chunk])
            if lo == 0:
                torch.linalg.cholesky(A)
            ms += timed(lambda: torch.linalg.cholesky(A))[1]
            del A
    return ms


#: factors per dense call of the full field's library yardsticks (8 calls
#: of 1.7 GB each)
LIBRARY_CHUNK = 32


def solve_library_grouped_ms(R, fidx, b, want, chunk=LIBRARY_CHUNK):
    """ms of ``torch.cholesky_solve`` on the dense factors of ``R`` with
    the columns of ``b`` ``[L, n]`` grouped by the factor ``fidx`` names
    (one call per referenced factor on all its columns; the full field's
    90,600 columns share 256 factors), summed over the calls (CUDA events;
    the dense factors and the gathered columns are built outside them,
    ``chunk`` factors at a time, after a warm-up call); and the largest
    difference from ``want``, the plain version's solution."""
    groups = [(k, torch.nonzero(fidx == k).reshape(-1))
              for k in torch.unique(fidx).tolist()]
    ms, err = 0.0, 0.0
    with cv.no_tf32():
        for lo in range(0, len(groups), chunk):
            part = groups[lo:lo + chunk]
            U = dense_upper(R[[k for k, _ in part]])
            rhs = [b[:, cols].contiguous() for _, cols in part]
            if lo == 0:
                torch.cholesky_solve(rhs[0], U[0], upper=True)
            out, t = timed(lambda: [torch.cholesky_solve(r, U[i], upper=True)
                                    for i, r in enumerate(rhs)])
            ms += t
            for (_, cols), x in zip(part, out):
                err = max(err, float((x - want[:, cols]).abs().max()))
            del U, rhs, out
    return ms, err


def cholesky_vs_plain(bands, library=False):
    """The Cholesky kernel on ``bands`` ``[n, L, W]`` against its plain
    loop (error within ``BANDED_TOL``): device ms per launch
    (:func:`device_ms`), ms per call (CUDA events, host included), the
    plain loop's ms, the bound; with ``library``
    ``torch.linalg.cholesky``'s ms on the dense matrices."""
    n_sys, L, W = bands.shape
    R, call_ms = ms_per_call(lambda: bd.cholesky_banded(bands), 20)
    ms = device_ms(lambda: bd.cholesky_banded(bands), "banded_cholesky_kernel")
    R_ref, plain_ms = timed(lambda: bd.cholesky_banded_reference(bands))
    err, scale = float((R - R_ref).abs().max()), float(R_ref.abs().max())
    check(err <= BANDED_TOL["cholesky"] * scale,
          f"banded Cholesky kernel differs from its plain version "
          f"({n_sys} x {L})")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "tol": BANDED_TOL["cholesky"] * scale,
            "library_ms": cholesky_library_ms(bands) if library else None,
            "bound": banded_bound("cholesky", n_sys, L, W - 1)}


def draw_library_ms(R, b, noise):
    """ms of ``torch.linalg.solve_triangular`` on the dense factors of
    ``R``, forward then backward (the banded draw's function: Rᵀz = b, Rx
    = z + noise), one pair after a warm-up, CUDA events."""
    U = dense_upper(R)

    def solves():
        z = torch.linalg.solve_triangular(U.transpose(-1, -2), b[..., None],
                                          upper=False)
        return torch.linalg.solve_triangular(U, z + noise[..., None],
                                             upper=True)
    with cv.no_tf32():
        solves()
        ms = timed(solves)[1]
    del U
    return ms


def ms_per_call(fn, n):
    """``fn()`` (after a warm-up call) and its mean ms over ``n`` calls
    between CUDA events."""
    fn()
    out, ms = timed(lambda: [fn() for _ in range(n)])
    return out[-1], ms / n


def phase_coarse(L=3681):
    """The banded kernels against their plain versions at the MUSE LSF (lw
    11) and L = 3681: 1 system (the global pass's draw), 4 (its constants'
    factors, one batched launch) and 324 (one color of the full field);
    then one global and one soft pass on 68×68×600 on the card and on the
    CPU from one state with the same Philox draws."""
    lam = 4750.0 + 1.25 * np.arange(L)
    lsf = torch.tensor(d3.MUSE().lsf.bank(lam, cdelt=1.25, width=None),
                       dtype=torch.float32).cuda()
    lw = int(lsf.shape[1])
    check(lw == 11, f"the MUSE LSF has {lw} taps, expected 11")
    rng = np.random.default_rng(10)
    out = {}
    for n_sys in (1, 4, 324):
        q = torch.tensor(1.0 + rng.random((n_sys, L)),
                         dtype=torch.float32).cuda()
        bands = bd.precision_bands(lsf, q)
        chol = cholesky_vs_plain(bands, library=n_sys == 4)
        R_ref = bd.cholesky_banded_reference(bands)
        b, noise = (torch.tensor(rng.standard_normal((n_sys, L)),
                                 dtype=torch.float32).cuda()
                    for _ in range(2))
        x, call_ms = ms_per_call(
            lambda: bd.sample_conditional(R_ref, b, noise), 20)
        ms = device_ms(lambda: bd.sample_conditional(R_ref, b, noise),
                       "banded_sample_kernel")
        x_ref, plain_ms = timed(
            lambda: bd.sample_conditional_reference(R_ref, b, noise))
        err, scale = (float((x - x_ref).abs().max()),
                      float(x_ref.abs().max()))
        out[n_sys] = {
            "cholesky": chol,
            "sample": {"max_abs_err": err, "ms": ms,
                       "call_ms": call_ms, "plain_ms": plain_ms,
                       "library_ms": draw_library_ms(R_ref, b, noise)
                       if n_sys == 1 else None,
                       "bound": banded_bound("sample", n_sys, L, lw - 1)}}
        emit("banded_kernel_vs_plain", L=L, lw=lw, n_systems=n_sys,
             cholesky_library_ms=chol["library_ms"],
             cholesky_call_ms=chol["call_ms"], cholesky_tol=chol["tol"],
             sample_library_ms=out[n_sys]["sample"]["library_ms"],
             sample_call_ms=call_ms,
             sample_latency_steps=out[n_sys]["sample"]["bound"][
                 "latency_steps"],
             **{f"{k}_{n}": v[n] if n != "bound" else v[n]["bound_ms"]
                for k, v in out[n_sys].items()
                for n in ("max_abs_err", "ms", "plain_ms", "bound")},
             sample_tol=BANDED_TOL["sample"] * scale)
        check(err <= BANDED_TOL["sample"] * scale,
              f"banded sample kernel differs from its plain version "
              f"({n_sys} systems)")

    cube = bench_cube(L=600, Y=68, X=68)
    card = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(seed=0))
    cpu = sm.make_problem(cube.to("cpu"), d3.MUSE(), sm.RunConfig(seed=0),
                          device="cpu")
    state = sm.run_sweeps(card, sm.init_state(card), 2).state
    state_cpu = sm.SamplerState(**{k: v.cpu() for k, v in vars(state).items()})
    for mode in ("global", "soft"):
        # the first build of the process also starts cuBLAS and cuDNN
        # for these shapes: timed twice
        build_ms = [timed(lambda: co.coarse_constants(card, mode))[1]]
        consts, ms = timed(lambda: co.coarse_constants(card, mode))
        build_ms.append(ms)
        got, pass_ms = timed(lambda: co.coarse_pass(card, state, consts))
        t0 = time.perf_counter()
        want = co.coarse_pass(cpu, state_cpu,
                              co.coarse_constants(cpu, mode))
        cpu_s = time.perf_counter() - t0
        errs = {n: float((getattr(got, n).cpu() - getattr(want, n)).abs().max())
                / float(getattr(want, n).abs().max())
                for n in ("resid", "clean")}
        errs["chi2"] = abs(float(got.chi2) - float(want.chi2)) / float(want.chi2)
        counts = [float(got.n_accept - state.n_accept),
                  float(want.n_accept - state_cpu.n_accept),
                  float(got.n_propose - state.n_propose),
                  float(want.n_propose - state_cpu.n_propose)]
        full = float(sm.full_chi2(card, got))
        consistency = abs(float(got.chi2) - full) / full
        emit("coarse_pass_card_vs_cpu", mode=mode, shape=list(cube.shape),
             f=card.f, patterns=len(consts) if mode != "global"
             else int(consts[0][1].shape[0]),
             rel_err=errs, rel_tol=PASS_TOL,
             accepted_card_cpu_proposed_card_cpu=counts,
             chi2_consistency_card=consistency,
             constants_ms_first_then_warm=build_ms,
             pass_ms=pass_ms, cpu_pass_s=cpu_s)
        for n, tol in PASS_TOL.items():
            check(errs[n] <= tol, f"{mode} pass on the card differs from the "
                  f"CPU in {n}")
        check(counts[0] == counts[1] > 0 and counts[2] == counts[3],
              f"{mode} pass accept / proposal counts differ: {counts}")
        check(consistency <= 1e-5, "running chi2 drifted in the pass")
    return out


def positivity_run(sampler, n=400, n_chains=1):
    """``Run(..., positivity=True)`` on the bench cube for ``n`` sweeps (a
    burn-in of n/2): every sweep one launch of the sweep kernel with
    positivity compiled in (the resident kernel for one chain, classic K1
    for a batch the resident plan does not fit), the chain in the orthant,
    χ² consistency ≤ 1e-5, MH acceptance after burn-in in [0.15, 0.35]
    (for n ≥ 400: shorter runs are still in the adaptation's transient),
    gibbs acceptance exactly 1; sweeps/s of the last n/2."""
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), max_iterations=n, burn_in=n // 2, seed=0,
                 sampler=sampler, positivity=True, n_chains=n_chains)
    check(run.problem.config.engine == "cuda", "Run did not pick the kernel")
    seg = segment_of(sampler)
    reset_launches()
    run.run(n // 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(n // 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"resident": seg.resident_launches, "classic": seg.launches}
    diag = run.diagnostics()
    acc_post = float(np.mean(run.trace("accept")[:, n // 2:]))
    consistency = max(chi2_consistency(run, c) for c in range(n_chains))
    clean_min = float(run.states.clean.min())
    kernel = "resident" if n_chains == 1 else "classic"
    emit("positivity_run", sampler=sampler, n_chains=n_chains,
         shape=list(cube.shape), sweeps=diag["sweeps"], kernel=kernel,
         launches=launches, chi2=diag["chi2"], chi2_consistency=consistency,
         acceptance_post_burn_in=acc_post, clean_min=clean_min,
         sweeps_per_sec_last_half=(n // 2) / dt)
    check(launches[kernel] == n and sum(launches.values()) == n,
          f"positivity {sampler}: launches {launches}, expected {n} "
          f"{kernel}")
    check(clean_min >= 0.0, "a positivity chain left the orthant")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    if sampler == "gibbs":
        check(diag["acceptance_rate"] == 1.0 and acc_post == 1.0,
              "gibbs acceptance is not exactly 1")
    elif n >= 400:       # a short run is still in the adaptation's transient
        check(0.15 <= acc_post <= 0.35, "post-burn-in acceptance out of range")
    if n_chains == 1:
        with tempfile.TemporaryDirectory() as tmp:
            run.save(os.path.join(tmp, f"pos_{sampler}"))
            check(os.path.isfile(os.path.join(tmp, f"pos_{sampler}_clean.fits")),
                  "save() files missing")
    accept = torch.as_tensor(run.trace("accept")[:, n // 2:])
    return run, {"launches": launches[kernel], "rate": (n // 2) / dt,
                 "shape": list(cube.shape), "n_chains": n_chains,
                 "bound": sweep_bound(run.problem, n_chains, accept)}


#: the card's truncated-normal draw against the plain transform, of
#: max(1, |z|), where float32 can resolve the draw: every tail draw, and
#: the body's where 1 − p ≥ 2⁻¹² (nearer p = 1 an ulp of p moves z by
#: more, and where p rounds to 1 the body caps at α + 9: an ulp of Φ(α)
#: decides which)
TRUNC_TOL = 1e-4
TRUNC_BODY_MIN_1MP = 2.0**-12


def phase_trunc_normal():
    """The sweep kernels' truncated-normal draw (``csrc/gibbs_step.cuh``
    ``trunc_normal``, the device functions of their λ-phases, elementwise
    through ``trunc_normal_kernel``) against the plain transform
    (``ops/truncnorm.py``) in float64 on the same float32 inputs on the
    card: α over [−5, 1e4] (the body, the switch at 2 and just above it,
    the tail) against uniforms from 2⁻²⁴ to 1 − 2⁻²⁴; max |Δz| / max(1,
    |z|) ≤ ``TRUNC_TOL`` where float32 resolves the draw, and every draw
    finite in [α, α + 9] in the body's last strip; ms of both."""
    alpha = np.concatenate([np.linspace(-5.0, 10.0, 1501),
                            2.0 + np.geomspace(1e-6, 1e-2, 100),
                            np.geomspace(10.0, 1e4, 500)])
    u = np.concatenate([np.geomspace(2.0**-24, 0.5, 200),
                        1.0 - np.geomspace(2.0**-24, 0.5, 200)])
    a, u1 = (torch.tensor(x.ravel(), dtype=torch.float32).cuda()
             for x in np.meshgrid(alpha, u))
    u2 = u1.flip(0).contiguous()
    n0 = tn.trunc_normal.launches
    z, ms = ms_per_call(lambda: tn.trunc_normal(a, u1, u2), 20)
    launches = tn.trunc_normal.launches - n0
    _, plain_ms = timed(lambda: tn.transform_uniforms(a, u1, u2))
    a64, u64 = a.double(), u1.double()
    want = tn.transform_uniforms(a64, u64, u2.double())
    rel = (z.double() - want).abs() / want.abs().clamp(min=1.0)
    cdf = torch.special.ndtr(a64)
    tail = a > tn.TAIL_SWITCH
    resolved = tail | ((1.0 - cdf) * (1.0 - u64) >= TRUNC_BODY_MIN_1MP)
    err = float(rel[resolved].max())
    edge = ~resolved
    in_range = bool(((z[edge] >= a[edge]) & (z[edge] <= a[edge] + 9.0)).all())
    emit("trunc_normal_vs_plain", n=int(a.numel()), launches=launches,
         max_rel_err=err, max_rel_err_tail=float(rel[tail].max()),
         max_rel_err_body=float(rel[resolved & ~tail].max()),
         body_strip_draws=int(edge.sum()),
         body_strip_max_rel_err=float(rel[edge].max()),
         body_strip_in_range=in_range, tol=TRUNC_TOL, ms=ms,
         plain_ms=plain_ms, tail_steps=tn.NEWTON_STEPS)
    check(launches == 21 and bool(torch.isfinite(z).all()),
          "trunc_normal_kernel did not run or gave a non-finite draw")
    check(err <= TRUNC_TOL, "the card's truncated-normal draw differs from "
          "the plain transform")
    check(in_range, "a body draw near p = 1 left [α, α + 9]")
    check(bool((z >= a - 1e-3 * a.abs().clamp(min=1.0)).all()),
          "a truncated draw fell below its bound")


def phase_positivity():
    """``positivity=True`` on the card.  At 30×30×600, from a state 4
    sweeps in (clean off zero): the resident kernel and classic K1 with
    positivity against the plain sweep on the same injected uniforms (MH 2
    sweeps, untied; gibbs 1), under ``compare``'s tolerances, and classic
    K1 so again at two chains (its ``Run``'s batch) that differ; the two
    kernels bit-equal on the Philox draws (4 sweeps); ms per sweep of the
    resident kernel with the flag off and on, in turns (off, on, on, off),
    and of classic K1 with it on.  The tiled kernel with positivity against
    its plain version (MH at 34×34×600 in four (1, 1) tiles, gibbs at
    17×34×600 in two: the plain tiled gibbs sweep runs ~600 torch ops per
    step) and one tile against the resident kernel, bit for bit.  Then a
    400-sweep ``Run`` per sampler (the resident kernels' path), and a
    2-chain ``Run`` per sampler (classic K1's: the resident plan does not
    fit two chains at this size)."""
    out = {}
    cube = bench_cube()
    for sampler, n_cmp in (("mh", 2), ("gibbs", 1)):
        seg, classic = segment_of(sampler), classic_of(sampler)
        problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler, positivity=True))
        off = dataclasses.replace(problem, config=dataclasses.replace(
            problem.config, positivity=False))
        state = sm.run_sweeps(problem, sm.init_state(problem), 4).state
        L, nij = problem.L, problem.ny * problem.nx
        per = (L + 1,) if sampler == "mh" else (2, L)
        rng = np.random.default_rng(11)
        u = rng.random((n_cmp, problem.n_colors, nij, *per), dtype=np.float32)
        u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24)).cuda()
        if sampler == "mh":
            u, plain = sw.untie_uniforms(problem, state, n_cmp, u)
            plain_ms = timed(lambda: sw.mh_segment_reference(
                problem, state, 1))[1]
        else:
            plain, plain_ms = timed(lambda: sw.gibbs_segment_reference(
                problem, state, n_cmp, u))
            plain_ms /= n_cmp
        errs = {}
        for name, fn in (("resident", seg), ("classic", classic)):
            kern = fn(problem, copy_state(state), n_cmp, u)
            torch.cuda.synchronize()
            errs[name] = compare(plain, kern, sampler)
        # classic K1 at the C = 2 of its Run below, from two chains 4
        # sweeps apart from their start: each chain must read its own clean
        chains = classic(problem, ch.init_chain_states(problem, 2),
                         4).result.state
        check(not torch.equal(chains.clean[0], chains.clean[1]),
              "the two chains did not diverge")
        batch = phase_batch_vs_plain(problem, sampler, n_chains=2,
                                     n_sweeps=n_cmp, states=chains)
        res = seg(problem, copy_state(state), 4)
        cla = classic(problem, copy_state(state), 4)
        torch.cuda.synchronize()
        equal = {name: bool(torch.equal(getattr(res.result.state, name),
                                        getattr(cla.result.state, name)))
                 for name in ("resid", "clean", "log_scale", "chi2")}
        equal["accept_or_live"] = bool(torch.equal(res.accept, cla.accept))
        moved = res.result.state.clean != state.clean
        clean_min = float(res.result.state.clean.min())
        n_time = 50
        n0 = seg.resident_launches
        ms_off1 = time_sweeps(lambda n: seg(off, state, n), n_time)
        ms_on1 = time_sweeps(lambda n: seg(problem, state, n), n_time)
        ms_on2 = time_sweeps(lambda n: seg(problem, state, n), n_time)
        ms_off2 = time_sweeps(lambda n: seg(off, state, n), n_time)
        resident_timed = seg.resident_launches - n0
        # classic K1 with the flag off and on, in the same turns
        classic_turns = [time_sweeps(lambda n: classic(pr, state, n), 20)
                         for pr in (off, problem, problem, off)]
        classic_ms = (classic_turns[1] + classic_turns[2]) / 2
        emit("positivity_kernels", sampler=sampler, shape=list(cube.shape),
             compared_sweeps=n_cmp, vs_plain=errs, plain_ms=plain_ms,
             resident_vs_classic_sweeps=4, bit_equal=equal,
             voxels_moved=int(moved.sum()), clean_min=clean_min,
             ms_off_on_on_off=[ms_off1, ms_on1, ms_on2, ms_off2],
             resident_ms=(ms_on1 + ms_on2) / 2,
             resident_ms_flag_off=(ms_off1 + ms_off2) / 2,
             classic_ms=classic_ms, classic_ms_off_on_on_off=classic_turns,
             resident_launches_timed=resident_timed)
        check(all(equal.values()), "positivity: resident differs from "
              f"classic K1: {[k for k, v in equal.items() if not v]}")
        check(int(moved.sum()) > 0 and clean_min >= 0.0,
              "positivity kernels left the orthant or moved nothing")
        check(resident_timed == 4 * (n_time + 1),
              "the resident kernel did not run the timed sweeps")
        out[sampler] = {"max_abs_err": errs["resident"]["resid_max_abs_err"],
                        "ms": (ms_on1 + ms_on2) / 2, "plain_ms": plain_ms,
                        "ms_flag_off": (ms_off1 + ms_off2) / 2,
                        "classic_ms": classic_ms,
                        "classic_ms_flag_off":
                            (classic_turns[0] + classic_turns[3]) / 2,
                        "classic_max_abs_err":
                            errs["classic"]["resid_max_abs_err"],
                        "classic_2_chains": batch}
        # one tile of the tiled kernel is the whole-cube sweep, positivity on
        n0 = tiled_counter(sampler).launches
        one = tl.tiled_segment(problem, copy_state(state), 2,
                               tile=(problem.ny, problem.nx))
        two = seg(problem, copy_state(state), 2)
        torch.cuda.synchronize()
        one_equal = all(torch.equal(getattr(one.result.state, n_),
                                    getattr(two.result.state, n_))
                        for n_ in ("resid", "clean", "chi2"))
        check(tiled_counter(sampler).launches - n0 == 2 and one_equal,
              "positivity: one tile of K2 is not the resident sweep")
        shape = (600, 34, 34) if sampler == "mh" else (600, 17, 34)
        t0 = time.perf_counter()
        tp, ts, terrs, _, tplain_ms, tiled_kern = tiled_compare(
            bench_cube(*shape), (1, 1), sampler, 1, 12, positivity=True)
        counter = tiled_counter(sampler)
        tp_off = dataclasses.replace(tp, config=dataclasses.replace(
            tp.config, positivity=False))
        # K2 with the flag off and on, in the same turns; the launches of
        # the positivity instantiation
        tiled_turns, tiled_launches = [], 0
        for pr in (tp_off, tp, tp, tp_off):
            n0 = counter.launches
            tiled_turns.append(time_sweeps(
                lambda k: tl.tiled_segment(pr, ts, k), 10))
            tiled_launches += (counter.launches - n0) * (pr is tp)
        tiled_ms = (tiled_turns[1] + tiled_turns[2]) / 2
        if tplain_ms is None:
            tplain_ms = timed(lambda: tl.tiled_segment_reference(
                tp, ts, 1))[1]
        out[sampler]["tiled"] = {
            "launches": tiled_launches, "ms": tiled_ms,
            "ms_flag_off": (tiled_turns[0] + tiled_turns[3]) / 2,
            "plain_ms": tplain_ms, "shape": list(shape), "tile": [1, 1],
            "max_abs_err": terrs["resid_max_abs_err"],
            "bound": sweep_bound(tp, 1, tiled_kern.accept)}
        emit("positivity_tiled", sampler=sampler, shape=list(shape),
             tile=[1, 1], one_tile_equals_resident=one_equal,
             kernel_ms_per_sweep=tiled_ms, plain_ms_per_sweep=tplain_ms,
             kernel_ms_off_on_on_off=tiled_turns,
             launches_timed=tiled_launches,
             seconds=time.perf_counter() - t0)
        check(tiled_launches == 22, "K2 with positivity did not run the "
              "timed sweeps")
        del tp, ts, tp_off
        del problem, off, state, plain, res, cla, one, two, tiled_kern, chains
    for sampler in ("mh", "gibbs"):
        run, out[sampler]["path"] = positivity_run(sampler)
        del run
        run, out[sampler]["chains"] = positivity_run(sampler, n=64,
                                                     n_chains=2)
        # classic K1's ms per batched sweep on that run's state, with the
        # flag off and on in the same turns
        off = dataclasses.replace(run.problem, config=dataclasses.replace(
            run.problem.config, positivity=False))
        turns = [time_sweeps(
            lambda k: classic_of(sampler)(pr, run.states, k), 8)
            for pr in (off, run.problem, run.problem, off)]
        out[sampler]["chains"]["ms"] = (turns[1] + turns[2]) / 2
        out[sampler]["chains"]["ms_flag_off"] = (turns[0] + turns[3]) / 2
        emit("positivity_chains_ms", sampler=sampler, n_chains=2,
             ms_off_on_on_off=turns)
        del run, off
    return out


#: the block step on the card against the CPU's (same problem and Philox
#: draws), of each output's scale: the banded solves amplify the rounding
#: of lin and linT, which the two devices compute in another order
BLOCK_TOL = {"resid": 1e-4, "clean": 1e-3, "chi2": 1e-5}


def phase_gibbs_block(n=100):
    """``sampler='gibbs_block'`` on the card.  The banded kernels against
    their plain loops at this path's shapes (L = 600, lw = 11): the draw
    for 4 systems (one color of one chain) and 128 (32 chains), the
    Cholesky for 1156 (the bench's Yc·Xc, once per problem); ms of both.
    The block sweep on the card against the CPU's on one problem and the
    Philox draws (30×30×600 with the MUSE FSF cut to 5×5 — 25 colors: the
    CPU's plain loops take ~12 torch ops per λ row); then ``Run(bench
    cube, MUSE(), sampler='gibbs_block')`` for ``n`` sweeps → diagnostics
    → save: one Cholesky launch at set-up, f² = 289 draw launches per
    sweep, acceptance exactly 1, χ² consistency ≤ 1e-5; sweeps/s and the
    Cholesky's ms; a profile of 2 of its sweeps (the draws' and the other
    ops' device time, the idle share); and 16 sweeps of a 32-chain ``Run``
    (the 128-system draws)."""
    lam = 4750.0 + 1.25 * np.arange(600)
    lsf = torch.tensor(d3.MUSE().lsf.bank(lam, cdelt=1.25, width=None),
                       dtype=torch.float32).cuda()
    lw = int(lsf.shape[1])
    rng = np.random.default_rng(13)
    out = {}
    for n_sys, parts in ((4, ("sample",)), (128, ("sample",)),
                         (1156, ("cholesky",))):
        q = torch.tensor(1.0 + rng.random((n_sys, 600)),
                         dtype=torch.float32).cuda()
        bands = bd.precision_bands(lsf, q)
        R_ref = bd.cholesky_banded_reference(bands)
        row = {}
        if "cholesky" in parts:
            row["cholesky"] = cholesky_vs_plain(bands, library=True)
        if "sample" in parts:
            b, noise = (torch.tensor(rng.standard_normal((n_sys, 600)),
                                     dtype=torch.float32).cuda()
                        for _ in range(2))
            x, call_ms = ms_per_call(
                lambda: bd.sample_conditional(R_ref, b, noise), 20)
            ms = device_ms(lambda: bd.sample_conditional(R_ref, b, noise),
                           "banded_sample_kernel")
            x_ref, plain_ms = timed(
                lambda: bd.sample_conditional_reference(R_ref, b, noise))
            err, scale = (float((x - x_ref).abs().max()),
                          float(x_ref.abs().max()))
            row["sample"] = {"max_abs_err": err, "ms": ms,
                             "call_ms": call_ms, "plain_ms": plain_ms,
                             "library_ms": draw_library_ms(R_ref, b, noise)
                             if n_sys == 4 else None,
                             "bound": banded_bound("sample", n_sys, 600,
                                                   lw - 1)}
            check(err <= BANDED_TOL["sample"] * scale,
                  f"banded draw differs ({n_sys} systems, L = 600)")
        out[n_sys] = row
        emit("banded_block_shapes", L=600, lw=lw, n_systems=n_sys,
             **{f"{k}_{m}": v[m] if m != "bound" else v[m]["bound_ms"]
                for k, v in row.items()
                for m in ("max_abs_err", "ms", "plain_ms", "bound")})

    cube = bench_cube()
    small = sm.RunConfig(seed=0, sampler="gibbs_block", fsf_size=5)
    card = sm.make_problem(cube, d3.MUSE(), small)
    cpu = sm.make_problem(cube.to("cpu"), d3.MUSE(), small, device="cpu")
    n0 = bd.sample_conditional.launches
    got = sw.gibbs_block_segment(card, sm.init_state(card), 1)
    torch.cuda.synchronize()
    launches = bd.sample_conditional.launches - n0
    t0 = time.perf_counter()
    want = sw.gibbs_block_segment_reference(cpu, sm.init_state(cpu), 1)
    cpu_s = time.perf_counter() - t0
    errs = {n_: float((getattr(got.result.state, n_).cpu()
                       - getattr(want.result.state, n_)).abs().max())
            / float(getattr(want.result.state, n_).abs().max())
            for n_ in ("resid", "clean")}
    errs["chi2"] = abs(float(got.result.state.chi2)
                       - float(want.result.state.chi2)) / float(
        want.result.state.chi2)
    emit("block_card_vs_cpu", shape=list(cube.shape), f=card.f,
         draw_launches=launches, rel_err=errs, rel_tol=BLOCK_TOL,
         counts_equal=bool(torch.equal(got.accept.cpu(), want.accept)),
         cpu_sweep_s=cpu_s)
    check(launches == card.n_colors, "one draw launch per color")
    check(bool(torch.equal(got.accept.cpu(), want.accept)),
          "block voxel counts differ")
    for n_, tol in BLOCK_TOL.items():
        check(errs[n_] <= tol, f"block sweep on the card differs from the "
              f"CPU in {n_}")
    del card, cpu, got, want

    reset_launches()
    run, setup_ms = timed(lambda: d3.Run(cube, d3.MUSE(), max_iterations=n,
                                        burn_in=n // 2, seed=0,
                                        sampler="gibbs_block"))
    chol_launches = bd.cholesky_banded.launches
    p = run.problem
    check(p.config.engine == "cuda" and chol_launches == 1,
          f"gibbs_block set-up: engine {p.config.engine}, "
          f"{chol_launches} Cholesky launches")
    _, chol_ms = ms_per_call(lambda: sm.block_factors(p.lsf, p.quad), 5)
    run.run(n // 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.run(n // 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    draws = bd.sample_conditional.launches
    diag = run.diagnostics()
    consistency = chi2_consistency(run)
    with tempfile.TemporaryDirectory() as tmp:
        run.save(os.path.join(tmp, "block"))
        saved = os.path.isfile(os.path.join(tmp, "block_clean.fits"))
    emit("gibbs_block_run", shape=list(cube.shape), sweeps=diag["sweeps"],
         cholesky_launches=chol_launches, draw_launches=draws,
         draw_launches_per_sweep=draws / n, cholesky_ms=chol_ms,
         setup_ms=setup_ms, acceptance=diag["acceptance_rate"],
         chi2=diag["chi2"], chi2_consistency=consistency,
         sweeps_per_sec_last_half=(n // 2) / dt)
    check(draws == n * p.n_colors, f"{draws} draw launches for {n} sweeps")
    check(diag["acceptance_rate"] == 1.0, "gibbs_block acceptance is not 1")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    check(saved, "save() files missing")
    # where a block sweep's time goes: the draws, the torch ops around them,
    # and the card's idle share
    prof = phase_profile(p, run.states, "gibbs_block", n=2,
                         seg=sw.gibbs_block_segment,
                         kernel_name="banded_sample_kernel",
                         per_sweep=p.n_colors)
    out["path"] = {"draw_launches": draws, "cholesky_launches": chol_launches,
                   "cholesky_ms": chol_ms, "rate": (n // 2) / dt,
                   "profile": prof}
    del run
    reset_launches()
    run = d3.Run(cube, d3.MUSE(), max_iterations=16, burn_in=8, seed=0,
                 sampler="gibbs_block", n_chains=32)
    run.run(16)
    torch.cuda.synchronize()
    draws32 = bd.sample_conditional.launches
    consistency32 = max(chi2_consistency(run, c) for c in (0, 31))
    emit("gibbs_block_chains", n_chains=32, sweeps=16, draw_launches=draws32,
         chi2_consistency=consistency32,
         acceptance=run.diagnostics()["acceptance_rate"])
    check(draws32 == 16 * p.n_colors, "one draw launch per color for 32 chains")
    check(consistency32 <= 1e-5, "32-chain running chi2 drifted")
    out["chains"] = {"draw_launches": draws32}
    return out


#: the solve kernel against its plain version, float32, of the output's
#: scale: the banded draw's tolerance (two solves amplify rounding by the
#: system's condition)
SOLVE_TOL = 1e-3


def dense_upper(R):
    """Dense upper factors ``[n, L, L]`` of banded ones ``[n, L, W]``."""
    L, W = R.shape[-2:]
    U = torch.zeros((*R.shape[:-2], L, L), dtype=R.dtype, device=R.device)
    for k in range(W):
        U += torch.diag_embed(R[..., : L - k, k], offset=k)
    return U


def dense_bands(bands):
    """Dense symmetric matrices ``[n, L, L]`` of upper bands ``[n, L, W]``."""
    U = dense_upper(bands)
    return U + U.transpose(-1, -2) - torch.diag_embed(bands[..., 0])


def solve_bound(L, n, n_factors, p):
    """The least time one banded solve launch could take: b read once, x
    written once, the ``n_factors`` factors that the columns reference and
    their index read once (z, the forward solve, is the kernel's own),
    against the HBM rate; flops per column
    and row 2·(2p + 1) (a division 1, an fma 2; both solves).  Its latency
    form: the dependent steps of one column (:func:`chain_steps`; 2·L
    before the segments)."""
    W = p + 1
    nbytes = 2 * L * n * 4 + n_factors * L * W * 4 + n * 4
    flops = 2 * (2 * p + 1) * L * n
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTE_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "latency_steps": chain_steps(n, L, p, "solve"),
            "latency_steps_before": 2 * L}


def solve_vs_plain(problem, label, prior_precision=None, library=False,
                   cholesky=False, library_grouped=False):
    """``banded_solve`` on the preconditioner factors of ``problem``'s
    solves under ``prior_precision`` (default the config's; the shape its
    CG iterations give the kernel: the real view of an rfft2 cube,
    λ-major) against its plain version: error, ms of both (the kernel per
    launch over 20, CUDA events), the bound; with ``library`` the time of
    ``torch.cholesky_solve`` on the dense factors, same right-hand sides;
    with ``cholesky`` the Cholesky kernel on the bands that the
    preconditioner factors (:func:`cholesky_vs_plain`, the library at L =
    600); with ``library_grouped`` the library times where the dense
    factors do not fit at once: ``torch.cholesky_solve`` with the columns
    grouped by factor (:func:`solve_library_grouped_ms`) and
    ``torch.linalg.cholesky`` in chunks of :data:`LIBRARY_CHUNK`
    systems."""
    mode = td._resolve_precond_mode(problem)
    if prior_precision == "auto":
        prior_precision = td.suggest_prior_precision(problem)
    captured, real = [], bd.cholesky_banded

    def capture(bands, jitter=0.0):
        captured.append(bands.clone())
        return real(bands, jitter)
    # the wrapper counts its launches under the module's name
    capture.launches = real.launches
    bd.cholesky_banded = capture
    try:
        state = td._precond_state(problem, mode, td._precond_tau(
            problem, td._tau(problem, prior_precision)))
    finally:
        bd.cholesky_banded = real
        real.launches = capture.launches
    gen = torch.Generator(device="cuda").manual_seed(21)
    r = torch.randn((problem.L, problem.Y, problem.X), generator=gen,
                    device="cuda")
    b = torch.view_as_real(torch.fft.rfft2(r)).reshape(problem.L, -1)
    out = solve_at(state.R, state.fidx, b, library)
    out["mode"] = mode
    if library_grouped:
        want = bd.solve_banded_reference(state.R, state.fidx, b)
        out["library_ms"], out["library_max_abs_err"] = \
            solve_library_grouped_ms(state.R, state.fidx, b, want)
        out["library_is"] = ("torch.cholesky_solve on the dense factors, "
                             "one call per factor on its columns, summed")
        del want
    if cholesky:
        check(len(captured) == 1, f"{len(captured)} factorisations")
        out["cholesky"] = cholesky_vs_plain(captured[0],
                                            library=problem.L == 600)
        if library_grouped:
            out["cholesky"]["library_ms"] = cholesky_library_ms(
                captured[0], LIBRARY_CHUNK)
            out["cholesky"]["library_is"] = (
                f"torch.linalg.cholesky on the dense matrices, "
                f"{LIBRARY_CHUNK} systems a call, summed")
        emit("banded_cholesky_vs_plain", label=label,
             shape=list(captured[0].shape), **{
                 k: v for k, v in out["cholesky"].items() if k != "bound"},
             bound_ms=out["cholesky"]["bound"]["bound_ms"])
    del captured
    emit_solve(label, out)
    return out


def solve_at(R, fidx, b, library=False):
    """``banded_solve`` on columns ``b`` ``[L, n]`` (factor ``fidx[j]`` of
    ``R`` for column j) against its plain version: error and tolerance,
    device ms per launch, ms per call over 20 (CUDA events), the plain
    version's ms, the bound (on the factors that ``fidx`` names: a slot's
    columns reference only their own); with ``library`` the time of
    ``torch.cholesky_solve`` on the dense factors of the columns' pairs,
    same right-hand sides."""
    x, call_ms = ms_per_call(lambda: bd.banded_solve(R, fidx, b), 20)
    ms = device_ms(lambda: bd.banded_solve(R, fidx, b),
                   "banded_solve_kernel")
    want, plain_ms = timed(lambda: bd.solve_banded_reference(R, fidx, b))
    err, scale = float((x - want).abs().max()), float(want.abs().max())
    L, n = b.shape
    p = int(R.shape[-1]) - 1
    used = int(torch.unique(fidx).numel())
    out = {"shape": [L, n], "factors": int(R.shape[0]),
           "factors_referenced": used,
           "max_abs_err": err, "tol": SOLVE_TOL * scale, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms,
           "split": bd.solve_split(n, L, p),
           "bound": solve_bound(L, n, used, p),
           "library_ms": None}
    if library:
        # the real and imaginary columns of a frequency share its factor
        U = dense_upper(R)[fidx[0::2].long()]
        rhs = b.T.reshape(-1, 2, L).transpose(1, 2).contiguous()
        with cv.no_tf32():
            lib, out["library_ms"] = timed(lambda: torch.cholesky_solve(
                rhs, U, upper=True))
            lib, out["library_ms"] = timed(lambda: torch.cholesky_solve(
                rhs, U, upper=True))
        out["library_max_abs_err"] = float(
            (lib.transpose(1, 2).reshape(n, L).T - want).abs().max())
        del U, lib
    return out


def emit_solve(label, out):
    """The ``banded_solve_vs_plain`` line of a :func:`solve_at` result,
    failing when the kernel is off its plain version."""
    emit("banded_solve_vs_plain", label=label, **{
        k: v for k, v in out.items() if k not in ("bound", "cholesky")},
        bound_ms=out["bound"]["bound_ms"], bound_by=out["bound"]["bound_by"],
        latency_steps=out["bound"]["latency_steps"])
    check(out["max_abs_err"] <= out["tol"],
          f"banded solve kernel differs from its plain version ({label})")


class PCGRecorder:
    """Wraps ``ops.direct.pcg``: each solve's iterations, relative
    residual and ms (CUDA events), and the solve kernel's launches."""

    def __init__(self):
        self.solves, self._pcg = [], td.pcg

    def __enter__(self):
        def recording(A, Minv, b, tol, maxiter, ops=td.LOCAL):
            n0 = bd.banded_solve.launches
            res, ms = timed(lambda: self._pcg(A, Minv, b, tol, maxiter,
                                              ops))
            self.solves.append({"iterations": res.iterations,
                                "rel_residual": res.rel_residual, "ms": ms,
                                "solve_launches":
                                    bd.banded_solve.launches - n0})
            return res

        td.pcg = recording
        return self

    def __exit__(self, *exc):
        td.pcg = self._pcg


def profile_cg(fn, label):
    """``torch.profiler`` over ``fn()`` (CG iterations): device ms by kind
    — the banded solve kernel, cuFFT, matmuls (the LSF matrix), the rest
    (elementwise and reductions) — and the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"solve": 0.0, "fft": 0.0, "matmul": 0.0, "other": 0.0}
    count = dict.fromkeys(kinds, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("solve" if "banded_solve" in name
                else "fft" if "fft" in name
                else "matmul" if "gemm" in name or "cutlass" in name
                else "other")
        kinds[kind] += e.time_range.elapsed_us() / 1e3
        count[kind] += 1
    device_ms = sum(kinds.values())
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "device_ms_by": kinds,
           "launches_by": count, "idle_share": 1.0 - device_ms / wall_ms}
    emit("cg_profile", label=label, **out)
    return out


def toy_posterior(problem):
    """The dense float64 posterior (mean, σ) of a small direct problem on
    the host: A = KᵀWK + τI with K from unit voxels through the port's
    ``convolve_cube`` (the problem's banks, float64)."""
    p = problem
    fsf, lsf = p.fsf.double().cpu(), p.lsf.double().cpu()
    n = p.L * p.Y * p.X
    eye = torch.eye(n, dtype=torch.float64).reshape(n, p.L, p.Y, p.X)
    K = torch.stack([d3.convolve_cube(e, fsf, lsf, spatial="direct")
                     .reshape(-1) for e in eye], dim=1).numpy()
    h = p.f // 2
    w = p.w_pad[:, h : h + p.Y, h : h + p.X].double().cpu().numpy().ravel()
    d = p.data_pad[:, h : h + p.Y, h : h + p.X].double().cpu().numpy().ravel()
    cov = np.linalg.inv(K.T @ (w[:, None] * K)
                        + float(p.config.prior_precision) * np.eye(n))
    return cov @ (K.T @ (w * d)), np.sqrt(np.diag(cov))


def host_rel_residual(problem, x, tau):
    """‖b − A x‖ / ‖b‖ of the MAP ``x`` with the port's operator in float64
    on the host (the problem's banks, weights and data)."""
    p = problem
    pc = dataclasses.replace(
        p, valid=p.valid.cpu(), **{n_: getattr(p, n_).cpu().double()
                                   for n_ in ("fsf", "lsf", "data_pad",
                                              "w_pad")})
    A64 = td.make_normal_operator(pc, tau)
    b64 = td.apply_KT(pc, td._d_in(pc) * td._w_in(pc)) * td._free_mask(pc)
    return float((b64 - A64(x.cpu().double())).norm() / b64.norm())


def rel_err(got, want):
    """max |got − want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def phase_direct(tmp, n_oracle=300, n_draws=20):
    """The direct sampler and the MAP on the card (``ops/direct.py``).
    (a) ``banded_solve`` against its plain version on the preconditioner
    factors of the bench cube (dense mode: 480 frequencies, 960 columns,
    L = 600; the library's ``torch.cholesky_solve`` on the dense factors
    beside it) and of 60×60×3681 (1,860 frequencies).  (b)
    ``map_estimate`` on the bench cube ('auto' τ, tol 1e-6): iterations,
    ms per iteration, the recurrence's and the float64 residual, and the
    true relative residual of the card's solution from the port's operator
    in float64 on the host (≤ 2 tol); a profile of its CG iterations.  (c)
    A toy whose dense posterior is computable (8×6×6): ``n_oracle`` draws
    through ``Run(sampler='direct')`` against the float64 posterior —
    mean and σ z-scores, every solve converged.  (d) ``Run(bench cube,
    MUSE(), sampler='direct', prior_precision='auto')`` for ``n_draws``
    draws → diagnostics → save: draws/s, χ² consistency, the flags, the
    solve kernel's launches (the ``kernels`` line's)."""
    out = {}
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), seed=0)
    p = run.problem
    out["dense_600"] = solve_vs_plain(p, "bench 30x30x600", "auto",
                                      library=True, cholesky=True)
    big = d3.Run(bench_cube(L=3681, Y=60, X=60), d3.MUSE(), seed=0,
                 sampler="direct", prior_precision="auto")
    out["dense_3681"] = solve_vs_plain(big.problem, "60x60x3681")
    del big

    # (b) the MAP of the MCMC run's problem
    reset_launches()
    with PCGRecorder() as rec:
        m, ms = timed(lambda: run.map_estimate(prior_precision="auto",
                                               tol=1e-6))
    launches = bd.banded_solve.launches
    res = run.last_map_result
    tau = run.last_map_prior_precision
    true_rel = host_rel_residual(p, m.data, tau)
    with cv.no_tf32():
        A, M = td.make_normal_operator(p, tau), td.make_preconditioner(
            p, prior_precision=tau)
        b = td.apply_KT(p, td._d_in(p) * td._w_in(p)) * td._free_mask(p)
        prof = profile_cg(lambda: td.pcg(A, M, b, 0.0, 50),
                          "50 CG iterations, 30x30x600")
    del A, M, b
    out["map"] = {"iterations": res.iterations, "ms": ms,
                  "ms_per_iteration": sum(r["ms"] for r in rec.solves)
                  / max(res.iterations, 1),
                  "rel_residual": res.rel_residual,
                  "true_rel_residual_host_f64": true_rel,
                  "solves": rec.solves, "solve_launches": launches,
                  "profile": prof, "tau": tau}
    emit("direct_map", shape=list(cube.shape), **{
        k: v for k, v in out["map"].items() if k != "profile"})
    check(res.rel_residual <= 1e-6 and res.iterations <= 500,
          f"bench MAP did not converge: {res.rel_residual} after "
          f"{res.iterations}")
    check(true_rel <= 2e-6, f"the MAP's float64 residual {true_rel:.3e} "
          "exceeds 2 tol")
    check(launches >= res.iterations, "the MAP's CG bypassed the kernel")
    # phase direct_sharded holds its MAP and draws against these
    out["map_x"] = m.data.cpu()
    del run

    # (c) draw statistics against the dense posterior of a toy
    gen = np.random.default_rng(5)
    L, Y, X = 8, 6, 6
    lam = 4750.0 + 1.25 * np.arange(L)
    inst = d3.Instrument(fsf=d3.GaussianFSF(fwhm=0.25),
                         lsf=d3.GaussianLSF(fwhm=1.0), pixel_scale=0.2)
    truth = np.zeros((L, Y, X), np.float32)
    truth[L // 2, Y // 2, X // 2] = 4.0
    conv = d3.convolve_cube(
        torch.tensor(truth), inst.fsf.bank(lam, size=3, pixel_scale=0.2),
        inst.lsf.bank(lam, cdelt=1.25, width=3)).numpy()
    data = (conv + 0.5 * gen.standard_normal(conv.shape)).astype(np.float32)
    toy = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                            crval=4750.0, cdelt=1.25, device="cuda")
    orun = d3.Run(toy, inst, max_iterations=n_oracle, sampler="direct",
                  fsf_size=3, lsf_width=3, seed=7, prior_precision=0.5)
    t0 = time.perf_counter()
    orun.run()
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    mean, sig = toy_posterior(orun.problem)
    dc = orun.deconvolved_cube()
    pm = dc.data.double().cpu().numpy().ravel()
    ps = np.sqrt(dc.variance.double().cpu().numpy().ravel())
    z = (pm - mean) / (sig / np.sqrt(n_oracle))
    flags = orun.trace("accept")
    out["oracle"] = {"draws": n_oracle, "mean_abs_z": float(np.abs(z).mean()),
                     "max_abs_z": float(np.abs(z).max()),
                     "median_std_ratio": float(np.median(ps / sig)),
                     "flags_min": float(flags.min()), "seconds": oracle_s}
    emit("direct_oracle", shape=[L, Y, X], **out["oracle"])
    check(out["oracle"]["mean_abs_z"] < 2.0 and out["oracle"]["max_abs_z"]
          < 5.5, "direct draws' mean is off the analytic posterior")
    check(abs(out["oracle"]["median_std_ratio"] - 1.0) < 0.15,
          "direct draws' spread is off the analytic posterior")
    check(flags.min() == 1.0, "a toy draw did not converge")
    del orun

    # (d) the slice's main path: Run(sampler='direct') on the bench cube
    run = d3.Run(cube, d3.MUSE(), max_iterations=n_draws, seed=0,
                 sampler="direct", prior_precision="auto")
    check(run.config.engine == "cuda", f"engine {run.config.engine}")
    run.states
    reset_launches()
    with PCGRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = bd.banded_solve.launches
    chol_launches = bd.cholesky_banded.launches
    diag = run.diagnostics()
    consistency = chi2_consistency(run)
    run.save(os.path.join(tmp, "direct"))
    saved = os.path.isfile(os.path.join(tmp, "direct_clean.fits"))
    iters = [r["iterations"] for r in rec.solves]
    out["path"] = {"launches": launches, "draws": n_draws,
                   "cholesky_launches": chol_launches,
                   "draws_per_sec": n_draws / dt,
                   "iterations_per_draw": iters,
                   "ms_per_iteration": sum(r["ms"] for r in rec.solves)
                   / max(sum(iters), 1),
                   "chi2_consistency": consistency,
                   "flags": run.trace("accept")[0].tolist(),
                   "mode": td._resolve_precond_mode(run.problem)}
    emit("direct_run", shape=list(cube.shape), chi2=diag["chi2"],
         acceptance=diag["acceptance_rate"], **out["path"])
    check(all(f == 1.0 for f in out["path"]["flags"]),
          "a bench draw did not converge")
    check(consistency <= 1e-5, "direct chi2 is not the from-scratch one")
    check(launches >= sum(iters) > 0,
          "the draws' CG bypassed the solve kernel")
    check(chol_launches >= 1, "the draws built no preconditioner factors")
    check(saved, "save() files missing")
    out["path_mean"] = run.deconvolved_cube().data.cpu()
    return out


def phase_direct_field(cube):
    """The full MUSE field (300×300×3681, the cube of ``full_field``) in
    the direct sampler, as the JAX package's full-field record ran it:
    τ = 1e-3, tol 1e-5, 600 iterations at most.  The preconditioner must
    resolve to the radial mode; ``banded_solve`` against its plain version
    on its factors (90,600 columns over 256); one ``map_estimate`` and a
    2-draw ``Run(sampler='direct')``: iterations, seconds per draw, peak
    memory, a profile of 3 CG iterations."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = d3.Run(cube, d3.MUSE(), max_iterations=2, seed=0, sampler="direct",
                 prior_precision=1e-3, direct_tol=1e-5, direct_maxiter=600)
    run.states
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p = run.problem
    mode = td._resolve_precond_mode(p)
    check(mode == "banded_radial", f"the full field resolved to {mode}")
    out = {"radial_3681": solve_vs_plain(p, "300x300x3681 radial",
                                         cholesky=True, library_grouped=True)}
    reset_launches()
    with PCGRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.map_estimate()
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        res = run.last_map_result
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        draws_s = time.perf_counter() - t0
    launches = bd.banded_solve.launches
    chol_launches = bd.cholesky_banded.launches
    peak = torch.cuda.max_memory_allocated()
    flags = run.trace("accept")[0].tolist()
    draws = rec.solves[-2:]
    map_solves = rec.solves[:-2]
    with cv.no_tf32():
        b = td.apply_KT(p, td._d_in(p) * td._w_in(p)) * td._free_mask(p)
        A, M = td.make_normal_operator(p), td.make_preconditioner(p)
        prof = profile_cg(lambda: td.pcg(A, M, b, 0.0, 3),
                          "3 CG iterations, 300x300x3681")
    del A, M, b
    out.update({
        "setup_s": setup_s, "mode": mode, "map_s": map_s,
        "map_iterations": res.iterations, "map_rel_residual": res.rel_residual,
        "draw_iterations": [d["iterations"] for d in draws],
        "draw_rel_residuals": [d["rel_residual"] for d in draws],
        "s_per_draw": draws_s / 2, "flags": flags, "solves": rec.solves,
        "solve_launches": launches, "cholesky_launches": chol_launches,
        "peak_bytes": peak, "profile": prof,
        "ms_per_iteration": sum(d["ms"] for d in rec.solves)
        / max(sum(d["iterations"] for d in rec.solves), 1),
        "map_ms_per_iteration": sum(d["ms"] for d in map_solves)
        / max(sum(d["iterations"] for d in map_solves), 1)})
    emit("direct_full_field", shape=list(cube.shape), **{
        k: v for k, v in out.items() if k not in ("radial_3681", "profile")})
    # phase direct_sharded_field holds its MAP against this one
    out["map_x"] = res.x
    check(res.rel_residual <= 1e-5 and res.iterations <= 600,
          f"the full-field MAP: rel {res.rel_residual} after "
          f"{res.iterations}")
    check(all(d["rel_residual"] <= 1e-5 and d["iterations"] <= 600
              for d in draws) and flags == [1.0, 1.0],
          f"a full-field draw did not converge: {draws}")
    check(launches >= sum(d["iterations"] for d in rec.solves) > 0,
          "the full field's CG bypassed the solve kernel")
    return out


SHARD_MESH_NOTE = ("both shards on one card (Mesh([cuda:0] * 2)): the "
                   "peak does not fall, the slots' copies and launches add")


def phase_direct_sharded(tmp, direct, n_draws=20):
    """13b (a): the direct sampler and the MAP on ``Mesh([cuda:0] * 2)``
    (``parallel/direct_sharded.py``) on the bench cube.  The sharded A(v)
    and M⁻¹(v) (dense and radial modes) against the unsharded ones on one
    random v (rel ≤ 1e-5, float32); ``banded_solve`` on one slot's columns
    (600 × 480) against its plain version and ``torch.cholesky_solve``;
    ``Run(sampler='direct', prior_precision='auto', spatial_mesh=…)`` for
    ``n_draws`` draws → diagnostics → save with the counts set to 0 just
    before ``run()``: every solve converged, χ² consistency ≤ 1e-5, the
    solve kernel launched once per slot and preconditioner application,
    the iterations per draw beside phase ``direct``'s (same seed, same
    normals) and the posterior mean within 1e-4 of that run's; then
    ``map_estimate`` on the same mesh ('auto' τ, tol 1e-6) on the MCMC
    run's problem, as phase ``direct`` solves it: the float64 residual on
    the host ≤ 2 tol and the distance from phase ``direct``'s MAP."""
    out = {}
    cube = bench_cube()
    mesh = Mesh([torch.device("cuda:0")] * 2)
    run = d3.Run(cube, d3.MUSE(), max_iterations=n_draws, seed=0,
                 sampler="direct", prior_precision="auto", spatial_mesh=mesh)
    check(run.config.engine == "cuda", f"engine {run.config.engine}")
    p = run.problem
    sh = ds.shards(p, mesh)
    gen = torch.Generator(device="cuda").manual_seed(22)
    v = torch.randn((p.L, p.Y, p.X), generator=gen, device="cuda")
    ops = {}
    with cv.no_tf32():
        ops["A"] = rel_err(sh.gather(ds.make_normal_operator(p, mesh)(
            sh.cut(v)), v.device), td.make_normal_operator(p)(v))
        for mode in ("banded", "banded_radial"):
            ops[mode] = rel_err(sh.gather(ds.make_preconditioner(
                p, mesh, mode=mode)(sh.cut(v)), v.device),
                td.make_preconditioner(p, mode=mode)(v))
    out["operators"] = ops
    emit("direct_sharded_operators", shape=list(cube.shape), slots=2,
         rows=sh.rows, kx_columns=sh.cols, rel_err=ops, tol=1e-5)
    check(all(e <= 1e-5 for e in ops.values()),
          f"the sharded operators are off the unsharded ones: {ops}")

    st = ds.slot_precond(p, mesh)
    a, b = sh.cols[0]
    cols = torch.randn((p.L, p.Y * (b - a) * 2), generator=gen,
                       device="cuda")
    out["shard_solve"] = solve_at(st.R[0], st.fidx[0], cols, library=True)
    out["shard_solve"]["mode"] = st.mode
    emit_solve(f"bench 30x30x600, slot 0 of 2 (kx {a}..{b})",
               out["shard_solve"])
    del cols

    run.states
    reset_launches()
    with PCGRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = bd.banded_solve.launches
    diag = run.diagnostics()
    consistency = chi2_consistency(run)
    run.save(os.path.join(tmp, "direct_sharded"))
    saved = os.path.isfile(os.path.join(tmp, "direct_sharded_clean.fits"))
    iters = [r["iterations"] for r in rec.solves]
    ref_iters = direct["path"]["iterations_per_draw"]
    applications = sum(i + 1 for i in iters)
    mean_dist = rel_err(run.deconvolved_cube().data.cpu(),
                        direct["path_mean"])
    out["path"] = {"launches": launches, "draws": n_draws,
                   "preconditioner_applications": applications,
                   "draws_per_sec": n_draws / dt,
                   "iterations_per_draw": iters,
                   "unsharded_iterations_per_draw": ref_iters,
                   "ms_per_iteration": sum(r["ms"] for r in rec.solves)
                   / max(sum(iters), 1),
                   "unsharded_ms_per_iteration":
                       direct["path"]["ms_per_iteration"],
                   "chi2_consistency": consistency,
                   "mean_rel_dist_from_unsharded": mean_dist,
                   "flags": run.trace("accept")[0].tolist()}
    emit("direct_sharded_run", shape=list(cube.shape), chi2=diag["chi2"],
         note=SHARD_MESH_NOTE, **out["path"])
    check(all(f == 1.0 for f in out["path"]["flags"]),
          "a sharded bench draw did not converge")
    check(consistency <= 1e-5, "sharded direct chi2 is not the from-scratch "
          "one")
    check(launches == 2 * applications > 0,
          f"{launches} solve launches for {applications} preconditioner "
          "applications on 2 slots")
    check(abs(sum(iters) - sum(ref_iters)) <= 0.1 * sum(ref_iters),
          f"sharded draws took {iters} iterations, unsharded {ref_iters}")
    # same seed, same Philox normals: the two chains differ by the
    # solver's tolerance only (the gpu test's bound on clean)
    check(mean_dist <= 1e-4, f"the sharded posterior mean is {mean_dist:.3e}"
          " off the unsharded one on the same normals")
    check(saved, "save() files missing")
    del run

    # the MAP of the MCMC run's problem, as phase direct solves it
    mrun = d3.Run(cube, d3.MUSE(), seed=0, spatial_mesh=mesh)
    reset_launches()
    with PCGRecorder() as rec:
        m, ms = timed(lambda: mrun.map_estimate(prior_precision="auto",
                                                tol=1e-6))
    launches = bd.banded_solve.launches
    res = mrun.last_map_result
    true_rel = host_rel_residual(mrun.problem, m.data,
                                 mrun.last_map_prior_precision)
    n_it = sum(r["iterations"] for r in rec.solves)
    out["map"] = {"iterations": res.iterations, "ms": ms,
                  "ms_per_iteration": sum(r["ms"] for r in rec.solves)
                  / max(n_it, 1),
                  "unsharded_ms_per_iteration":
                      direct["map"]["ms_per_iteration"],
                  "unsharded_iterations": direct["map"]["iterations"],
                  "rel_residual": res.rel_residual,
                  "true_rel_residual_host_f64": true_rel,
                  "rel_dist_from_unsharded": rel_err(m.data.cpu(),
                                                     direct["map_x"]),
                  "solves": rec.solves, "solve_launches": launches}
    emit("direct_sharded_map", shape=list(cube.shape), **out["map"])
    check(res.rel_residual <= 1e-6 and res.iterations <= 500,
          f"sharded bench MAP did not converge: {res.rel_residual} after "
          f"{res.iterations}")
    check(true_rel <= 2e-6, f"the sharded MAP's float64 residual "
          f"{true_rel:.3e} exceeds 2 tol")
    check(launches == 2 * sum(r["iterations"] + 1 for r in rec.solves),
          "the sharded MAP's preconditioner did not launch once per slot")
    return out


def phase_direct_sharded_field(cube, field):
    """13b (b), after ``direct_full_field`` on its cube: ``map_estimate``
    on ``Mesh([cuda:0] * 2)`` at τ = 1e-3, tol 1e-5, 600 iterations at
    most: iterations, ms per CG iteration beside the unsharded MAP's, the
    distance from it, peak bytes (both shards on one card: the peak does
    not fall); the ms of one ragged all-to-all at the preconditioner's
    shape; ``banded_solve`` at the slots' column counts (3681 × 45,600 and
    3681 × 45,000) against its plain version."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = Mesh([torch.device("cuda:0")] * 2)
    run = d3.Run(cube, d3.MUSE(), seed=0, sampler="direct",
                 prior_precision=1e-3, direct_tol=1e-5, direct_maxiter=600,
                 spatial_mesh=mesh)
    p = run.problem
    reset_launches()
    with PCGRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.map_estimate()
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
    res = run.last_map_result
    launches = bd.banded_solve.launches
    peak = torch.cuda.max_memory_allocated()
    n_it = sum(r["iterations"] for r in rec.solves)
    out = {"map_s": map_s, "iterations": res.iterations,
           "rel_residual": res.rel_residual,
           "ms_per_iteration": sum(r["ms"] for r in rec.solves)
           / max(n_it, 1),
           "unsharded_ms_per_iteration": field["map_ms_per_iteration"],
           "unsharded_iterations": field["map_iterations"],
           "rel_dist_from_unsharded": rel_err(res.x, field["map_x"]),
           "solves": rec.solves, "solve_launches": launches,
           "peak_bytes": peak, "unsharded_peak_bytes": field["peak_bytes"],
           "mode": td._resolve_precond_mode(p)}
    sh = ds.shards(p, mesh)
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = [torch.fft.rfft(torch.randn((p.L, b - a, p.X), generator=gen,
                                       device="cuda"), dim=-1)
            for a, b in sh.rows]
    sizes = [b - a for a, b in sh.cols]
    moved, out["all_to_all_ms"] = ms_per_call(
        lambda: pm.all_to_all_ragged(rows, 2, 1, sizes), 5)
    out["all_to_all_bytes"] = sum(t.numel() * t.element_size()
                                  for t in moved)
    del rows, moved
    st = ds.slot_precond(p, mesh)
    out["shard_solves"] = {}
    for e, (a, b) in enumerate(sh.cols):
        cols = torch.randn((p.L, p.Y * (b - a) * 2), generator=gen,
                           device="cuda")
        at = solve_at(st.R[e], st.fidx[e], cols)
        at["mode"] = st.mode
        emit_solve(f"300x300x3681 radial, slot {e} of 2 (kx {a}..{b})", at)
        out["shard_solves"][at["shape"][1]] = at
        del cols
    emit("direct_sharded_field", shape=list(cube.shape), rows=sh.rows,
         kx_columns=sh.cols, note=SHARD_MESH_NOTE, **{
             k: v for k, v in out.items() if k != "shard_solves"})
    check(res.rel_residual <= 1e-5 and res.iterations <= 600,
          f"the sharded full-field MAP: rel {res.rel_residual} after "
          f"{res.iterations}")
    check(launches == 2 * sum(r["iterations"] + 1 for r in rec.solves),
          "the sharded full-field MAP's preconditioner did not launch once "
          "per slot")
    return out


def phase_full_field(sampler, n, cube):
    """``Run`` on a 300×300×3681 MUSE field with the defaults: every sweep
    through the tiled kernel, which the auto rule takes at this size in the
    planned tile; for gibbs the χ² rebaseline at absolute sweeps 8 and 16,
    with the running χ² against the from-scratch one just before each
    reset; for MH the global coarse pass after absolute sweep 8 (its
    constants' build and the pass timed, the banded kernels' launches
    counted).  Then one sweep each of the tiled and the whole-cube kernel
    on the run's problem and state, and the auto rule's choice held
    against the two times."""
    resets = []
    rebaseline = sm.rebaseline_chi2

    def recording_rebaseline(problem, state):
        """The rebaseline, after one monolithic ``full_chi2`` (the chunking
        threshold lifted) and the path's own, λ-chunked one on the same
        state, each with its peak bytes (the monolithic first, so that the
        run's peak holds the path's) and ms."""
        one = ch.select_chains(state, 0) if state.clean.dim() == 4 else state
        check(problem.L * problem.Y * problem.X * 4
              > sm.FULL_CHI2_CHUNK_BYTES, "full_chi2 is not chunked here")
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        limit = sm.FULL_CHI2_CHUNK_BYTES
        sm.FULL_CHI2_CHUNK_BYTES = float("inf")
        try:
            torch.cuda.reset_peak_memory_stats()
            mono, mono_ms = timed(lambda: float(sm.full_chi2(problem, one)))
            mono_peak = torch.cuda.max_memory_allocated()
        finally:
            sm.FULL_CHI2_CHUNK_BYTES = limit
        torch.cuda.reset_peak_memory_stats()
        full, ms = timed(lambda: float(sm.full_chi2(problem, one)))
        resets.append({"sweep": int(one.sweep),
                       "chi2_consistency_before":
                           abs(float(one.chi2) - full) / full,
                       "bytes_live": live,
                       "full_chi2_peak_bytes":
                           torch.cuda.max_memory_allocated(),
                       "full_chi2_ms": ms,
                       "monolithic_peak_bytes": mono_peak,
                       "monolithic_ms": mono_ms,
                       "chunked_vs_monolithic": abs(full - mono) / mono})
        return rebaseline(problem, state)

    passes, builds = [], []
    apply_pass, build = sm.apply_coarse_pass, co.coarse_constants

    def recording_pass(problem, state, constants):
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        out, ms = timed(lambda: apply_pass(problem, state, constants))
        passes.append({"sweep": int(state.sweep.reshape(-1)[0]), "ms": ms,
                       "bytes_live": live, "peak_bytes":
                           torch.cuda.max_memory_allocated(),
                       "peak_bytes_before": peak_before,
                       "accepted": float((out.n_accept
                                          - state.n_accept).sum()),
                       "proposed": float((out.n_propose
                                          - state.n_propose).sum())})
        return out

    def recording_build(problem, mode):
        out, ms = timed(lambda: build(problem, mode))
        builds.append({"mode": mode, "ms": ms, "patterns": sum(
            int(e[1].shape[0]) for e in out if e[0] == "global_batch")})
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = d3.Run(cube, d3.MUSE(), max_iterations=n, burn_in=n // 2, seed=0,
                 sampler=sampler)
    run.states                                  # init_state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    cfg = run.problem.config
    every = 8 if sampler == "gibbs" else 0
    check(cfg.engine == "cuda_tiled", f"full field resolved to {cfg.engine}")
    check(cfg.tile == FIELD_TILE, f"the planner took tile {cfg.tile}, the "
          f"kernel is held against its plain version in {FIELD_TILE}")
    check(cfg.chi2_rebaseline_every == every,
          f"chi2_rebaseline_every resolved to {cfg.chi2_rebaseline_every}")
    coarse_every = 8 if sampler == "mh" else None
    check(cfg.coarse_every == coarse_every
          and (coarse_every is None or cfg.coarse_mode == "global"),
          f"coarse_every resolved to {cfg.coarse_every} ({cfg.coarse_mode})")
    counter = tiled_counter(sampler)
    sm.rebaseline_chi2 = recording_rebaseline
    sm.apply_coarse_pass, co.coarse_constants = recording_pass, recording_build
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run.run(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counter.launches
        banded = {"cholesky_launches": bd.cholesky_banded.launches,
                  "sample_launches": bd.sample_conditional.launches}
    finally:
        sm.rebaseline_chi2 = rebaseline
        sm.apply_coarse_pass, co.coarse_constants = apply_pass, build
    run_peak = max([torch.cuda.max_memory_allocated()]
                   + [p["peak_bytes_before"] for p in passes])
    acc_sweeps = float(np.mean(run.trace("accept")))
    consistency = chi2_consistency(run)
    diag = run.diagnostics()
    # one sweep each of the tiled and the whole-cube kernel on the run's
    # problem and state, CUDA events
    whole = dataclasses.replace(run.problem, config=dataclasses.replace(
        cfg, engine="cuda", tile=None, chi2_rebaseline_every=0))
    state = ch.select_chains(run.states, 0)
    k2_ms = timed(lambda: tl.tiled_segment(run.problem, state, 1))[1]
    segment_of(sampler)(whole, state, 1)
    k1_ms = timed(lambda: segment_of(sampler)(whole, state, 1))[1]
    bound = sweep_bound(run.problem, 1, torch.tensor(
        [diag["acceptance_rate"]]))
    waves = tl.wave_schedule(run.problem.ny // cfg.tile[0],
                             run.problem.nx // cfg.tile[1])
    previous_ms = timed(lambda: tl.tuned_segment(
        run.problem, state, 1, lam_b=run.problem.L, **PREVIOUS_TILED))[1]
    emit("full_field", sampler=sampler, shape=list(cube.shape),
         f=run.problem.f, engine=cfg.engine, tile=cfg.tile,
         n_tiles=(run.problem.ny // cfg.tile[0]) * (run.problem.nx // cfg.tile[1]),
         schedule="wavefront", waves=len(waves),
         max_wave_tiles=max(map(len, waves)),
         steps=len(waves) * run.problem.n_colors,
         chi2_rebaseline_every=cfg.chi2_rebaseline_every, sweeps=n,
         launches=launches, setup_s=setup_s, sweeps_per_sec=n / dt,
         ms_per_sweep=dt / n * 1e3, tiled_kernel_ms_per_sweep=k2_ms,
         whole_cube_kernel_ms_per_sweep=k1_ms,
         tiled_kernel_earlier_design_ms_per_sweep=previous_ms,
         bound_ms_per_sweep=bound["bound_ms"],
         rebaselines=resets, chi2_consistency_end=consistency,
         coarse_every=cfg.coarse_every, coarse_mode=cfg.coarse_mode,
         coarse_passes=passes, coarse_constants_builds=builds, **banded,
         acceptance=diag["acceptance_rate"], acceptance_of_sweeps=acc_sweeps,
         acceptance_per_sweep=run.trace("accept")[0].tolist(),
         setup_peak_bytes=setup_peak, run_peak_bytes=run_peak,
         chi2=diag["chi2"])
    check(launches == n, f"tiled kernel launched {launches} times for {n}")
    check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
    check(all(np.isfinite(diag[k]) for k in ("chi2", "acceptance_rate")),
          "diagnostics not finite")
    if sampler == "gibbs":
        check([r["sweep"] for r in resets] == [8, 16],
              f"rebaselines at {[r['sweep'] for r in resets]}, not 8 and 16")
        check(all(r["chi2_consistency_before"] <= 1e-5 for r in resets),
              "running chi2 drifted before a rebaseline")
        check(all(r["chunked_vs_monolithic"] <= 1e-6 for r in resets),
              "the chunked full_chi2 is not the monolithic one")
        check(all(r["full_chi2_peak_bytes"] < r["monolithic_peak_bytes"]
                  for r in resets),
              "the chunked full_chi2 did not lower the peak")
        check(diag["acceptance_rate"] == 1.0, "gibbs acceptance is not 1")
        check(not passes and not builds, "gibbs ran a coarse pass")
    else:
        check(not resets, "MH rebaselined")
        check([p["sweep"] for p in passes] == [8],
              f"coarse passes at {[p['sweep'] for p in passes]}, not 8")
        check(len(builds) == 1, "the pass constants were not built once")
        check(banded["cholesky_launches"] == 1
              and banded["sample_launches"] == builds[0]["patterns"] > 0,
              f"banded kernels launched {banded}: one Cholesky launch and "
              f"one draw for each of {builds[0]['patterns']} patterns "
              "expected")
        # the pass is an exact Gibbs move: k·L draws, every one accepted
        p0 = passes[0]
        check(p0["accepted"] == p0["proposed"]
              == builds[0]["patterns"] * run.problem.L,
              f"the pass accepted {p0['accepted']} of {p0['proposed']}")
        # 8 sweeps from the default start are the adaptation's transient:
        # both packages read 0.06-0.12 over their first 12 MH sweeps (on
        # the CPU: the JAX package at 30×30×600, the port at 34×34×3681),
        # and reach the 0.234 target after burn-in (phase main: sweeps
        # 200-400 in [0.15, 0.35])
        check(0.05 <= acc_sweeps <= 0.35,
              f"MH acceptance of the sweeps {acc_sweeps:.3f} out of "
              "[0.05, 0.35]")
    check_auto_engine("full_field", sampler, cfg.engine,
                      {"cuda_tiled": k2_ms, "cuda": k1_ms})
    return {"launches": launches, "ms": k2_ms, "shape": list(cube.shape),
            "sweeps_per_sec": n / dt, "sweeps": n,
            "passes": passes, "builds": builds, **banded,
            "bound": bound, "tile": list(cfg.tile), "waves": len(waves),
            "max_wave_tiles": max(map(len, waves)),
            "steps": len(waves) * run.problem.n_colors,
            "previous_ms": previous_ms}


def band_counter(sampler):
    return tl.band_gibbs if sampler == "gibbs" else tl.band_mh


#: the bands of a shard of nyl block rows: (name, first block row, rows)
def shard_bands(nyl):
    return [(name, rows0 // 17, nyb) for name, rows0, nyb, _
            in ks._band_rows(nyl, 17)]


def phase_band_launch():
    """(a) The band arguments of the tiled kernel (the TPU kernel's
    ``y_base``) on 68×68×600 (ny = 4): a band launch on block rows [by0,
    by0 + nyb) of the whole buffer against a launch on a buffer cut to the
    band's window rows [by0·f, by0·f + nyb·f + f − 1) whose row 0 is the
    field's block row by0 — top, interior and bottom, mh and gibbs, C = 1
    and 2, one sweep on the Philox draws: residual window, clean and
    log-scale rows and the band's outputs bit-equal; the cut launch's
    in-kernel draws against ``ops/philox.py`` at the field's rows."""
    cube = bench_cube(L=600, Y=68, X=68)
    out = []
    for sampler in ("mh", "gibbs"):
        problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler))
        f, nx, L = problem.f, problem.nx, problem.L
        for C in (1, 2):
            states = ch.init_chain_states(problem, C)
            for name, by0, nyb in shard_bands(problem.ny):
                n0 = band_counter(sampler).launches
                whole = tl.band_segment(problem, ch.stack_chains(
                    [copy_state(ch.select_chains(states, c))
                     for c in range(C)]), 1, (by0, nyb))
                cut_p = sw.cut_problem(problem, by0, nyb)
                cut = tl.band_segment(
                    cut_p, sw.cut_state(states, f, by0, nyb, "cuda"), 1,
                    (0, nyb), gy0=by0, record_uniforms=True)
                torch.cuda.synchronize()
                launches = band_counter(sampler).launches - n0
                w, c = whole.result.state, cut.result.state
                y0, rows = by0 * f, nyb * f
                equal = {
                    "resid": torch.equal(w.resid[..., y0:y0 + rows + f - 1, :],
                                         c.resid),
                    "clean": torch.equal(w.clean[..., y0:y0 + rows, :],
                                         c.clean),
                    "log_scale": torch.equal(
                        w.log_scale[..., y0:y0 + rows, :], c.log_scale),
                    "outputs": torch.equal(
                        whole.accept[..., by0 * nx:(by0 + nyb) * nx],
                        cut.accept) and torch.equal(
                        whole.dchi[..., by0 * nx:(by0 + nyb) * nx],
                        cut.dchi),
                }
                draws = (philox.sweep_uniforms if sampler == "mh"
                         else philox.gibbs_sweep_uniforms)
                want = torch.stack([draws(
                    key, 0, problem.n_colors, nyb * nx, L, device="cuda",
                    row0=by0 * nx) for key in sw._chain_keys(states.key)])
                equal["philox"] = torch.equal(cut.uniforms[0], want)
                moved = int((w.clean[..., y0:y0 + rows, :]
                             != states.clean[..., y0:y0 + rows, :]).sum())
                out.append({"sampler": sampler, "C": C, "band": name,
                            "by0": by0, "nyb": nyb, "launches": launches,
                            "voxels_moved": moved, "bit_equal": equal})
                check(launches == 2, f"band launches {launches}, expected 2")
                check(moved > 0, "the band moved nothing; check is vacuous")
                check(all(equal.values()), f"band {name} ({sampler}, C={C}): "
                      f"{[k for k, v in equal.items() if not v]} differ")
    emit("sharded_band_launch", shape=list(cube.shape), checks=out)
    return out


def phase_sharded_shards(n_mh=2, n_gibbs=1):
    """(b) Two shards on one card, ``Mesh([cuda:0] * 2)``, on 136×68×600
    (ny = 8, nyl = 4: all three bands): ``interior='cuda'`` (the band
    launches) against ``interior='torch'`` (the plain band scans) from one
    state, MH 2 sweeps on the field's Philox draws untied and injected,
    gibbs 1 sweep on the in-kernel Philox draws, under ``compare``'s
    tolerances; χ² consistency of the kernel run ≤ 1e-5; ms per sweep of
    both.  Then 2 chains × 2 shards against each chain alone on the 1×2
    mesh, bit for bit."""
    cube = bench_cube(L=600, Y=136, X=68)
    dev = torch.device("cuda", 0)
    mesh = Mesh([dev, dev], ("sp",))
    devices = mesh.rows("sp")[0]
    out = {}
    for sampler, n in (("mh", n_mh), ("gibbs", n_gibbs)):
        problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler))
        state = sm.init_state(problem)
        u = None
        if sampler == "mh":
            u0 = torch.stack([philox.sweep_uniforms(
                int(state.key), s, problem.n_colors, problem.ny * problem.nx,
                problem.L, device="cuda") for s in range(n)])
            u, plain = sw.untie_uniforms(
                problem, state, n, u0, reference=lambda p_, s_, k_, u_:
                ks.segment(p_, s_, k_, devices, "torch", u_))
            plain_ms = None
        else:
            plain, plain_ms = timed(lambda: ks.segment(
                problem, copy_state(state), n, devices, "torch"))
            plain_ms /= n
        counter = band_counter(sampler)
        n0 = counter.launches
        kern, kernel_ms = timed(lambda: ks.segment(
            problem, copy_state(state), n, devices, "cuda", u))
        launches = counter.launches - n0
        errs = compare(plain, kern, sampler)
        consistency = abs(float(kern.result.state.chi2) - float(
            sm.full_chi2(problem, kern.result.state))) / float(
            sm.full_chi2(problem, kern.result.state))
        ms = time_sweeps(lambda k: ks.segment(problem, state, k, devices,
                                              "cuda"), 4)
        if plain_ms is None:
            plain_ms = timed(lambda: ks.segment(
                problem, state, 1, devices, "torch"))[1]
        emit("sharded_shards_vs_plain", sampler=sampler,
             shape=list(cube.shape), mesh=str(mesh), sweeps=n,
             bands=shard_bands(problem.ny // 2), launches=launches,
             chi2_consistency=consistency, kernel_ms_per_sweep=ms,
             plain_ms_per_sweep=plain_ms, **errs)
        check(launches == 3 * 2 * n, f"{launches} band launches, expected "
              f"{3 * 2 * n}")
        check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
        out[sampler] = {"max_abs_err": errs["resid_max_abs_err"], "ms": ms,
                        "plain_ms": plain_ms, "shape": list(cube.shape),
                        "launches": launches,
                        "bound": sweep_bound(problem, 1, kern.accept)}
    # chains x spatial: each chain bit-equal to itself alone on 1 x 2
    problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(seed=0))
    states = ch.init_chain_states(problem, 2)
    mesh2 = Mesh([[dev, dev], [dev, dev]], ("ch", "sp"))
    mc = ch.run_chains(problem, 2, 2, mesh=mesh2, states=states,
                       axis_name="ch", spatial_axis="sp")
    equal = []
    for i in range(2):
        alone = ks.run_sweeps_kernel_sharded(
            problem, ch.select_chains(states, i), 2, mesh)
        equal.append(all(torch.equal(getattr(mc.result.state, name)[i],
                                     getattr(alone.state, name))
                         for name in ("clean", "resid", "log_scale", "chi2")))
    differ = not torch.equal(mc.result.state.clean[0],
                             mc.result.state.clean[1])
    emit("sharded_chains_x_spatial", shape=list(cube.shape),
         mesh=str(mesh2), sweeps=2, chain_alone_bit_equal=equal,
         chains_differ=differ)
    check(all(equal) and differ, "chains x spatial differs from the chains "
          "alone")
    return out


def phase_sharded_field(cube, unsharded, card, n=8, n_gibbs=3):
    """(c) The full field, 300×300×3681, in the default MH flow (8 sweeps
    and the coarse pass after sweep 8) through ``Run(spatial_mesh=1)`` and
    ``Run(spatial_mesh=Mesh([cuda:0] * 2))``, and ``n_gibbs`` gibbs sweeps
    through ``Run(spatial_mesh=Mesh([cuda:0] * 2), sampler='gibbs')``:
    band launches of the run (every count set to 0 just before it),
    sweeps/s, χ² consistency, peak memory; then one sweep of the band
    segment on the run's state with CUDA events around every band launch:
    ms per band launch, their sum over the sweep and the segment's ms per
    sweep including its layout copies and gathers.  Two ratios to the
    unsharded runs of ``full_field`` (``unsharded``): the sum of the band
    launches over the unsharded K2 sweep (both kernel time only), and, for
    MH, whose flows match (8 sweeps and the pass), the Run's sweeps/s over
    the unsharded Run's.  Beside the card's name and power limit
    (``card``, from ``nvidia-smi``)."""
    dev = torch.device("cuda", 0)
    two = Mesh([dev, dev], ("sp",))
    out = {}
    for label, mesh, sampler, n_run in (("D1", 1, "mh", n),
                                        ("D2", two, "mh", n),
                                        ("gibbs_D2", two, "gibbs", n_gibbs)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = d3.Run(cube, d3.MUSE(), max_iterations=n_run,
                     burn_in=n_run // 2, seed=0, sampler=sampler,
                     spatial_mesh=mesh)
        run.states
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        coarse_every = 8 if sampler == "mh" else None
        check(run._spatial_kernel and run.config.coarse_every == coarse_every,
              f"the sharded {sampler} run is not on the band path with "
              f"coarse_every={coarse_every}")
        D = run.spatial_mesh.shape["sp"]
        counter = band_counter(sampler)
        reset_launches()
        t0 = time.perf_counter()
        run.run(n_run)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counter.launches
        peak = torch.cuda.max_memory_allocated()
        final_digest = digest(run.states)
        consistency = chi2_consistency(run)
        diag = run.diagnostics()
        devices = run.spatial_mesh.rows("sp")[0]
        # ms per band launch: CUDA events around every launch of one sweep
        plan = ks._band_plan(run.problem, D)
        events, band_sweep = [], tl.band_sweep

        def timed_band(k, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            band_sweep(k, *args)
            end.record()
            events.append((k.rows, start, end))

        state = ch.select_chains(run.states, 0)
        tl.band_sweep = timed_band
        try:
            seg_ms = timed(lambda: ks.segment(run.problem, state, 1, devices,
                                              "cuda"))[1]
        finally:
            tl.band_sweep = band_sweep
        torch.cuda.synchronize()
        check(len(events) == 3 * D, f"{len(events)} band launches timed in "
              f"one sweep of {D} shards")
        per_band = {}
        for rows, start, end in events:
            name = next(b[0] for b in plan if b[1] // run.problem.f == rows[0])
            per_band.setdefault(name, []).append(start.elapsed_time(end))
        band_ms = {name: sum(v) / len(v) for name, v in per_band.items()}
        launches_ms = sum(sum(v) for v in per_band.values())
        bounds = {}
        for name, rows0, nyb, _, _ in plan:
            cut = sw.cut_problem(run.problem, rows0 // run.problem.f, nyb)
            bounds[name] = sweep_bound(cut, 1, torch.tensor(
                [diag["acceptance_rate"]]))
            del cut
        bound_ms = D * sum(b["bound_ms"] for b in bounds.values())
        base = unsharded[sampler]
        rate = n_run / dt
        rate_ratio = (rate / base["sweeps_per_sec"] if sampler == "mh"
                      else None)
        emit("sharded_field", card=card, sampler=sampler, mesh=label,
             shards=D, shape=list(cube.shape),
             sweeps=n_run, band_launches=launches,
             band_launches_per_sweep=launches / n_run,
             bands=[[b[0], b[1] // run.problem.f, b[2], list(b[4])]
                    for b in plan],
             setup_s=setup_s, sweeps_per_sec=rate, ms_per_sweep=dt / n_run * 1e3,
             ms_per_band_launch=band_ms, band_launches_ms_per_sweep=launches_ms,
             segment_ms_per_sweep_incl_copies=seg_ms,
             band_bound_ms={k: v["bound_ms"] for k, v in bounds.items()},
             sweep_bound_ms=bound_ms,
             unsharded_k2_ms_per_sweep=base["ms"],
             ratio_band_launches_to_unsharded_k2=launches_ms / base["ms"],
             unsharded_run_sweeps_per_sec=base["sweeps_per_sec"],
             ratio_run_rate_to_unsharded=rate_ratio,
             chi2_consistency=consistency, acceptance=diag["acceptance_rate"],
             peak_bytes=peak, chi2=diag["chi2"])
        check(launches == 3 * D * n_run, f"{launches} band launches for "
              f"{n_run} sweeps of {D} shards")
        check(consistency <= 1e-5, "running chi2 drifted from full_chi2")
        check(np.isfinite(diag["chi2"]), "chi2 not finite")
        out[label] = {"launches": launches, "band_ms": band_ms,
                      "launches_ms": launches_ms, "seg_ms": seg_ms,
                      "bounds": bounds, "bound_ms": bound_ms, "plan": plan,
                      "sweeps": n_run, "sweeps_per_sec": rate,
                      "digest": final_digest, "peak_bytes": peak,
                      "chi2_consistency": consistency}
        del run, state
    return out


# ---------------------------------------------------------------------------
# 13c. multihost: the port over 2 processes on the one card
# ---------------------------------------------------------------------------

#: a rank's seconds for any collective; the parent's limits on a probe and
#: on the ranks
RANK_TIMEOUT_S, PROBE_LIMIT_S, RANKS_LIMIT_S = 120, 60, 420
#: (d)'s direct draws, fewer than phase direct_sharded's 20: across two
#: ranks of one H100 (NCCL) a bench CG iteration takes 14.6 ms, against
#: 1.8 in one process
MULTIHOST_DRAWS = 6


def digest(obj) -> str:
    """A digest of every tensor of a dataclass, a dict or a tensor,
    computed on its device: per tensor its shape, dtype, the sum of its words and
    their sum weighted by odd per-position weights (int64, wrapping), so
    that any one changed word changes it."""
    import hashlib

    items = ([("", obj)] if isinstance(obj, torch.Tensor) else sorted(
        (obj if isinstance(obj, dict) else vars(obj)).items()))
    h = hashlib.sha256()
    chunk = 1 << 24
    for name, t in items:
        t = t.detach().contiguous().reshape(-1)
        words = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()]).to(torch.int64) \
            if t.dtype != torch.bool else t.to(torch.int64)
        plain = weighted = 0
        for i in range(0, words.numel(), chunk):
            w = words[i:i + chunk]
            pos = torch.arange(i, i + w.numel(), dtype=torch.int64,
                               device=w.device)
            plain += int(w.sum())
            weighted += int((w * (pos * 2654435761 * 2 + 1)).sum())
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype}:{plain}:{weighted};"
                 .encode())
    return h.hexdigest()[:32]


def state_tensors(state) -> dict:
    return {k: v.detach().cpu() for k, v in vars(state).items()}


def band_cube():
    """136×68×600 (f = 17, ny = 8): 4 block rows a shard at D = 2."""
    return bench_cube(L=600, Y=136, X=68)


def band_runs(mesh, cube):
    """(a): MH 2 sweeps and gibbs 1 through the band launches of
    ``run_sweeps_kernel_sharded`` on ``mesh`` from the initial state:
    {sampler: final state}, and the band launches."""
    out, launches = {}, {}
    for sampler, n in (("mh", 2), ("gibbs", 1)):
        problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler))
        counter = band_counter(sampler)
        n0 = counter.launches
        out[sampler] = ks.run_sweeps_kernel_sharded(
            problem, sm.init_state(problem), n, mesh, interior="cuda").state
        torch.cuda.synchronize()
        launches[sampler] = counter.launches - n0
    return out, launches


def direct_runs(mesh, n_draws=MULTIHOST_DRAWS):
    """(d): ``n_draws`` direct draws of ``Run(bench cube,
    sampler='direct', prior_precision='auto')`` and the MAP ('auto' τ, tol
    1e-6) of the MH ``Run``, phase ``direct_sharded``'s two runs, on
    ``mesh``: their results and counts."""
    cube = bench_cube()
    run = d3.Run(cube, d3.MUSE(), max_iterations=n_draws, seed=0,
                 sampler="direct", prior_precision="auto", spatial_mesh=mesh)
    run.states
    reset_launches()
    with PCGRecorder() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = bd.banded_solve.launches
    iters = [s["iterations"] for s in rec.solves]
    # ms per solve launch on this process's first slot's kx columns
    p = run.problem
    e = mesh.rows("sp")[0].local().index(True)
    a, b = ds.shards(p, mesh).cols[e]
    st = ds.slot_precond(p, mesh)
    cols = torch.randn((p.L, p.Y * (b - a) * 2), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(22))
    _, solve_ms = ms_per_call(lambda: bd.banded_solve(st.R[e], st.fidx[e],
                                                      cols), 20)
    del cols, st
    mrun = d3.Run(cube, d3.MUSE(), seed=0, spatial_mesh=mesh)
    with PCGRecorder() as mrec:
        m = mrun.map_estimate(prior_precision="auto", tol=1e-6)
    return {"state": state_tensors(ch.select_chains(run.states, 0)),
            "map_x": m.data.cpu(), "shape": list(cube.shape),
            "draws": n_draws, "draws_per_sec": n_draws / dt,
            "iterations_per_draw": iters,
            "applications": sum(i + 1 for i in iters),
            "solve_launches": launches, "solve_shape": [p.L, p.Y * (b - a) * 2],
            "solve_call_ms": solve_ms,
            "ms_per_iteration": sum(s["ms"] for s in rec.solves)
            / max(sum(iters), 1),
            "map_iterations": mrun.last_map_result.iterations,
            "map_ms_per_iteration": sum(s["ms"] for s in mrec.solves)
            / max(sum(s["iterations"] for s in mrec.solves), 1)}


def spawn_ranks(role, n, tmp, backend, env=None):
    """``n`` processes of this script in the role ``role`` (rank r of n),
    started together, their output in files under ``tmp``."""
    procs = []
    for r in range(n):
        fd, log = tempfile.mkstemp(prefix=f"{role}_{r}_", suffix=".log",
                                   dir=tmp)
        with os.fdopen(fd, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost",
                 role, str(r), str(n), backend, tmp],
                env={**os.environ, **(env[r] if env else {})},
                stdout=fh, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, limit):
    """Every process's (exit code, last lines of its output): all of them
    killed as soon as one fails or when the limit passes (None exit codes
    for those killed)."""
    deadline = time.monotonic() + limit
    while any(pr.poll() is None for pr, _ in procs):
        failed = any(pr.poll() not in (None, 0) for pr, _ in procs)
        if failed or time.monotonic() > deadline:
            for pr, _ in procs:
                if pr.poll() is None:
                    pr.kill()
            break
        time.sleep(0.2)
    out = []
    for pr, log in procs:
        pr.wait()
        with open(log) as fh:
            out.append((pr.returncode if pr.returncode >= 0 else None,
                        fh.read()[-3000:]))
    return out


def phase_multihost(sharded_field, card):
    """13c: the port over 2 processes (``parallel/multihost.py``), both on
    the one card: which transport two ranks of one card can use (NCCL,
    NCCL with a distinct ``NCCL_HOSTID`` per rank, else gloo staged
    through pinned host buffers), a 1-rank NCCL group through one band
    segment, then the 2 ranks through (a) the band sweeps at 136×68×600,
    (c) 2 chains × 1 slot, one chain row per rank, (d) the direct draws and
    MAP at the bench cube and (b) the full field in the default MH flow
    and 3 gibbs sweeps, each against this process's one-process run of the
    same slots (that of (a), (c) and (d) here, of (b) phase
    ``sharded_field``'s), every rank's states against rank 0's."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="multihost_")
    dev = torch.device("cuda", 0)
    # (a)'s one-process reference: the same slots in one process
    cube = band_cube()
    ref, _ = band_runs(Mesh([dev, dev], ("sp",)), cube)
    one_slot, _ = band_runs(Mesh([dev], ("sp",)), cube)
    direct = direct_runs(Mesh([dev, dev], ("sp",)))
    torch.save({
        "band": {s: state_tensors(st) for s, st in ref.items()},
        "one_slot": {s: state_tensors(st) for s, st in one_slot.items()},
        "direct": direct,
        "field": {k: sharded_field[k]["digest"] for k in ("D2", "gibbs_D2")},
    }, os.path.join(tmp, "reference.pt"))
    del cube, ref, one_slot
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the transport: NCCL refuses two ranks on one card ("Duplicate GPU");
    # a distinct NCCL_HOSTID per rank makes them two hosts to it.  Both
    # probes and the 1-rank NCCL group run at once.
    hostid = [{"NCCL_HOSTID": f"rank{r}", "NCCL_SOCKET_IFNAME": "lo"}
              for r in range(2)]
    probes = {
        "nccl": spawn_ranks("probe", 2, tmp, "nccl"),
        "nccl_hostid": spawn_ranks("probe", 2, tmp, "nccl", env=hostid),
        "gloo": spawn_ranks("probe", 2, tmp, "gloo"),
        "one_rank_nccl": spawn_ranks("one_rank", 1, tmp, "nccl"),
    }
    deadline = time.monotonic() + PROBE_LIMIT_S
    outcome = {k: wait_ranks(v, deadline - time.monotonic())
               for k, v in probes.items()}

    def summary(res):
        """ok, and the probe's timings or the first error it printed."""
        ok = all(rc == 0 for rc, _ in res)
        out = {"ok": ok, "exit_codes": [rc for rc, _ in res]}
        if ok and res[0][1].strip().endswith("}"):
            out.update(json.loads(res[0][1].strip().splitlines()[-1]))
        elif not ok:
            out["said"] = [next((ln for ln in log.splitlines()
                                 if "rror" in ln), log.strip()[-300:])[:300]
                           for _, log in res]
        return out

    transports = {k: summary(outcome[k])
                  for k in ("nccl", "nccl_hostid", "gloo")}
    one = summary(outcome["one_rank_nccl"])
    if one["ok"]:
        with open(os.path.join(tmp, "one_rank.json")) as fh:
            one.update(json.load(fh))
    backend = ("nccl" if transports["nccl"]["ok"]
               or transports["nccl_hostid"]["ok"] else "gloo")
    env = hostid if backend == "nccl" and not transports["nccl"]["ok"] \
        else None
    emit("multihost_transport", card=card,
         nccl_two_ranks_one_card={k: transports[k]
                                  for k in ("nccl", "nccl_hostid")},
         gloo=transports["gloo"], backend=backend, one_rank_nccl=one,
         parent_allocated_bytes=torch.cuda.memory_allocated(),
         probe_s=time.perf_counter() - t0)
    check(one["ok"] and one.get("bit_equal"), f"the 1-rank NCCL group: {one}")

    res = wait_ranks(spawn_ranks("rank", 2, tmp, backend, env),
                     RANKS_LIMIT_S)
    for r, (rc, log) in enumerate(res):
        check(rc == 0, f"multihost rank {r} exited {rc}:\n{log}")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    for r, out in enumerate(ranks):
        out["direct"]["one_process_ms_per_iteration"] = direct[
            "ms_per_iteration"]
        out["direct"]["one_process_map_ms_per_iteration"] = direct[
            "map_ms_per_iteration"]
        out["direct"]["one_process_solve_call_ms"] = direct["solve_call_ms"]
        for label in ("mh", "gibbs"):
            one = sharded_field["D2" if label == "mh" else "gibbs_D2"]
            out["field"][label]["one_process_sweeps_per_sec"] = one[
                "sweeps_per_sec"]
            out["field"][label]["rate_to_one_process"] = out["field"][
                label]["sweeps_per_sec"] / one["sweeps_per_sec"]
        for part in ("band", "chains", "direct", "field"):
            emit(f"multihost_{part}", rank=r, backend=backend, card=card,
                 **out[part])
    # every rank's states equal rank 0's
    digests = [out["digests"] for out in ranks]
    emit("multihost", backend=backend, ranks=2, digests_equal=all(
        d == digests[0] for d in digests), seconds=time.perf_counter() - t0)
    check(all(d == digests[0] for d in digests),
          f"the ranks' states differ: {digests}")
    for r, out in enumerate(ranks):
        check(all(out["band"]["bit_equal"].values()),
              f"rank {r}: the band sweeps differ from one process's")
        check(all(out["chains"]["chain_alone_bit_equal"]),
              f"rank {r}: a chain differs from itself alone")
        check(out["direct"]["iterations_equal"], f"rank {r}: the direct "
              "draws' iterations differ from one process's")
        check(out["direct"]["state_bit_equal"] or out["direct"][
            "state_rel_err"] <= 1e-6, f"rank {r}: the direct draws differ")
        check(out["direct"]["map_bit_equal"] or out["direct"][
            "map_rel_err"] <= 1e-6, f"rank {r}: the MAP differs")
        check(out["direct"]["solve_launches"] == out["direct"][
            "applications"] > 0, f"rank {r}: one solve launch per "
              "preconditioner application on its slot")
        for label in ("mh", "gibbs"):
            f = out["field"][label]
            check(f["digest_equal_one_process"], f"rank {r}: the {label} "
                  "field differs from the one-process D = 2 run")
            check(f["chi2_consistency"] <= 1e-5, f"rank {r}: {label} chi2 "
                  "drifted from full_chi2")
    return {"backend": backend, "ranks": ranks, "transports": transports}


def multihost_worker(role, rank, world, backend, tmp) -> int:
    """A process of phase ``multihost`` (this script run with
    ``--multihost``): ``probe`` joins a 2-rank group and moves 64 MB each
    way; ``one_rank`` runs one band segment on a 1-rank group; ``rank``
    runs (a)-(d)."""
    from deconv3d_tpu_torch.parallel import multihost as mh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    store = f"file://{tmp}/store_{role}_{backend}_" + (
        os.environ.get("NCCL_HOSTID", "") and "hostid")
    mh.initialize(store, world, rank, backend=backend,
                  timeout=RANK_TIMEOUT_S)
    if role == "probe":
        # 64 MB each way (checked), then the ms of one exchange of a
        # scalar (a slot sum) and of 64 MB each way, 20 of each
        x = torch.full((16 << 20,), float(rank), device=dev)
        parts = [x, None] if rank == 0 else [None, x]
        one = [x[:1], None] if rank == 0 else [None, x[:1]]

        def both_ways():
            return pm.ppermute(parts, 1, (0, 1)), pm.ppermute(parts, -1,
                                                              (0, 1))
        fwd, back = both_ways()
        got = back[0] if rank == 0 else fwd[1]
        check(float(got.mean()) == 1 - rank, "the probe's data")
        _, round_ms = timed(lambda: [pm.slot_sum(one, (0, 1))
                                     for _ in range(20)])
        _, bulk_ms = timed(lambda: [both_ways() for _ in range(20)])
        print(json.dumps({"round_ms": round_ms / 20,
                          "gb_per_s_each_way": 2 * 64e6 * 20
                          / (bulk_ms * 1e6)}))
        torch.distributed.destroy_process_group()
        return 0
    mesh = mh.global_mesh("sp", local_devices=[dev])
    reference = torch.load(os.path.join(tmp, "reference.pt"),
                           weights_only=False)
    if role == "one_rank":
        states, launches = band_runs(mesh, band_cube())
        equal = all(torch.equal(v.cpu(), reference["one_slot"][s][k])
                    for s, st in states.items()
                    for k, v in vars(st).items())
        with open(os.path.join(tmp, "one_rank.json"), "w") as fh:
            json.dump({"slots": mesh.shape["sp"], "band_launches": launches,
                       "bit_equal": equal, "shape": [600, 136, 68]}, fh)
        torch.distributed.destroy_process_group()
        return 0
    out = {"digests": {}}
    # (a) the band sweeps at 136×68×600
    cube = band_cube()
    states, launches = band_runs(mesh, cube)
    out["band"] = {"shape": list(cube.shape), "sweeps": {"mh": 2, "gibbs": 1},
                   "band_launches": launches, "bit_equal": {
                       s: all(torch.equal(v.cpu(), reference["band"][s][k])
                              for k, v in vars(st).items())
                       for s, st in states.items()}}
    out["digests"].update({f"band_{s}": digest(st)
                           for s, st in states.items()})
    # (c) 2 chains on a 2 x 1 mesh, one chain row per rank
    problem = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(seed=0))
    chains0 = ch.init_chain_states(problem, 2)
    mesh2 = Mesh(mesh.devices.reshape(2, 1), ("ch", "sp"),
                 ranks=mesh.ranks.reshape(2, 1))
    mc = ch.run_chains(problem, 2, 2, mesh=mesh2, states=chains0,
                       axis_name="ch", spatial_axis="sp").result.state
    alone = [ks.run_sweeps_kernel_sharded(
        problem, ch.select_chains(chains0, i), 2, Mesh([dev], ("sp",))).state
        for i in range(2)]
    out["chains"] = {"shape": list(cube.shape), "mesh": "2 x 1", "sweeps": 2,
                     "chain_alone_bit_equal": [
                         all(torch.equal(getattr(mc, k)[i], getattr(a, k))
                             for k in vars(a)) for i, a in enumerate(alone)],
                     "chains_differ": not torch.equal(mc.clean[0],
                                                      mc.clean[1])}
    out["digests"]["chains"] = digest(mc)
    del cube, problem, chains0, mc, alone, states
    # (d) the direct draws and the MAP at the bench cube
    got, want = direct_runs(mesh), reference["direct"]
    errs = {k: rel_err(v, want["state"][k]) for k, v in got["state"].items()
            if v.is_floating_point() and v.dim()
            and bool(want["state"][k].any())}
    out["digests"]["direct"] = digest(got["state"])
    out["digests"]["map"] = digest(got["map_x"])
    out["direct"] = {
        **{k: v for k, v in got.items() if k not in ("state", "map_x")},
        "iterations_equal": got["iterations_per_draw"]
        == want["iterations_per_draw"],
        "state_bit_equal": all(torch.equal(v, want["state"][k])
                               for k, v in got["state"].items()),
        "state_rel_err": max(errs.values()),
        "map_iterations_equal": got["map_iterations"]
        == want["map_iterations"],
        "map_bit_equal": torch.equal(got["map_x"], want["map_x"]),
        "map_rel_err": rel_err(got["map_x"], want["map_x"])}
    del got
    # (b) the full field: the default MH flow (8 sweeps, the pass), gibbs 3
    out["field"] = {}
    cube = field_cube()
    for label, sampler, n in (("mh", "mh", 8), ("gibbs", "gibbs", 3)):
        out["field"][label] = field_run(cube, sampler, n, mesh,
                                        reference["field"][
                                            "D2" if label == "mh"
                                            else "gibbs_D2"])
        out["digests"][f"field_{label}"] = out["field"][label]["digest"]
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def field_run(cube, sampler, n, mesh, want_digest):
    """(b) on one rank: ``Run(spatial_mesh=global mesh)`` of ``n`` sweeps
    in the default flow, with CUDA events around every band launch of the
    run, the host clock around every strip exchange (``ppermute``) and
    every gather of the segment's end (``mesh.gather``), both synchronised
    on entry; its final state's digest against the one-process D = 2
    run's."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = d3.Run(cube, d3.MUSE(), max_iterations=n, burn_in=n // 2, seed=0,
                 sampler=sampler, spatial_mesh=mesh)
    run.states
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    events, strips, gathers = [], [], []
    band_sweep, ppermute, gather = tl.band_sweep, ks.ppermute, pm.gather

    def timed_band(k, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        band_sweep(k, *args)
        end.record()
        events.append((start, end))

    def host_timed(fn, log):
        def wrapped(parts, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn(parts, *args, **kw)
            torch.cuda.synchronize()
            log.append(((time.perf_counter() - t) * 1e3, sum(
                p.numel() * p.element_size() for p in parts
                if p is not None)))
            return got
        return wrapped

    reset_launches()
    tl.band_sweep = timed_band
    ks.ppermute = host_timed(ppermute, strips)
    pm.gather = host_timed(gather, gathers)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        tl.band_sweep, ks.ppermute, pm.gather = band_sweep, ppermute, gather
    launches = band_counter(sampler).launches
    peak = torch.cuda.max_memory_allocated()
    got_digest = digest(run.states)
    consistency = chi2_consistency(run)
    band_ms = sum(s.elapsed_time(e) for s, e in events)
    del run
    torch.cuda.empty_cache()
    return {"shape": list(cube.shape), "sweeps": n,
            "band_launches": launches, "setup_s": setup_s,
            "sweeps_per_sec": n / dt,
            "band_launches_ms_per_sweep": band_ms / n,
            "strip_exchanges": len(strips),
            "strip_exchange_ms": sum(t for t, _ in strips) / max(
                len(strips), 1),
            "strip_exchange_bytes_sent": sum(b for _, b in strips) / max(
                len(strips), 1),
            "strip_exchange_ms_per_sweep": sum(t for t, _ in strips) / n,
            "segment_end_gathers": len(gathers),
            "segment_end_gather_ms": sum(t for t, _ in gathers),
            "segment_end_gather_bytes_held": sum(b for _, b in gathers),
            "peak_gb": peak / 1e9, "chi2_consistency": consistency,
            "digest": got_digest,
            "digest_equal_one_process": got_digest == want_digest}


# ---------------------------------------------------------------------------
# Phase statistics: every sweep kernel held to the exact posterior
# ---------------------------------------------------------------------------

#: the seeded geometries of phase statistics (c), their sweeps, and the
#: first sweeps compared with the plain versions: on the card a plain
#: gibbs sweep at lw = 11 takes 0.5–1.6 s of launches, and the plain tiled
#: scan pays a step per tile and color (up to 64 tiles here); one sweep
#: compares every draw, decision and log-scale update once
STAT_CASES, STAT_CASE_SEED, STAT_SWEEPS = 24, 14, 12
STAT_COMPARE_SWEEPS = {"whole": 1, "tiled": 1}
#: sweeps of the gibbs_block exact-start row (the JAX package has none;
#: the chains are stationary from sweep 0, so depth adds power only): a
#: block sweep takes ~0.3 s on the card at 32 chains (0.1 s at 8), and 80
#: keep the phase within its 120 s
BLOCK_SWEEPS = 80
#: float32 kernels: data − resid against conv(clean), of the data's scale
#: (tests/test_torch_run.py's float32 bound); running against full χ²
STAT_INVARIANT_TOL, STAT_CHI2_TOL = 1e-5, 1e-5


def stat_engines(sampler):
    """The engines of an exact-start row, ``{name: (RunConfig fields,
    segment or None)}``: ``whole`` the whole-cube engine's own choice (the
    resident kernel where ``plan_slabs`` fits the batch), ``classic`` K1
    pinned (the coarse passes between its segments, as ``run_sweeps``
    places them), ``tiled`` K2 in (1, 1) tiles."""
    def pinned(p, s, n):
        return sm.interleaved(p, s, n, lambda s_, k: classic_of(sampler)(
            p, s_, k).result)
    return {"whole": ({"engine": "cuda"}, None),
            "classic": ({"engine": "cuda"}, pinned),
            "tiled": ({"engine": "cuda_tiled", "tile": (1, 1)}, None)}


def launch_counts():
    return {"resident": sw.mh_segment.resident_launches
            + sw.gibbs_segment.resident_launches,
            "classic": sw.mh_segment.launches + sw.gibbs_segment.launches,
            "tiled": tl.tiled_mh.launches + tl.tiled_gibbs.launches,
            "banded_sample": bd.sample_conditional.launches}


def exact_start_row(dt, row, engine, n=None):
    """One exact-start row (``posterior_check.ROWS``; ``n`` sweeps in
    place of its own): the field's chains (``posterior_check.N_CHAINS``)
    as one batch through ``engine`` (``'block'``: the heavy field with
    ``sampler='gibbs_block'``), their monitored voxels and box sums
    against the exact posterior under the JAX package's bounds; the row's
    figures and failures."""
    field, sampler, n_row, coarse_every, _ = pc.ROWS[row]
    n = n or n_row
    if engine == "block":
        sampler = "gibbs_block"
        fields, segment = {"engine": "cuda"}, None
    else:
        fields, segment = stat_engines(sampler)[engine]
    reset_launches()
    t0 = time.perf_counter()
    tr, p, boxes, _ = pc.chain_traces(dt, sampler, n,
                                      coarse_every=coarse_every,
                                      device="cuda", segment=segment,
                                      **fields)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    figures, failures = pc.row_failures(dt, row, tr, p, boxes)
    # chains 0-7: the JAX package's 8-chain row (printed, not held: its
    # verdict fails under the null in either package, posterior_check)
    ref_figures, ref_failures = pc.row_failures(
        dt, row, tr[:pc.REFERENCE_CHAINS], p, boxes)
    # every sweep on the row's kernel (gibbs_block: one draw launch per
    # color for the batch)
    kernel = {"whole": "resident" if launches["resident"] else "classic",
              "classic": "classic", "tiled": "tiled",
              "block": "banded_sample"}[engine]
    want = n * (p.n_colors if engine == "block" else 1)
    if launches[kernel] != want:
        failures.append(f"{launches[kernel]} {kernel} launches for {want}")
    if coarse_every and not launches["banded_sample"]:
        failures.append("the coarse passes never launched the draw kernel")
    return {"row": row, "field": field, "engine": engine, "kernel": kernel,
            "sampler": sampler, "sweeps": n, "n_chains": tr.shape[0],
            "coarse_every": coarse_every, **figures,
            "reference_chains": {"n_chains": pc.REFERENCE_CHAINS,
                                 **ref_figures, "failures": ref_failures},
            "launches": launches, "seconds": seconds, "failures": failures}


def analytic_row(sampler):
    """The JAX package's analytic toy (``tests/test_sampler.py``: its rng
    seed 42, run seed 13, depth and bounds) in float32 through the
    whole-cube engine: the chain's moments against the exact posterior."""
    cube, inst, mean, sig = pc.analytic_toy(np.random.default_rng(42),
                                            dtype=np.float32,
                                            device="cuda")
    n, burn = pc.ANALYTIC_RUNS[sampler]
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=n, burn_in=burn, seed=pc.ANALYTIC_SEED,
        dtype=np.float32, fsf_size=3, lsf_width=3, sampler=sampler))
    reset_launches()
    t0 = time.perf_counter()
    r = sm.run_sweeps(p, sm.init_state(p), n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    acc = float(r.accept_trace[-1000:].mean()) if sampler == "mh" else None
    failures, figures = pc.analytic_failures(
        mean, sig,
        sm.posterior_mean(p, r.state).double().cpu().numpy().ravel(),
        sm.posterior_std(p, r.state).double().cpu().numpy().ravel(), acc)
    if launches["resident"] != n:
        failures.append(f"{launches['resident']} resident launches for {n}")
    return {"sampler": sampler, "sweeps": n, "burn_in": burn, **figures,
            "launches": launches, "seconds": seconds, "failures": failures}


def stat_geometries(n=STAT_CASES, seed=STAT_CASE_SEED):
    """``n`` seeded cases over L ∈ {9, 37, 130}, Y, X ∈ [5, 23], f ∈
    {3, 5, 7}, lw ∈ {1, 3, 11}, one masked spaxel or none, mh / gibbs,
    positivity, C ∈ {1, 3}, the FSF's FWHM in [0.1, 0.8] and a data seed."""
    rng = np.random.default_rng(seed)
    return [dict(L=int(rng.choice([9, 37, 130])),
                 Y=int(rng.integers(5, 24)), X=int(rng.integers(5, 24)),
                 f=int(rng.choice([3, 5, 7])), lw=int(rng.choice([1, 3, 11])),
                 mask=bool(rng.random() < 0.5),
                 sampler=str(rng.choice(["mh", "gibbs"])),
                 positivity=bool(rng.random() < 0.5),
                 C=int(rng.choice([1, 3])),
                 fwhm=float(rng.uniform(0.1, 0.8)),
                 seed=int(rng.integers(2**16)))
            for _ in range(n)]


def invariant_errors(p, state):
    """The worst over the chains of ``state``: |data − resid − conv(clean)|
    over the weighted voxels, of the data's scale; |χ²_running − χ²_full| /
    χ²_full; |clean| at masked spaxels; and min(clean)."""
    h = p.f // 2
    scale = float(p.data_pad.abs().max())
    w = p.w_pad[:, h:h + p.Y, h:h + p.X] > 0
    frozen = ~p.valid[: p.Y, : p.X]
    out = {"invariant": 0.0, "chi2": 0.0, "masked": 0.0,
           "clean_min": float("inf")}
    chains = [state] if state.clean.dim() == 3 else [
        ch.select_chains(state, c) for c in range(state.clean.shape[0])]
    for s in chains:
        clean = s.clean[:, : p.Y, : p.X]
        conv = cv.convolve_cube(clean, p.fsf, p.lsf)
        model = (p.data_pad - s.resid)[:, h:h + p.Y, h:h + p.X]
        full = float(sm.full_chi2(p, s))
        out["invariant"] = max(out["invariant"], float(
            (model - conv).abs()[w].max()) / scale)
        out["chi2"] = max(out["chi2"], abs(float(s.chi2) - full) / full)
        if bool(frozen.any()):
            out["masked"] = max(out["masked"],
                                float(clean[:, frozen].abs().max()))
        out["clean_min"] = min(out["clean_min"], float(clean.min()))
    return out


def philox_uniforms(p, state, n):
    """The MH uniforms ``[n, (C,) n_colors, nij, L + 1]`` that ``state``'s
    chains draw from Philox over its next ``n`` sweeps (``ops/philox.py``,
    the plain sweeps' and the kernels' streams)."""
    sweep0 = int(state.sweep.reshape(-1)[0])
    u = torch.stack([torch.stack([
        philox.sweep_uniforms(key, sweep0 + s, p.n_colors, p.ny * p.nx, p.L,
                              device="cuda")
        for key in sw._chain_keys(state.key)]) for s in range(n)])
    return u if state.clean.dim() == 4 else u[:, 0]


def stat_case(g):
    """One geometry of (c): 12 sweeps from one state of C chains through
    the whole-cube engine's kernel (resident where ``plan_slabs`` fits),
    classic K1 pinned, and K2 in (1, 1) tiles and, where nx is even, (1, 2)
    tiles; each on its own Philox draws against the residual invariant, χ²,
    the masked spaxel and, with positivity, clean ≥ 0; and each against its
    plain version on the same Philox draws (MH: untied) over
    :data:`STAT_COMPARE_SWEEPS`, under ``compare``'s tolerances."""
    rng = np.random.default_rng(g["seed"])
    L, Y, X = g["L"], g["Y"], g["X"]
    data = rng.normal(size=(L, Y, X)).astype(np.float32)
    mask = None
    if g["mask"]:
        mask = np.zeros((Y, X), bool)
        mask[rng.integers(Y), rng.integers(X)] = True
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                             mask=mask, crval=4750.0, cdelt=1.25,
                             device="cuda")
    inst = d3.Instrument(fsf=d3.GaussianFSF(fwhm=g["fwhm"]),
                         lsf=d3.GaussianLSF(fwhm=1.5))
    sampler, C, n = g["sampler"], g["C"], STAT_SWEEPS
    base = dict(max_iterations=n, burn_in=4, seed=g["seed"],
                fsf_size=g["f"], lsf_width=g["lw"], sampler=sampler,
                positivity=g["positivity"])
    p = sm.make_problem(cube, inst, sm.RunConfig(engine="cuda", **base))
    state = ch.init_chain_states(p, C) if C > 1 else sm.init_state(p)
    S, lw = int(p.fsf_spec.shape[0]), int(p.lsf.shape[1])
    plan = rs.plan_slabs(C, p.f, p.ny, p.nx, L, S, lw, sampler,
                         *rs.device_limits("cuda"),
                         positivity=g["positivity"])
    plain_whole = {"mh": sw.mh_segment_reference,
                   "gibbs": sw.gibbs_segment_reference}[sampler]
    runs = [("whole", p, segment_of(sampler), plain_whole),
            ("classic", p, classic_of(sampler), plain_whole)]
    for tile in [(1, 1)] + ([(1, 2)] if p.nx % 2 == 0 else []):
        pt = sm.make_problem(cube, inst, sm.RunConfig(
            engine="cuda_tiled", tile=tile, **base))
        runs.append((f"tiled_{tile[0]}x{tile[1]}", pt, tl.tiled_segment,
                     tl.tiled_segment_reference))
    out = {"case": dict(g, f_resolved=p.f, ny=p.ny, nx=p.nx, lw_resolved=lw,
                        rank=S), "plan": plan, "kernels": {}, "failures": []}
    plain_of = {}
    t_case = time.perf_counter()
    for name, prob, seg, ref in runs:
        k = STAT_COMPARE_SWEEPS["whole" if prob.config.tile is None
                                else "tiled"]
        t0 = time.perf_counter()
        if name != "classic":       # classic K1 takes the whole-cube one's
            if sampler == "mh":
                u, plain = sw.untie_uniforms(prob, state, k, philox_uniforms(
                    prob, state, k), reference=ref)
            else:
                u, plain = None, ref(prob, copy_state(state), k)
            plain_of = (u, plain)
        u, plain = plain_of
        plain_s = time.perf_counter() - t0
        before = launch_counts()
        own = seg(prob, copy_state(state), n)
        errs = invariant_errors(prob, own.result.state)
        kern = (seg(prob, copy_state(state), k) if u is None
                else seg(prob, copy_state(state), k, u))
        torch.cuda.synchronize()
        after = launch_counts()
        errs["launches"] = {kk: after[kk] - before[kk]
                            for kk in ("resident", "classic", "tiled")}
        errs["compared_sweeps"], errs["plain_seconds"] = k, plain_s
        try:
            cmp = compare(plain, kern, sampler)
        except AssertionError as e:
            cmp = {}
            out["failures"].append(f"{name}: against its plain version: {e}")
        errs.update({kk: cmp.get(kk) for kk in (
            "resid_max_abs_err", "resid_tol", "clean_max_abs_err",
            "chi2_rel_err", "decisions_or_counts_equal")})
        bad = []
        if errs["invariant"] > STAT_INVARIANT_TOL:
            bad.append(f"invariant {errs['invariant']:.3e}")
        if errs["chi2"] > STAT_CHI2_TOL:
            bad.append(f"chi2 {errs['chi2']:.3e}")
        if errs["masked"] != 0.0:
            bad.append(f"a masked spaxel moved by {errs['masked']:.3e}")
        if g["positivity"] and errs["clean_min"] < 0.0:
            bad.append(f"clean below 0 ({errs['clean_min']:.3e})")
        out["failures"] += [f"{name}: {b}" for b in bad]
        out["kernels"][name] = errs
    out["seconds"] = time.perf_counter() - t_case
    return out


def phase_statistics():
    """Every sweep kernel held to the exact posterior, and the residual
    invariant over a seeded list of geometries (module docstring, 14)."""
    t_phase = time.perf_counter()
    truths = {field: pc.make_truth(fwhm) for field, fwhm in pc.FWHM.items()}
    # the coarse row on the whole-cube engine: the pass is the same
    # code after every engine's segment
    rows = [exact_start_row(truths[pc.ROWS[row][0]], row, engine)
            for row in pc.ROWS for engine in ("whole", "classic", "tiled")
            if engine == "whole" or not pc.ROWS[row][3]]
    rows.append(exact_start_row(truths["heavy"], "heavy-gibbs", "block",
                                BLOCK_SWEEPS))
    for row in rows:
        emit("statistics_row", **row)
    # the kernel the whole-cube engine takes for the fields' chain batch
    p = sm.make_problem(truths["heavy"]["cube"].to("cuda"),
                        truths["heavy"]["inst"],
                        sm.RunConfig(fsf_size=pc.FIELD["fsf_size"]))
    S, lw = int(p.fsf_spec.shape[0]), int(p.lsf.shape[1])
    plans = {mode: rs.plan_slabs(pc.N_CHAINS, p.f, p.ny, p.nx, p.L, S, lw,
                                 mode, *rs.device_limits("cuda"))
             for mode in ("mh", "gibbs")}
    analytic = [analytic_row(sampler) for sampler in ("mh", "gibbs")]
    for row in analytic:
        emit("statistics_analytic", **row)
    cases = []
    for g in stat_geometries():
        cases.append(stat_case(g))
        emit("statistics_case", **cases[-1])
    seconds = time.perf_counter() - t_phase
    worst = {k: max(kern[k] for c in cases for kern in c["kernels"].values())
             for k in ("invariant", "chi2", "masked")}
    print(json.dumps({"statistics": {
        "seconds": seconds,
        "whole_engine_plan": {"n_chains": pc.N_CHAINS, **{
            m: None if v is None else {"lam_b": v[0], "blocks": v[1]}
            for m, v in plans.items()}},
        "rows": [{k: r.get(k) for k in (
            "row", "field", "engine", "kernel", "sampler", "sweeps",
            "coarse_every", "max_abs_z_mean", "q95_abs_z_mean",
            "var_ratio_range", "sharp_fraction", "max_abs_z_var_sharp",
            "q95_abs_z_var_sharp", "reference_chains", "seconds",
            "failures")} for r in rows],
        "analytic": analytic,
        "cases": [{"case": c["case"], "plan": c["plan"],
                   "kernels": c["kernels"], "failures": c["failures"]}
                  for c in cases],
        "worst_case_errors": worst}}), flush=True)
    failed = ([f"row {r['row']} {r['engine']} ({r['sampler']}): "
               f"{r['failures']}" for r in rows if r["failures"]]
              + [f"analytic {r['sampler']}: {r['failures']}"
                 for r in analytic if r["failures"]]
              + [f"case {i}: {c['failures']}"
                 for i, c in enumerate(cases) if c["failures"]])
    check(not failed, f"phase statistics: {failed}")
    return {"seconds": seconds, "rows": rows, "analytic": analytic,
            "cases": cases}


EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")

#: the kernels each example should launch on one card (module docstring, 15)
EXAMPLE_KERNELS = {
    "torch_basic_deconvolution": (
        ("resident_gibbs_kernel", "gibbs_sweep"), ("banded_solve",)),
    "torch_multichain_diagnostics": (
        ("resident_gibbs_kernel", "gibbs_sweep"), ("banded_cholesky",),
        ("banded_sample_conditional",)),
    "torch_sharded_fullfield": (
        ("resident_mh_kernel", "mh_sweep"), ("tiled_mh<band>",),
        ("banded_cholesky",), ("banded_sample_conditional",),
        ("banded_solve",)),
}


def launches_by_kernel():
    """Every kernel wrapper's launch count since :func:`reset_launches`,
    under the kernel's name in the ``kernels`` line; zeros left out."""
    counts = {
        "resident_mh_kernel": sw.mh_segment.resident_launches,
        "resident_gibbs_kernel": sw.gibbs_segment.resident_launches,
        "mh_sweep": sw.mh_segment.launches,
        "gibbs_sweep": sw.gibbs_segment.launches,
        "tiled_mh": tl.tiled_mh.launches,
        "tiled_gibbs": tl.tiled_gibbs.launches,
        "tiled_mh<band>": tl.band_mh.launches,
        "tiled_gibbs<band>": tl.band_gibbs.launches,
        "banded_cholesky": bd.cholesky_banded.launches,
        "banded_sample_conditional": bd.sample_conditional.launches,
        "banded_solve": bd.banded_solve.launches,
    }
    return {k: v for k, v in counts.items() if v}


def run_example(name, tmp):
    """``main("cuda")`` of ``examples/{name}.py`` at its own depth, in
    ``tmp``, the counts set to 0 just before: (the module, its figures,
    wall seconds, launches by kernel, the expected kernels not launched)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_launches()
        t0 = time.perf_counter()
        out = mod.main("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = launches_by_kernel()
    missing = [" or ".join(alts) for alts in EXAMPLE_KERNELS[name]
               if not any(k in launches for k in alts)]
    return mod, out, wall, launches, missing


def phase_examples():
    """The three example scripts at their own depth on the card (module
    docstring, 15): each one's figures held, its wall seconds and the
    kernels it launched on one ``{"examples": ...}`` line."""
    t_phase = time.perf_counter()
    line, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        mod, b, wall, launches, missing = run_example(
            "torch_basic_deconvolution", tmp)
        band = mod.JAX_CPU_FIGURES
        products = [os.path.join(tmp, f"deconv_out_{s}") for s in (
            "clean.fits", "std.fits", "convolved.fits", "traces.npz",
            "stats.json")]
        consistency = chi2_consistency(b["run"])
        line["basic"] = {
            "seconds": wall, "launches": launches, "missing": missing,
            "chi2_dof": b["chi2_dof"], "acceptance": b["acceptance"],
            "peak": b["peak"], "map_peak": b["map_peak"],
            "map_iterations": b["map_iterations"],
            "map_rel_residual": b["map_rel_residual"],
            "chi2_consistency": consistency,
            "jax_cpu_figures": band, "chi2_dof_band": mod.CHI2_DOF_BAND,
            "products": [os.path.basename(p) for p in products
                         if os.path.isfile(p)]}
        if abs(b["chi2_dof"] - band["chi2_dof"]) > mod.CHI2_DOF_BAND:
            failed.append(f"basic chi2/dof {b['chi2_dof']:.4f} outside "
                          f"{band['chi2_dof']} ± {mod.CHI2_DOF_BAND:.4f}")
        if (b["peak"], b["map_peak"]) != (band["peak"], band["map_peak"]):
            failed.append(f"basic peaks {b['peak']}, {b['map_peak']}")
        if b["acceptance"] != 1.0:
            failed.append(f"basic gibbs acceptance {b['acceptance']}")
        if consistency > 1e-5:
            failed.append(f"basic chi2 consistency {consistency:.3e}")
        if len(line["basic"]["products"]) != len(products):
            failed.append(f"basic saved {line['basic']['products']}")
        del b

        _, m, wall, launches, missing = run_example(
            "torch_multichain_diagnostics", tmp)
        free = m["problem"].valid[: m["problem"].Y, : m["problem"].X]
        free = free.cpu().numpy()
        rhat_free = m["rhat"][:, free]
        line["multichain"] = {
            "seconds": wall, "launches": launches, "missing": missing,
            "diagnostics": m["diagnostics"],
            "rhat_median": m["rhat_median"], "rhat_p99": m["rhat_p99"],
            "rhat_free_finite": bool(np.isfinite(rhat_free).all()),
            "posterior_mean_shape": m["posterior_mean_shape"]}
        if not line["multichain"]["rhat_free_finite"]:
            failed.append(f"multichain: {int((~np.isfinite(rhat_free)).sum())}"
                          " free voxels with a non-finite R-hat")
        if m["posterior_mean_shape"] != (32, 16, 16):
            failed.append(f"multichain mean shape {m['posterior_mean_shape']}")
        del m

        _, s, wall, launches, missing = run_example(
            "torch_sharded_fullfield", tmp)
        topologies = {}
        for key, run in s["runs"].items():
            worst = max(chi2_consistency(run, c) for c in range(run.n_chains))
            topologies[key] = {"chi2_consistency": worst,
                               "n_chains": run.n_chains,
                               "engine": run.config.engine}
            if worst > 1e-5:
                failed.append(f"sharded {key}: chi2 consistency {worst:.3e}")
        accept = s["runs"]["sharded_direct"].trace("accept")
        topologies["sharded_direct"]["converged"] = int((accept == 1).sum())
        topologies["sharded_direct"]["draws"] = int(accept.size)
        if not np.all(accept == 1.0):
            failed.append("sharded direct: unconverged draws")
        if s["chains_x_spatial_chains"] != 2:
            failed.append("chains x spatial did not return 2 chains")
        line["sharded"] = {
            "seconds": wall, "launches": launches, "missing": missing,
            "topologies": topologies,
            **{k: s[k] for k in ("spatial", "chains_x_spatial",
                                 "sharded_direct")},
            "chains_diagnostics": s["chains"]}
        del s
    line["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"examples": line}, default=float), flush=True)
    check(not failed, f"phase examples: {failed}")
    return line


def jax_layout_npz(path, states, chi2_scale=1.0):
    """``states`` (chain-stacked) written as the JAX package's
    ``checkpoint.save_state`` writes a ``Run``'s, from the port's copy of
    that layout: the fields as ``leaf_i`` in ``checkpoint.JAX_LEAVES``
    order, ``checkpoint.JAX_TREEDEF``, each key as two uint32 words (high
    first), ``sweep`` int32; χ² times ``chi2_scale`` (a JAX run's χ² is on
    its own weights)."""
    payload = {}
    for i, name in enumerate(ckpt.JAX_LEAVES):
        a = getattr(states, name).detach().cpu().numpy()
        if name == "key":
            k = a.astype(np.int64).view(np.uint64)
            a = np.stack([k >> np.uint64(32), k & np.uint64(0xFFFFFFFF)],
                         axis=-1).astype(np.uint32)
        elif name == "sweep":
            a = a.astype(np.int32)
        elif name == "chi2":
            a = a * np.float32(chi2_scale)
        payload[f"leaf_{i}"] = a
    payload["treedef"] = np.array(ckpt.JAX_TREEDEF)
    payload["meta"] = np.array(json.dumps(
        {"sweeps_done": int(states.sweep.reshape(-1)[0])}))
    np.savez(path, **payload)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(sm.SamplerState))


def phase_checkpoint(n_first=8, n_more=4):
    """Phase 16 (module docstring): a resume on the card bit-equal to an
    unbroken run, the DCP backend sync and async, and a state in the JAX
    package's leaf layout resumed and run on."""
    t_phase = time.perf_counter()
    cube = bench_cube()
    kw = dict(max_iterations=n_first + n_more, burn_in=n_first, seed=0)
    line = {"shape": list(cube.shape), "sweeps": [n_first, n_more]}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "run")
        first = d3.Run(cube, d3.MUSE(), checkpoint_path=npz, **kw)
        check(first.problem.config.engine == "cuda", "Run did not pick the "
              "kernel")
        reset_launches()
        first.run(n_first)
        resumed = d3.Run(cube, d3.MUSE(), **kw).resume(npz)
        loaded = same_state(resumed.states, first.states)
        resumed.run(n_more)
        whole = d3.Run(cube, d3.MUSE(), **kw)
        whole.run(n_first + n_more)
        torch.cuda.synchronize()
        line["resident_launches"] = sw.mh_segment.resident_launches
        line["npz_bytes"] = os.path.getsize(npz + ".npz")
        line["resume_loaded_bit_equal"] = loaded
        line["resume_bit_equal_to_unbroken"] = same_state(resumed.states,
                                                         whole.states)
        state = first.states
        like = ch.init_chain_states(first.problem, 1)
        for name, async_ in (("dcp_sync", False), ("dcp_async", True)):
            path = os.path.join(tmp, name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fut = ckpt.save_state_dcp(path, state, meta={"sweeps_done":
                                                         n_first},
                                      async_=async_)
            returned = time.perf_counter() - t0
            if async_:
                fut.result()
            done = time.perf_counter() - t0
            got, meta = ckpt.load_state_dcp(path, like)
            line[name] = {"seconds": done, "returned_after_s": returned,
                          "bytes": dir_bytes(path),
                          "bit_equal": same_state(got, state)
                          and meta == {"sweeps_done": n_first},
                          "on": str(got.clean.device)}
        jax_npz = os.path.join(tmp, "jax_layout.npz")
        jax_layout_npz(jax_npz, state, chi2_scale=1.0 + 1e-3)
        carried = d3.Run(cube, d3.MUSE(), **kw).resume(jax_npz)
        rebased = sm.rebaseline_chi2(carried.problem, state)
        line["jax_layout"] = {
            "format": ckpt.checkpoint_format(jax_npz),
            "fields_bit_equal": all(torch.equal(
                getattr(carried.states, f.name), getattr(state, f.name))
                for f in dataclasses.fields(sm.SamplerState)
                if f.name not in ("chi2", "chi2_comp")),
            "chi2_rebaselined": bool(torch.equal(carried.states.chi2,
                                                 rebased.chi2))}
        carried.run(n_more)
        line["jax_layout"]["chi2_consistency"] = chi2_consistency(carried)
    line["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"checkpoint": line}), flush=True)
    check(line["resident_launches"] == 2 * (n_first + n_more),
          f"the resident kernel launched {line['resident_launches']} times")
    check(loaded and line["resume_bit_equal_to_unbroken"],
          "the resumed run is not the unbroken one")
    check(line["dcp_sync"]["bit_equal"] and line["dcp_async"]["bit_equal"],
          "a DCP round trip changed the state")
    jl = line["jax_layout"]
    check(jl["format"] == "jax" and jl["fields_bit_equal"]
          and jl["chi2_rebaselined"], f"the JAX layout did not carry: {jl}")
    check(jl["chi2_consistency"] <= 1e-5,
          "the resumed JAX-layout run drifted from full_chi2")
    return line


class WarningCounts(logging.Handler):
    """Counts the port's log warnings by their first clause, so that the
    warnings of the many runs of a smoke fit one line."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.counts = {}

    def emit(self, record):
        head = record.getMessage().split(":")[0][:100]
        self.counts[head] = self.counts.get(head, 0) + 1


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    # the phases run under PyTorch's default TF32 flags, as a user's
    # program does; the port's own guard (convolve.no_tf32) must keep χ²
    # exact and leave the flags as it found them
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    emit("device", name=device_name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         tf32_matmul=tf32[0], tf32_cudnn=tf32[1])

    warnings = WarningCounts()
    port_log = logging.getLogger("deconv3d_tpu_torch")
    port_log.addHandler(warnings)
    port_log.propagate = False

    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=_build.build_seconds, ptxas=ptxas)

    kernel, ctx = {}, {}
    kernel["mh"], ctx["mh"] = phase_kernel()
    kernel["gibbs"], ctx["gibbs"] = phase_gibbs_kernel()
    resident = {sampler: phase_resident(sampler, ctx[sampler],
                                        kernel[sampler]["ms"])
                for sampler in ("mh", "gibbs")}
    del ctx
    with tempfile.TemporaryDirectory() as tmp:
        main_path = {sampler: phase_main(tmp, sampler)
                     for sampler in ("mh", "gibbs")}
    batched = {sampler: phase_chains(sampler, main_path[sampler]["rate"])
               for sampler in ("mh", "gibbs")}
    phase_full_lambda("mh", 20)
    phase_full_lambda("gibbs", 10)
    tiled = phase_tiled_kernel()
    phase_tiled_vs_whole()
    coarse = phase_coarse()
    phase_band_launch()
    sharded = phase_sharded_shards()
    phase_trunc_normal()
    positivity = phase_positivity()
    block = phase_gibbs_block()
    with tempfile.TemporaryDirectory() as tmp:
        direct = phase_direct(tmp)
        direct_sharded = phase_direct_sharded(tmp, direct)
    cube = field_cube()
    field = {sampler: phase_full_field(sampler, n, cube)
             for sampler, n in (("gibbs", 16), ("mh", 8))}
    sharded_field = phase_sharded_field(cube, field, smi)
    direct["field"] = phase_direct_field(cube)
    direct_sharded["field"] = phase_direct_sharded_field(cube,
                                                         direct["field"])
    del cube, direct["field"]["map_x"]
    multihost = phase_multihost(sharded_field, smi)
    statistics = phase_statistics()
    phase_examples()
    phase_checkpoint()
    check((torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32) == tf32,
          "the port changed the process's TF32 flags")
    emit("log", warnings=warnings.counts)
    emit("wall", seconds=time.perf_counter() - t_start)

    def bound(b):
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bound_flops": b["flops"], "bound_bytes": b["bytes"],
                **{k: b[k] for k in ("latency_steps", "latency_steps_before")
                   if k in b}}

    def other_shape(d):
        """A comparison phase's numbers, kept under the key of its shape."""
        return {"max_abs_err": d["max_abs_err"], "ms": d["ms"],
                "plain_ms": d["plain_ms"], **bound(d["bound"]),
                **({"call_ms": d["call_ms"]} if "call_ms" in d else {})}

    #: how the segmented kernels' ms were taken
    device_ms_is = ("device time per launch (torch.profiler, CUPTI); "
                    "call_ms: CUDA events per wrapper call, host included")

    def band_fields(sampler):
        """The band launches of the same kernel (its y_base port) on the
        sharded full field, Run(spatial_mesh=Mesh([cuda:0] * 2)): the
        launches of that run, the ms of one sweep's launches (CUDA events);
        the error and the plain version's time from phase (b)."""
        d2 = sharded_field["D2" if sampler == "mh" else "gibbs_D2"]
        return {"band_launches": d2["launches"],
                "band_launches_path": "sharded_field, Run(spatial_mesh="
                f"Mesh([cuda:0] * 2), sampler={sampler!r}), "
                f"{d2['sweeps']} sweeps",
                "band_ms_per_launch": d2["band_ms"],
                "band_bound_ms_per_launch": {
                    k: v["bound_ms"] for k, v in d2["bounds"].items()},
                "band_launches_ms_per_sweep": d2["launches_ms"],
                "band_bound_ms_per_sweep": d2["bound_ms"],
                "band_max_abs_err_600x136x68":
                    sharded[sampler]["max_abs_err"],
                "band_plain_ms_per_sweep_600x136x68":
                    sharded[sampler]["plain_ms"],
                "multihost_band_launches_per_rank": [
                    r["field"][sampler]["band_launches"]
                    for r in multihost["ranks"]],
                "multihost_band_launches_path": "multihost (b), Run("
                f"spatial_mesh=global_mesh()), sampler={sampler!r}, 2 ranks "
                f"on cuda:0 ({multihost['backend']}), "
                f"{multihost['ranks'][0]['field'][sampler]['sweeps']} sweeps",
                "multihost_band_launches_ms_per_sweep_per_rank": [
                    r["field"][sampler]["band_launches_ms_per_sweep"]
                    for r in multihost["ranks"]]}

    # every entry's launches, ms and bound_ms come from the one path that
    # launches it (its ms between CUDA events on that path's state);
    # max_abs_err and plain_ms from the comparison at the shape named
    k1 = "deconv3d_tpu/ops/pallas_sweep.py:102"
    gibbs_lines = " (mode gibbs, :243-314)"
    modes = {"mh": ":309-327", "gibbs": ":328-381"}
    lines = [{
        "name": f"resident_{sampler}_kernel",
        "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/resident_sweep.cu",
        "replaces": k1 + (gibbs_lines if sampler == "gibbs" else ""),
        "launches": main_path[sampler]["launches"],
        "launches_path": "main" if sampler == "mh" else "gibbs_main",
        "shape": main_path[sampler]["shape"], "n_chains": 1,
        "max_abs_err": resident[sampler]["max_abs_err"],
        "ms": resident[sampler]["ms"],
        "plain_ms": resident[sampler]["plain_ms"],
        **bound(main_path[sampler]["bound"]), "library_ms": None,
        "classic_ms": resident[sampler]["classic_ms"],
        "barrier_us": resident[sampler]["barrier_us"],
    } for sampler in ("mh", "gibbs")] + [{
        "name": f"{sampler}_sweep",
        "route": "cuda",
        "source": f"deconv3d_tpu_torch/csrc/{sampler}_sweep.cu",
        "replaces": k1 + (gibbs_lines if sampler == "gibbs" else ""),
        "launches": batched[sampler]["launches"],
        "launches_path": "chains (Run(n_chains=32))",
        "shape": batched[sampler]["shape"], "n_chains": 32,
        "max_abs_err": kernel[sampler]["n_chains_32"]["max_abs_err"],
        "ms": batched[sampler]["ms"],
        "plain_ms": kernel[sampler]["n_chains_32"]["plain_ms"],
        **bound(batched[sampler]["bound"]), "library_ms": None,
        "n_chains_1_600x30x30": other_shape(kernel[sampler]),
    } for sampler in ("mh", "gibbs")] + [{
        "name": f"tiled_{sampler}",
        "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/tiled_sweep.cu",
        "replaces": "deconv3d_tpu/ops/pallas_tiled.py:154"
                    f" (mode {sampler}, {modes[sampler]})",
        "launches": field[sampler]["launches"],
        "launches_path": "full_field",
        "shape": field[sampler]["shape"], "n_chains": 1,
        "max_abs_err": tiled[sampler]["max_abs_err"],
        "ms": field[sampler]["ms"],
        "plain_ms": tiled[sampler]["plain_ms"],
        "max_abs_err_and_plain_ms_at": tiled[sampler]["shape"],
        "max_abs_err_and_plain_ms_tile": list(FIELD_TILE),
        **bound(field[sampler]["bound"]), "library_ms": None,
        "at_600x68x68": other_shape(tiled[sampler]["at_600x68x68"]),
        "max_abs_err_3681x34x68": tiled[sampler]["max_abs_err_3681x34x68"],
        "tile": field[sampler]["tile"], "schedule": "wavefront",
        "waves": field[sampler]["waves"],
        "max_wave_tiles": field[sampler]["max_wave_tiles"],
        "schedule_note": "one tile per wave at this tile: the wavefront is "
                         "the raster here"
                         if field[sampler]["max_wave_tiles"] == 1 else None,
        "steps": field[sampler]["steps"],
        **band_fields(sampler),
        "previous_ms": field[sampler]["previous_ms"],
        "previous_ms_is": "this run's sweep in the kernel's earlier design: "
                          "raster of (1, 2) tiles, synchronous loads, one "
                          "block per spaxel in gibbs phase (b)",
    } for sampler in ("mh", "gibbs")]
    # the banded kernels: launches on the default MH flow of full_field,
    # everything else at that flow's shapes (the constants factor all
    # patterns in one launch, each draw is one system)
    n_patterns = field["mh"]["builds"][0]["patterns"]
    for part, name, n_sys, launches in (
            ("cholesky", "banded_cholesky", n_patterns, "cholesky_launches"),
            ("sample", "banded_sample_conditional", 1, "sample_launches")):
        n_sys = n_sys if n_sys in coarse else 4
        at = coarse[n_sys][part]
        lines.append({
            "name": name, "route": "cuda",
            "source": "deconv3d_tpu_torch/csrc/banded.cu",
            "replaces": "deconv3d_tpu/ops/banded.py:77-192 "
                        "(lax.scan, no Pallas)",
            "launches": field["mh"][launches],
            "launches_path": "full_field (mh, the default flow's coarse pass)",
            "shape": [n_sys, 3681, 11],
            "max_abs_err": at["max_abs_err"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], **bound(at["bound"]),
            "library_ms": at["library_ms"],
            "library_is": "torch.linalg.cholesky on the dense matrices"
                          if part == "cholesky" else
                          "torch.linalg.solve_triangular on the dense "
                          "factor, forward then backward",
            "n_systems_324": other_shape(coarse[324][part]),
            "n_systems_1": other_shape(coarse[1][part]),
            "call_ms": at["call_ms"], "ms_is": device_ms_is,
            "latency_steps_before": 2 * 3681 if part == "sample" else 3681,
        })
    # positivity: the same sources with the flag compiled in, on the
    # positivity Runs (resident: one chain; classic K1: two chains)
    for sampler in ("mh", "gibbs"):
        pos = positivity[sampler]
        lines.append({
            "name": f"resident_{sampler}_kernel<positivity>",
            "route": "cuda",
            "source": "deconv3d_tpu_torch/csrc/resident_sweep.cu",
            "replaces": k1 + (gibbs_lines if sampler == "gibbs" else "")
                        + " with the JAX package's positivity (jnp engine, "
                          "deconv3d_tpu/sampler.py:952-959, :1069-1086)",
            "launches": pos["path"]["launches"],
            "launches_path": f"positivity (Run {sampler}, 400 sweeps)",
            "shape": pos["path"]["shape"], "n_chains": 1,
            "max_abs_err": pos["max_abs_err"], "ms": pos["ms"],
            "plain_ms": pos["plain_ms"], **bound(pos["path"]["bound"]),
            "library_ms": None, "ms_flag_off_same_run": pos["ms_flag_off"],
        })
        lines.append({
            "name": f"{sampler}_sweep<positivity>",
            "route": "cuda",
            "source": f"deconv3d_tpu_torch/csrc/{sampler}_sweep.cu",
            "replaces": k1 + (gibbs_lines if sampler == "gibbs" else "")
                        + " with positivity",
            "launches": pos["chains"]["launches"],
            "launches_path": f"positivity (Run {sampler}, 2 chains, "
                             "64 sweeps)",
            "shape": pos["chains"]["shape"], "n_chains": 2,
            "ms": pos["chains"]["ms"], **bound(pos["chains"]["bound"]),
            "max_abs_err": pos["classic_2_chains"]["max_abs_err"],
            "plain_ms": pos["classic_2_chains"]["plain_ms"],
            "max_abs_err_and_plain_ms_at": "2 chains, 600x30x30, 4 sweeps "
                                           "in",
            "n_chains_1_600x30x30": {
                "max_abs_err": pos["classic_max_abs_err"],
                "ms": pos["classic_ms"],
                "ms_flag_off_same_turns": pos["classic_ms_flag_off"],
                "plain_ms": pos["plain_ms"]},
            "ms_flag_off_same_turns": pos["chains"]["ms_flag_off"],
            "library_ms": None,
        })
    # K2 with positivity, on the positivity phase's comparison shapes
    for sampler in ("mh", "gibbs"):
        tp = positivity[sampler]["tiled"]
        lines.append({
            "name": f"tiled_{sampler}<positivity>",
            "route": "cuda",
            "source": "deconv3d_tpu_torch/csrc/tiled_sweep.cu",
            "replaces": "deconv3d_tpu/ops/pallas_tiled.py:154"
                        f" (mode {sampler}, {modes[sampler]}) with the JAX "
                        "package's positivity",
            "launches": tp["launches"],
            "launches_path": "positivity (tiled_segment, timed sweeps)",
            "shape": tp["shape"], "tile": tp["tile"], "n_chains": 1,
            "max_abs_err": tp["max_abs_err"], "ms": tp["ms"],
            "ms_flag_off_same_turns": tp["ms_flag_off"],
            "plain_ms": tp["plain_ms"], **bound(tp["bound"]),
            "library_ms": None,
        })
    # gibbs_block: the banded kernels at its shapes (L = 600)
    lines.append({
        "name": "banded_cholesky<gibbs_block>", "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/banded.cu",
        "replaces": "deconv3d_tpu/ops/banded.py:77-117 (lax.scan, no "
                    "Pallas; deconv3d_tpu/sampler.py:696-705)",
        "launches": block["path"]["cholesky_launches"],
        "launches_path": "gibbs_block (Run, make_problem)",
        "shape": [1156, 600, 11],
        "max_abs_err": block[1156]["cholesky"]["max_abs_err"],
        "ms": block[1156]["cholesky"]["ms"],
        "plain_ms": block[1156]["cholesky"]["plain_ms"],
        **bound(block[1156]["cholesky"]["bound"]),
        "library_ms": block[1156]["cholesky"]["library_ms"],
        "library_is": "torch.linalg.cholesky on the dense matrices",
        "call_ms": block[1156]["cholesky"]["call_ms"], "ms_is": device_ms_is,
    })
    lines.append({
        "name": "banded_sample_conditional<gibbs_block>", "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/banded.cu",
        "replaces": "deconv3d_tpu/ops/banded.py:184-192 (lax.scan, no "
                    "Pallas; deconv3d_tpu/sampler.py:1119-1185)",
        "launches": block["path"]["draw_launches"],
        "launches_path": "gibbs_block (Run, 100 sweeps, one per color)",
        "shape": [4, 600, 11],
        "max_abs_err": block[4]["sample"]["max_abs_err"],
        "ms": block[4]["sample"]["ms"], "plain_ms": block[4]["sample"]["plain_ms"],
        **bound(block[4]["sample"]["bound"]),
        "library_ms": block[4]["sample"]["library_ms"],
        "library_is": "torch.linalg.solve_triangular on the dense factor, "
                      "forward then backward",
        "call_ms": block[4]["sample"]["call_ms"], "ms_is": device_ms_is,
        "latency_steps_before": 2 * 600,
        "sweep_profile": block["path"]["profile"],
        "n_systems_128": {**other_shape(block[128]["sample"]),
                          "launches": block["chains"]["draw_launches"],
                          "launches_path": "gibbs_block (Run, 32 chains, "
                                           "16 sweeps)"},
    })
    # the direct sampler's preconditioner solves: launches on the slice's
    # main path (Run(sampler='direct') on the bench cube), the rest at its
    # shape (dense mode, 480 frequencies); the other shapes beside it
    d600 = direct["dense_600"]
    lines.append({
        "name": "banded_solve", "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/banded.cu",
        "replaces": "deconv3d_tpu/ops/banded.py:120-181 (lax.scan, no "
                    "Pallas; the preconditioner's solves, "
                    "deconv3d_tpu/ops/direct.py:397-400, :548-549)",
        "launches": direct["path"]["launches"],
        "launches_path": "direct (Run(sampler='direct'), bench cube, "
                         f"{direct['path']['draws']} draws)",
        "shape": d600["shape"], "factors": d600["factors"],
        "mode": d600["mode"],
        "max_abs_err": d600["max_abs_err"], "ms": d600["ms"],
        "plain_ms": d600["plain_ms"], **bound(d600["bound"]),
        "library_ms": d600["library_ms"],
        "call_ms": d600["call_ms"], "ms_is": device_ms_is,
        "split_columns_segments": d600["split"],
        "library_is": "torch.cholesky_solve on the dense factors",
        "dense_3681x3720": other_shape(direct["dense_3681"]),
        "radial_3681x90600": {
            **other_shape(direct["field"]["radial_3681"]),
            "library_ms": direct["field"]["radial_3681"]["library_ms"],
            "library_is": direct["field"]["radial_3681"]["library_is"],
            "launches": direct["field"]["solve_launches"],
            "launches_path": "direct full field (1 map_estimate, 2 draws)"},
        "sharded_launches": direct_sharded["path"]["launches"],
        "multihost_launches_per_rank": [
            r["direct"]["solve_launches"] for r in multihost["ranks"]],
        "multihost_call_ms_per_rank": [
            r["direct"]["solve_call_ms"] for r in multihost["ranks"]],
        "multihost_call_ms_shape": multihost["ranks"][0]["direct"][
            "solve_shape"],
        "multihost_launches_path": "multihost (d), Run(sampler='direct', "
                                   "spatial_mesh=global_mesh()), bench cube, "
                                   f"{MULTIHOST_DRAWS} draws, 2 ranks on "
                                   "cuda:0: one launch per rank and "
                                   "preconditioner application",
        "sharded_launches_path": "direct_sharded (Run(sampler='direct', "
                                 "spatial_mesh=Mesh([cuda:0] * 2)), bench "
                                 f"cube, {direct_sharded['path']['draws']} "
                                 "draws: one launch per slot and "
                                 "preconditioner application)",
        # at the bench both slots hold 8 of the 16 kx: every launch of the
        # path ran at 600 × 480; at the full field each slot's shape ran
        # once per preconditioner application, half the path's launches
        # (the phase checks 2 × applications)
        "shard_600x480": {
            **other_shape(direct_sharded["shard_solve"]),
            "launches": direct_sharded["path"]["launches"],
            "launches_path": "direct_sharded (the 20 draws): both slots, "
                             "480 columns each (timed: slot 0's)",
            "factors_referenced":
                direct_sharded["shard_solve"]["factors_referenced"],
            "library_ms": direct_sharded["shard_solve"]["library_ms"],
            "mode": direct_sharded["shard_solve"]["mode"]},
        **{f"shard_3681x{n}": {
            **other_shape(at),
            "launches": direct_sharded["field"]["solve_launches"] // 2,
            "launches_path": "direct_sharded field (1 map_estimate on "
                             "Mesh([cuda:0] * 2)): this slot's",
            "factors_referenced": at["factors_referenced"]}
           for n, at in direct_sharded["field"]["shard_solves"].items()},
    })
    # the Cholesky at the direct preconditioner's shapes: launches on the
    # direct Run (bench, dense: 480 factors) and the full field's (radial,
    # 256); numbers on the bands those builds factor
    chol = direct["dense_600"]["cholesky"]
    chol_field = direct["field"]["radial_3681"]["cholesky"]
    lines.append({
        "name": "banded_cholesky<direct>", "route": "cuda",
        "source": "deconv3d_tpu_torch/csrc/banded.cu",
        "replaces": "deconv3d_tpu/ops/banded.py:77-117 (lax.scan, no "
                    "Pallas; the preconditioner's factors, "
                    "deconv3d_tpu/ops/direct.py)",
        "launches": direct["path"]["cholesky_launches"],
        "launches_path": "direct (Run(sampler='direct'), bench cube: one "
                         "preconditioner build)",
        "shape": [480, 600, 11],
        "max_abs_err": chol["max_abs_err"], "ms": chol["ms"],
        "plain_ms": chol["plain_ms"], **bound(chol["bound"]),
        "library_ms": chol["library_ms"],
        "library_is": "torch.linalg.cholesky on the dense matrices",
        "call_ms": chol["call_ms"], "ms_is": device_ms_is,
        "radial_256x3681": {
            **other_shape(chol_field),
            "library_ms": chol_field["library_ms"],
            "library_is": chol_field["library_is"],
            "launches": direct["field"]["cholesky_launches"],
            "launches_path": "direct full field (1 map_estimate, 2 draws)"},
    })
    check(all(line["launches"] > 0 for line in lines),
          "a kernel was launched no time on its path")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


#: the phases that ``--phase NAME ...`` runs alone after the build, to
#: iterate on one without the whole smoke (no ``kernels`` or ``ok`` line)
ALONE = {"statistics": phase_statistics, "examples": phase_examples,
         "checkpoint": phase_checkpoint,
         "direct_field": lambda: phase_direct_field(field_cube())}


def phases_alone(names) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    emit("device", name=torch.cuda.get_device_name(0))
    _build.load_library()
    emit("build", seconds=_build.build_seconds)
    for name in names:
        ALONE[name]()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(phases_alone(sys.argv[2:]))
    if sys.argv[1:2] == ["--multihost"]:
        role, rank, world, backend, tmp = sys.argv[2:7]
        sys.exit(multihost_worker(role, int(rank), int(world), backend, tmp))
    sys.exit(main())
