"""``Run`` — the reference-compatible user facade, on torch.

Counterpart of ``deconv3d_tpu/run.py`` for the single-device path:

    from deconv3d_tpu_torch import Run, MUSE
    run = Run('cube.fits', MUSE(), max_iterations=10_000)
    run.run()
    run.save('my_deconv')

``max_iterations`` counts full sweeps (all spaxels), not single spaxel
visits.  The run lives on ``device`` (default ``'cuda'``: without a card
``Run`` raises, and ``device='cpu'`` runs the plain torch versions on the
CPU); on a CUDA device every sweep goes through a
hand-written kernel of ``sampler`` (``'mh'`` or ``'gibbs'``, with or
without ``positivity``), one launch per sweep for all ``n_chains`` chains
(``'gibbs_block'``: one launch of the banded draw kernel per color;
``'direct'``: independent exact draws by PCG, ``ops/direct.py``, whose
preconditioner solves launch the banded solve kernel): the
whole-cube kernel, or on a field whose residual and weights exceed the
1 GiB window budget
(``ops/tiled.py::WINDOW_BUDGET_BYTES``; a full MUSE field) the tiled one
(``engine``, ``tile``: ``sampler.resolve_engine``; the resolved engine is
``config.engine`` and in ``diagnostics()``).  As in the JAX package, MH on
a large blurred field interleaves global coarse pattern passes
(``coarse_every=8``; ``coarse_every=0`` turns them off).  ``run_until``
samples until R̂ / ESS targets hold, ``resume`` restarts from a checkpoint
bit-exactly, ``map_estimate`` solves for the MAP on any run.

Meshes (``parallel.Mesh``: device slots, each owned by one process):
``mesh`` splits the chains over its ``'chains'`` slots; ``spatial_mesh`` (a Mesh, or an int k: the first k
CUDA devices, ``parallel.make_mesh``, or k slots of the CPU for a CPU run)
shards ONE chain's sweep along Y — ``'mh'``/``'gibbs'`` on the band
launches of the tiled kernel (``parallel/kernel_sharded.py``),
``'direct'`` and ``map_estimate`` as a Y-sharded PCG
(``parallel/direct_sharded.py``), the other modes on the plain color step
(``parallel/sweep_sharded.py``); with ``n_chains > 1`` it is a 2-D
``(chains, spatial)`` mesh, one chain per row.
Several shards on one card: ``spatial_mesh=Mesh([torch.device('cuda:0')] *
2)``.  Several processes: ``parallel.initialize()`` then
``spatial_mesh=parallel.global_mesh()`` (or ``mesh=global_mesh('chains')``,
or a 2-D mesh of its slots) in every rank; every rank runs its own slots
and holds the whole state and traces after each segment, so
``diagnostics()`` is the same on every rank (write files from one).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from . import chains as ch
from . import checkpoint as ckpt
from . import convolve as cv
from . import metrics
from . import sampler as sm
from .cube import Cube, torch_dtype
from .instruments import Instrument, MUSE
from .metrics import MetricsWriter, logger


class Run:
    """One deconvolution run: cube + instrument + sampler configuration."""

    def __init__(
        self,
        cube,
        instrument: Optional[Instrument] = None,
        variance=None,
        mask=None,
        max_iterations: int = 1000,
        burn_in: Optional[int] = None,
        keep_one_in: int = 1,
        jump_amplitude: Optional[float] = None,
        target_acceptance: float = 0.234,
        min_acceptance_rate: float = 0.01,
        positivity: bool = False,
        sampler: str = "mh",
        initial: str = "zeros",
        seed: int = 0,
        fsf_size: Optional[int] = None,
        lsf_width: Optional[int] = None,
        n_chains: int = 1,
        mesh=None,
        spatial_mesh=None,
        segment_size: Optional[int] = None,
        metrics_path: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        dtype=np.float32,
        engine: str = "auto",
        fsf_tol: float = 1e-5,
        track_variance: bool = True,
        coarse_every: Optional[int] = None,
        coarse_mode: str = "global",
        tile: Optional[tuple] = None,
        chi2_rebaseline_every: Optional[int] = None,
        direct_tol: float = 1e-6,
        direct_maxiter: int = 500,
        direct_precond: str = "banded",
        direct_radial_bins: int = 256,
        direct_precond_scale: bool = False,
        direct_spatial: str = "auto",
        prior_precision: "float | str" = 0.0,
        device=None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Run runs on a CUDA device unless told otherwise, and "
                    "none is available: pass device='cpu' to run the plain "
                    "torch versions on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if isinstance(cube, str):
            cube = Cube.from_file(cube, device=self.device)
        cube = cube.to(self.device)
        if variance is not None or mask is not None:
            if variance is not None:
                variance = torch.as_tensor(
                    np.asarray(variance) if not isinstance(variance, torch.Tensor)
                    else variance
                ).to(self.device, torch_dtype(dtype))
                try:
                    variance = torch.broadcast_to(variance, cube.shape).clone()
                except RuntimeError:
                    raise ValueError(
                        f"variance shape {tuple(variance.shape)} is not "
                        f"broadcastable to data shape {cube.shape}"
                    ) from None
            cube = dataclasses.replace(
                cube,
                variance=cube.variance if variance is None else variance,
                mask=cube.mask if mask is None
                else torch.as_tensor(np.asarray(mask), dtype=torch.bool,
                                     device=self.device),
            )
        self.cube = cube
        self.instrument = instrument or MUSE()
        self.n_chains = int(n_chains)
        self.mesh = mesh
        self._route_spatial(spatial_mesh, sampler, positivity, engine)
        self.min_acceptance_rate = min_acceptance_rate
        self.segment_size = segment_size
        self.metrics_path = metrics_path
        self.checkpoint_path = checkpoint_path

        self.config = sm.RunConfig(
            max_iterations=max_iterations,
            burn_in=burn_in,
            keep_one_in=keep_one_in,
            jump_scale=jump_amplitude,
            target_acceptance=target_acceptance,
            positivity=positivity,
            sampler=sampler,
            initial=initial,
            fsf_size=fsf_size,
            lsf_width=lsf_width,
            seed=seed,
            dtype=dtype,
            engine=engine,
            fsf_tol=fsf_tol,
            track_variance=track_variance,
            coarse_every=coarse_every,
            coarse_mode=coarse_mode,
            tile=None if tile is None else tuple(tile),
            chi2_rebaseline_every=chi2_rebaseline_every,
            direct_tol=direct_tol,
            direct_maxiter=direct_maxiter,
            direct_precond=direct_precond,
            direct_radial_bins=direct_radial_bins,
            direct_precond_scale=direct_precond_scale,
            direct_spatial=direct_spatial,
            prior_precision=prior_precision,
        )
        self.problem = sm.make_problem(cube, self.instrument, self.config,
                                       device=self.device)
        self.config = self.problem.config
        # Auto coarse passes, the JAX package's rule: interleaved global
        # pattern passes only where they were measured a wall-clock ESS/s
        # win, MH on large blurred fields; a blur-dominated small field
        # gets a warning instead (the passes measured a loss there).
        from .ops.coarse import auto_coarse_every

        auto_every = (
            auto_coarse_every(self.problem) if coarse_every is None else None
        )
        if auto_every:
            self._set_config(coarse_every=auto_every, coarse_mode="global")
            logger.info(
                "large blurred field (%dx%d spaxels, footprint %d px): "
                "enabling global coarse-pattern passes (coarse_every=%d), "
                "where the JAX package measured them as a wall-clock ESS/s "
                "win.  Pass coarse_every=0 to disable.",
                self.problem.Y, self.problem.X, self.problem.f, auto_every,
            )
        elif (
            coarse_every is None
            and sampler in ("mh", "gibbs")
            and self.problem.f >= max(9, min(self.problem.Y,
                                             self.problem.X) // 2)
        ):
            logger.warning(
                "FSF footprint (%d px) covers >= half the %dx%d field: "
                "single-site sweeps mix the blur-null modes too slowly for "
                "a posterior mean to localise sources in a fixed-length "
                "run.  Coarse passes are NOT auto-enabled at this size — "
                "the JAX package measured a wall-clock ESS/s loss there.  "
                "Use map_estimate() or sampler='direct' for point "
                "estimates, or coarse_every=8 with a long run if you need "
                "MCMC uncertainties here.",
                self.problem.f, self.problem.Y, self.problem.X,
            )
        if self.config.coarse_every == 0:
            # explicit opt-out: normalise to the interleaver's 'off' value
            self._set_config(coarse_every=None)
        self._states = None
        self._traces = {"chi2": [], "accept": [], "flux": [], "monitor": []}
        self._last_result: Optional[ch.MultiChainResult] = None
        #: the last map_estimate's PCGResult and resolved τ
        self.last_map_result = None
        self.last_map_prior_precision = None

    def _route_spatial(self, spatial_mesh, sampler, positivity,
                       engine) -> None:
        """``spatial_mesh`` and its route, with the JAX package's rules and
        errors (``deconv3d_tpu/run.py:106-170``)."""
        from .parallel import Mesh, make_mesh

        if isinstance(spatial_mesh, int):
            spatial_mesh = (make_mesh(spatial_mesh, "sp")
                            if self.device.type == "cuda"
                            else Mesh([self.device] * spatial_mesh, ("sp",)))
        self.spatial_mesh = spatial_mesh
        self._spatial_chains = False
        kernel_rate = sampler in ("mh", "gibbs") and not positivity
        if spatial_mesh is not None and self.n_chains != 1:
            names = tuple(getattr(spatial_mesh, "axis_names", ()))
            if not (len(names) == 2 and kernel_rate
                    and spatial_mesh.shape[names[0]] == self.n_chains):
                raise ValueError(
                    "n_chains>1 with spatial_mesh needs the chains × "
                    "spatial composition: a 2-D mesh (chains_axis, "
                    "spatial_axis) with shape[0] == n_chains, sampler "
                    "'mh'/'gibbs' and no positivity.  For plain chain "
                    "parallelism use `mesh` instead.")
            self._spatial_chains = True
        self._spatial_kernel = spatial_mesh is not None and kernel_rate
        # 'direct' shards its PCG (parallel/direct_sharded.py) and leaves
        # the engine alone, as the JAX package does
        if (spatial_mesh is not None and not kernel_rate
                and sampler != "direct" and engine != "auto"):
            logger.warning(
                "spatial_mesh with sampler=%r runs the plain color step on "
                "every shard; engine=%r is ignored (kernel-rate sharded "
                "sweeps exist for sampler='mh'/'gibbs' without positivity "
                "only)", sampler, engine)

    def _set_config(self, **changes) -> None:
        self.config = dataclasses.replace(self.config, **changes)
        self.problem = dataclasses.replace(self.problem, config=self.config)

    # -- execution -----------------------------------------------------------

    @property
    def states(self) -> sm.SamplerState:
        """Chain states (leading chain axis), allocated on first use: a
        solve-only use (``map_estimate``, the ``map`` command) builds none."""
        if self._states is None:
            self._states = ch.init_chain_states(self.problem, self.n_chains)
        return self._states

    @states.setter
    def states(self, value):
        self._states = value

    @property
    def sweeps_done(self) -> int:
        return int(self.states.sweep.reshape(-1)[0])

    def run(self, n_sweeps: Optional[int] = None) -> "Run":
        """Execute the MCMC in segments of ``segment_size`` sweeps.

        Span ``run.segment_end`` (``metrics``): from a segment's return to
        the next segment, or after the last to this method's return.  With
        ``metrics_path`` the spans are on during this call, and each
        segment's JSONL line carries them."""
        total = self.config.max_iterations if n_sweeps is None else n_sweeps
        seg = self.segment_size or max(1, min(total, 1000))
        writer = MetricsWriter(self.metrics_path)
        was_tracing = metrics.tracing(True) if self.metrics_path else None
        done = 0
        t_start = time.perf_counter()
        end = metrics.NULL
        try:
            while done < total:
                end.stop()
                n = min(seg, total - done)
                t0 = time.perf_counter()
                mc = self._run_segment(n)
                end = metrics.span("run.segment_end").start()
                self.states = mc.result.state
                # NaN guard: a non-finite chi² means diverged numerics and
                # would poison every later segment and the accumulators
                chi2_now = self.states.chi2.cpu().numpy()
                dt = time.perf_counter() - t0
                if not np.all(np.isfinite(chi2_now)):
                    raise FloatingPointError(
                        f"non-finite chi² after sweep {self.sweeps_done}: "
                        f"{chi2_now!r} — run diverged (check variance cube and "
                        "jump_amplitude); state left intact for inspection"
                    )
                done += n
                self._last_result = mc
                r = mc.result
                self._traces["chi2"].append(r.chi2_trace.cpu().numpy())
                self._traces["accept"].append(r.accept_trace.cpu().numpy())
                if self.config.sampler == "direct":
                    self._warn_unconverged(self._traces["accept"][-1])
                self._traces["flux"].append(r.flux_trace.cpu().numpy())
                self._traces["monitor"].append(r.monitor_trace.cpu().numpy())
                writer.write(
                    sweep=self.sweeps_done,
                    chi2=float(chi2_now.mean()),
                    acceptance=self.acceptance_rate,
                    sweeps_per_sec=round(n / dt, 2),
                    proposals_per_sec=round(
                        n * self.problem.n_valid * self.n_chains / dt, 1
                    ),
                )
                if self.checkpoint_path:
                    self._save_checkpoint()
            logger.info("run finished: %d sweeps in %.2fs", total,
                        time.perf_counter() - t_start)
            acc = self.acceptance_rate
            if acc < self.min_acceptance_rate:
                logger.warning(
                    "acceptance rate %.4f below min_acceptance_rate %.4f — "
                    "jump amplitude is likely mistuned", acc,
                    self.min_acceptance_rate,
                )
            self._warn_if_undermixed()
            end.stop()
        finally:
            writer.close()
            if was_tracing is not None:
                metrics.tracing(was_tracing)
        return self

    def _save_checkpoint(self) -> None:
        """The NPZ checkpoint after a segment.  A run whose mesh spans
        several ranks holds the whole state on every rank: the rank that
        owns the mesh's first slot writes it, and the others wait for it
        before the segment ends (every rank writing one path at once could
        leave a torn file)."""
        from .parallel import mesh as pm

        mesh = self.spatial_mesh if self.spatial_mesh is not None else self.mesh
        ranks = [] if mesh is None else mesh.ranks.reshape(-1).tolist()
        if not ranks or ranks[0] == pm.process_rank():
            ckpt.save_state(self.checkpoint_path, self.states,
                            meta={"sweeps_done": self.sweeps_done})
        if len(set(ranks)) > 1:
            pm.barrier(mesh.devices.reshape(-1).tolist(), ranks)

    def _run_segment(self, n: int) -> ch.MultiChainResult:
        """``n`` sweeps of every chain on the run's route: chains ×
        spatial, one chain sharded (band launches, the plain color step,
        or for ``'direct'`` the sharded PCG), or the chains on their own
        (split over ``mesh``)."""
        if self._spatial_chains:
            from .parallel.kernel_sharded import run_chains_kernel_sharded

            names = tuple(self.spatial_mesh.axis_names)
            return run_chains_kernel_sharded(
                self.problem, self.n_chains, n, self.spatial_mesh,
                states=self.states, chain_axis=names[0], axis_name=names[1])
        if self.spatial_mesh is not None and self.config.sampler == "direct":
            from .parallel.direct_sharded import run_direct_sweeps_sharded

            return ch.MultiChainResult(result=run_direct_sweeps_sharded(
                self.problem, self.states, n, self.spatial_mesh))
        if self.spatial_mesh is not None:
            if self._spatial_kernel:
                from .parallel.kernel_sharded import (
                    run_sweeps_kernel_sharded as sharded)
            else:
                from .parallel.sweep_sharded import (
                    run_sweeps_sharded as sharded)
            return ch.MultiChainResult(result=sharded(
                self.problem, self.states, n, self.spatial_mesh,
                axis_name=self.spatial_mesh.axis_names[0]))
        return ch.run_chains(self.problem, self.n_chains, n_sweeps=n,
                             mesh=self.mesh, states=self.states)

    def _warn_unconverged(self, flags: np.ndarray) -> None:
        """For ``sampler='direct'`` the accept trace carries each draw's
        convergence flag: unconverged draws bias the accumulators, so a
        segment that has any says so, with a ridge hint on a flat prior."""
        n_bad = int(np.sum(flags < 1.0))
        if not n_bad:
            return
        hint = ""
        if not self.config.prior_precision:
            from .ops.direct import suggest_prior_precision

            hint = (
                "; if the flat-prior posterior is near-improper under this "
                "blur, a weak ridge restores convergence: prior_precision="
                f"{suggest_prior_precision(self.problem):.2e} (or 'auto' — "
                "see ops/direct.suggest_prior_precision)")
        logger.warning(
            "%d/%d direct draws in this segment did NOT reach direct_tol "
            "within direct_maxiter=%d iterations — their error biases the "
            "posterior accumulators; raise direct_maxiter or loosen "
            "direct_tol%s", n_bad, flags.size, self.config.direct_maxiter,
            hint)

    def _warn_if_undermixed(self) -> None:
        """Warn when the post-burn-in monitor-voxel ESS is ≪ the sample
        count: a chain can equilibrate in χ² while its voxels barely
        decorrelate, and the posterior mean of such a run has not averaged
        over the blur-null modes.  Needs ≥ 100 post-burn-in sweeps; iid
        direct draws skip it (every draw is one full ESS unit)."""
        if self.config.sampler == "direct":
            return
        burn = self.config.resolved_burn_in()
        try:
            mon = self.trace("monitor")          # [C, n, K]
        except ValueError:
            return
        n = mon.shape[1]
        start = burn - (self.sweeps_done - n)    # trace-local burn index
        window = n - max(start, 0)
        if window < 100:
            return  # too short for the ESS estimate to mean anything
        seg = mon[:, max(start, 0):, :]
        ess = [
            ch.effective_sample_size(seg[:, :, k])
            for k in range(seg.shape[-1])
        ]
        ess = [e for e in ess if np.isfinite(e)]
        if not ess:
            return
        ess_mean = float(np.mean(ess))
        if ess_mean < max(10.0, 0.01 * window):
            hints = []
            if not self.config.coarse_every:
                hints.append("coarse_every=8 (global pattern passes)")
            if self.config.sampler == "mh":
                hints.append("sampler='gibbs' or 'gibbs_block'")
            hints.append("sampler='direct' (independent exact draws)")
            hints.append("map_estimate() for a deterministic point estimate")
            logger.warning(
                "post-burn-in monitor-voxel ESS is %.1f over %d kept "
                "sweeps (%.1f%%): the chain is equilibrated in chi² but "
                "the per-voxel posterior has NOT decorrelated — the "
                "posterior mean may not localise sources.  Consider: %s.",
                ess_mean, window, 100.0 * ess_mean / window,
                "; ".join(hints),
            )

    def run_until(
        self,
        rhat: Optional[float] = 1.01,
        min_ess: Optional[float] = None,
        check_every: Optional[int] = None,
        max_sweeps: Optional[int] = None,
    ) -> dict:
        """Run until the convergence diagnostics meet their targets.

        Samples in segments and stops when every given criterion holds:

          * ``rhat`` — split-R̂ of the chi² trace AND of every monitor voxel
            ≤ this value (needs ``n_chains >= 2``).
          * ``min_ess`` — pooled effective sample size of the chi² trace
            ≥ this value (works for any chain count).

        ``check_every`` sweeps run between checks (default: a heuristic
        segment ≤ 256); the first segment covers burn-in plus one check
        window, since pre-burn-in samples carry no diagnostic signal.
        ``max_sweeps`` (default ``max_iterations``) bounds the total;
        hitting it returns ``converged=False`` with a warning, the state
        and traces usable.  Returns the final diagnostics (``converged``,
        ``sweeps``, ``window``, ``ess_chi2``, and ``rhat_max`` with two or
        more chains).
        """
        if self.n_chains < 2:
            if min_ess is None:
                raise ValueError(
                    "run_until with a single chain has no R̂ signal — pass "
                    "min_ess=... (or run n_chains >= 2 for R̂-based stopping)"
                )
            rhat = None
        if rhat is None and min_ess is None:
            raise ValueError("run_until needs at least one criterion")
        burn = self.config.resolved_burn_in()
        max_sweeps = max_sweeps or self.config.max_iterations
        check_every = check_every or max(32, min(256, max_sweeps // 8))
        first = max(check_every, burn - self.sweeps_done + check_every)
        self.run(min(first, max(max_sweeps - self.sweeps_done, 1)))
        while True:
            d = self._convergence_criteria(burn)
            ok = True
            if rhat is not None:
                ok = ok and d["rhat_max"] <= rhat
            if min_ess is not None:
                ok = ok and d["ess_chi2"] >= min_ess
            d["converged"] = bool(ok)
            if ok:
                logger.info("run_until converged at sweep %d: %s",
                            d["sweeps"], d)
                return d
            remaining = max_sweeps - self.sweeps_done
            if remaining <= 0:
                logger.warning(
                    "run_until hit max_sweeps=%d without converging: %s — "
                    "raise max_sweeps or loosen the criteria; if the FSF "
                    "blur is heavy, sampler='gibbs_block' and/or "
                    "coarse_every=8 attack exactly the slow-mixing modes",
                    max_sweeps, d,
                )
                return d
            self.run(min(check_every, remaining))

    def _convergence_criteria(self, burn: int) -> dict:
        """R̂ / ESS over the diagnostic window: the last half of the trace,
        never earlier than burn-in (the Stan convention), so a χ² transient
        that outlasts a fixed burn-in leaves the window as the run grows.
        The trace is process-local (shorter than ``sweeps_done`` after a
        resume), so the absolute burn-in is rebased to trace coordinates.
        A window too short for split-R̂ reads as not converged (inf)."""
        chi2_t = self.trace("chi2")                     # [n_chains, n]
        n = chi2_t.shape[1]
        burn_local = burn - (self.sweeps_done - n)
        start = int(np.clip(max(burn_local, n // 2), 0, max(n - 2, 0)))
        seg = chi2_t[:, start:]
        out = {
            "sweeps": self.sweeps_done,
            "window": [start, n],
            "ess_chi2": float(ch.effective_sample_size(seg)),
        }
        if self.n_chains >= 2:
            rhat_chi2 = ch.gelman_rubin(seg)
            mon = self.trace("monitor")[:, start:, :]
            rhat_mon = [
                ch.gelman_rubin(mon[:, :, k]) for k in range(mon.shape[-1])
            ]
            # gelman_rubin is NaN only for a window of < 2 samples per
            # split half (zero-variance traces map to 1.0 / inf): no signal
            # must read as not converged, never as the ideal 1.0
            rhats = [rhat_chi2, *rhat_mon]
            finite = [r for r in rhats if not np.isnan(r)]
            out["rhat_chi2"] = float(rhat_chi2)
            out["rhat_monitor_max"] = (
                float(np.max([r for r in rhat_mon if not np.isnan(r)]))
                if any(not np.isnan(r) for r in rhat_mon)
                else float("inf")
            ) if mon.shape[-1] else 1.0
            out["rhat_max"] = (
                float(np.max(finite)) if len(finite) == len(rhats)
                else float("inf")
            )
        return out

    def resume(self, path: Optional[str] = None) -> "Run":
        """Load a checkpoint written by this configuration (bit-exact: the
        state holds every chain's Philox key and absolute sweep): an NPZ
        of ``checkpoint_path``, a ``checkpoint.save_state_dcp`` directory,
        or the NPZ of a JAX package ``Run`` of the same cube, settings and
        ``n_chains`` (``checkpoint.load_state``).  A JAX run's χ² is on its
        own weights — exact ones on its ``jnp`` engine, where the port
        samples on bf16-valued weights — so it is rebaselined on this
        run's problem (``sampler.rebaseline_chi2``, Kahan term 0); the
        chains continue from the JAX state on the port's Philox draws."""
        path = path or self.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path given")
        fmt = ckpt.checkpoint_format(path)
        states, meta = ckpt.load_state(path, self.states)
        if fmt == "jax":
            states = sm.rebaseline_chi2(self.problem, states)
        self.states = states
        logger.info("resumed at sweep %d (%s checkpoint)", self.sweeps_done,
                    fmt)
        return self

    def map_estimate(self, tol: Optional[float] = None,
                     maxiter: Optional[int] = None,
                     prior_precision: "float | str | None" = None) -> Cube:
        """MAP (= posterior mean of the linear-Gaussian model) by PCG.

        Deterministic and sampler-independent: solves A c = Kᵀ W d with the
        preconditioned CG of the direct sampler
        (``ops.direct.posterior_mean``) on this run's problem — no chains,
        no burn-in.  ``tol`` / ``maxiter`` default to ``direct_tol`` /
        ``direct_maxiter``.  ``prior_precision`` τ > 0 adds the ridge prior
        c ~ N(0, τ⁻¹I) for this solve only (``'auto'``: 1e-4 of the mean
        weight, ``ops.direct.suggest_prior_precision``): under heavy blur
        the flat-prior operator is near-singular and CG stalls.  The
        solve's iterations and relative residual are kept in
        ``last_map_result``, the τ it used in
        ``last_map_prior_precision``; a solve that stops short of ``tol``
        warns.  With ``spatial_mesh`` the solve shards over the mesh's last
        axis (``parallel/direct_sharded.py::posterior_mean_sharded``).
        """
        if self.config.positivity:
            # the unconstrained Gaussian optimum is not the MAP of the
            # truncated model
            raise ValueError(
                "map_estimate() solves the unconstrained Gaussian model; "
                "with positivity=True its optimum (negative voxels "
                "included) is not the constrained model's MAP. Use the "
                "MCMC posterior mean (deconvolved_cube) instead."
            )
        from .ops.direct import posterior_mean, suggest_prior_precision

        if prior_precision == "auto":
            prior_precision = suggest_prior_precision(self.problem)
            logger.info("map_estimate prior_precision='auto' -> %.3e",
                        prior_precision)
        self.last_map_prior_precision = (
            prior_precision if prior_precision is not None
            else self.config.prior_precision)
        if self.spatial_mesh is not None:
            from .parallel.direct_sharded import posterior_mean_sharded

            # on a 2-D (chains, spatial) mesh the one solve shards over
            # the spatial axis only
            res = posterior_mean_sharded(
                self.problem, self.spatial_mesh,
                axis_name=self.spatial_mesh.axis_names[-1], tol=tol,
                maxiter=maxiter, prior_precision=prior_precision)
        else:
            res = posterior_mean(self.problem, tol=tol, maxiter=maxiter,
                                 prior_precision=prior_precision)
        self.last_map_result = res
        if res.rel_residual > (tol if tol is not None
                               else self.config.direct_tol):
            logger.warning(
                "map_estimate did not converge: rel_residual %.2e after "
                "%d iterations — raise maxiter or loosen tol",
                res.rel_residual, res.iterations)
        return Cube.from_data(
            res.x, crval=self.cube.crval, cdelt=self.cube.cdelt,
            crpix=self.cube.crpix, dtype=self.config.dtype,
            header=self.cube.header)

    # -- results -------------------------------------------------------------

    def trace(self, name: str) -> np.ndarray:
        """Concatenated per-sweep trace [n_chains, sweeps_done(, k)]."""
        parts = self._traces[name]
        if not parts:
            raise ValueError("run() has not been called")
        return np.concatenate(parts, axis=1)

    @property
    def chi2(self) -> float:
        return float(self.states.chi2.mean())

    @property
    def acceptance_rate(self) -> float:
        acc = float(self.states.n_accept.sum())
        nprop = float(self.states.n_propose.sum())
        return acc / max(nprop, 1.0)

    def deconvolved_cube(self) -> Cube:
        """Posterior-mean clean cube (pooled over chains)."""
        p, s = self.problem, self.states
        n = max(float(s.n_kept.sum()), 1.0)
        mean = (s.sum_clean.sum(dim=0) / n)[:, : p.Y, : p.X]
        std = self._posterior_std()
        return Cube.from_data(
            mean, variance=None if std is None else std**2,
            crval=self.cube.crval, cdelt=self.cube.cdelt,
            crpix=self.cube.crpix, dtype=self.config.dtype,
            header=self.cube.header,
        )

    def _posterior_std(self) -> Optional[torch.Tensor]:
        if not self.config.track_variance:
            return None
        p, s = self.problem, self.states
        n = max(float(s.n_kept.sum()), 1.0)
        mean = s.sum_clean.sum(dim=0) / n
        var = torch.clamp(s.sum_sq.sum(dim=0) / n - mean**2, min=0.0)
        return torch.sqrt(var)[:, : p.Y, : p.X]

    def convolved_cube(self) -> Cube:
        """Forward model of the posterior mean (the fitted 'observed' cube)."""
        mean = self.deconvolved_cube()
        out = cv.convolve_cube(mean.data, self.problem.fsf, self.problem.lsf)
        return dataclasses.replace(mean, data=out, variance=None)

    def rhat_cube(self) -> np.ndarray:
        """Dense per-voxel R̂ [L, Y, X] (needs n_chains >= 2 post-burn-in)."""
        mc = ch.MultiChainResult(result=sm.ChainResult(
            state=self.states, chi2_trace=None, accept_trace=None,
            flux_trace=None, monitor_trace=None,
        ))
        return mc.rhat_cube(self.problem)

    def diagnostics(self) -> dict:
        """Summary plus R̂/ESS over post-burn-in traces (multi-chain)."""
        out = {
            "chi2": self.chi2,
            "acceptance_rate": self.acceptance_rate,
            "sweeps": self.sweeps_done,
            "n_chains": self.n_chains,
            "engine": self.config.engine,
        }
        if self.n_chains >= 2 and self._traces["chi2"]:
            burn = self.config.resolved_burn_in()
            chi2_t = self.trace("chi2")
            start = min(burn, chi2_t.shape[1] - 2)
            out["rhat_chi2"] = ch.gelman_rubin(chi2_t[:, start:])
            out["ess_chi2"] = ch.effective_sample_size(chi2_t[:, start:])
            mon = self.trace("monitor")[:, start:, :]
            rhats = [
                ch.gelman_rubin(mon[:, :, k]) for k in range(mon.shape[-1])
            ]
            rhats = [r for r in rhats if np.isfinite(r)]
            if rhats:
                out["rhat_monitor_max"] = float(np.max(rhats))
        return out

    # -- persistence ---------------------------------------------------------

    def save(self, name: str, plots: bool = False) -> None:
        """Write FITS products + chain statistics (+ optional PNG plots).

        Products:  {name}_clean.fits      posterior-mean deconvolved cube
                   {name}_std.fits        posterior std cube
                   {name}_convolved.fits  forward model of the mean
                   {name}_traces.npz      chi²/acceptance/flux traces
                   {name}_stats.json      summary + convergence diagnostics
        ``plots=True`` adds PNG plots when matplotlib imports.
        """
        self.deconvolved_cube().to_fits(f"{name}_clean.fits")
        std = self._posterior_std()
        if std is not None:
            Cube.from_data(
                std, crval=self.cube.crval, cdelt=self.cube.cdelt,
                crpix=self.cube.crpix, header=self.cube.header,
            ).to_fits(f"{name}_std.fits")
        self.convolved_cube().to_fits(f"{name}_convolved.fits")
        if self._traces["chi2"]:
            np.savez(
                f"{name}_traces.npz",
                chi2=self.trace("chi2"),
                acceptance=self.trace("accept"),
                flux=self.trace("flux"),
                monitor=self.trace("monitor"),
            )
        with open(f"{name}_stats.json", "w") as fh:
            json.dump(self.diagnostics(), fh, indent=2, default=float)
        if plots:
            try:
                import matplotlib
            except ImportError:
                logger.warning("plots=True but matplotlib is not installed")
                return
            matplotlib.use("Agg")
            self.plot_chi2(f"{name}_chi2.png")
            self.plot_chain(f"{name}_chain.png")
            self.plot_images(f"{name}_images.png")

    def plot_chi2(self, path: str) -> None:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for c, tr in enumerate(self.trace("chi2")):
            ax.plot(tr, lw=0.8, label=f"chain {c}" if c < 8 else None)
        ax.set_xlabel("sweep")
        ax.set_ylabel("chi²")
        ax.set_yscale("log")
        ax.legend(loc="upper right", fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)

    def plot_chain(self, path: str) -> None:
        """Total flux, acceptance rate and monitor-voxel traces per chain."""
        import matplotlib.pyplot as plt

        flux = self.trace("flux")
        accept = self.trace("accept")
        mon = self.trace("monitor")
        burn = self.config.resolved_burn_in()
        fig, axes = plt.subplots(
            3, 1, figsize=(8, 8), sharex=True,
            gridspec_kw={"height_ratios": [2, 1, 2]},
        )
        for c in range(flux.shape[0]):
            axes[0].plot(flux[c], lw=0.8, label=f"chain {c}" if c < 8 else None)
            axes[1].plot(accept[c], lw=0.8)
        for k in range(mon.shape[-1]):
            for c in range(mon.shape[0]):
                axes[2].plot(mon[c, :, k], lw=0.6, alpha=0.8)
        axes[0].set_ylabel("total flux")
        axes[1].set_ylabel("acceptance")
        axes[1].set_ylim(0, 1)
        axes[2].set_ylabel("monitor voxels")
        axes[2].set_xlabel("sweep")
        for ax in axes:
            if 0 < burn < flux.shape[1]:
                ax.axvline(burn, color="k", ls="--", lw=0.8, alpha=0.5)
        axes[0].legend(loc="upper right", fontsize=7)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)

    def plot_images(self, path: str) -> None:
        import matplotlib.pyplot as plt

        data_img = np.nansum(self.cube.data.cpu().numpy(), axis=0)
        clean_img = self.deconvolved_cube().data.cpu().numpy().sum(axis=0)
        conv_img = self.convolved_cube().data.cpu().numpy().sum(axis=0)
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, img, title in zip(
            axes, (data_img, clean_img, conv_img),
            ("data (Σλ)", "deconvolved (Σλ)", "model (Σλ)"),
        ):
            im = ax.imshow(img, origin="lower")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
