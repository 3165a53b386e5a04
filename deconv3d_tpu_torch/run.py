"""``Run`` — the reference-compatible user facade, on torch.

Counterpart of ``deconv3d_tpu/run.py`` for the single-device path:

    from deconv3d_tpu_torch import Run, MUSE
    run = Run('cube.fits', MUSE(), max_iterations=10_000)
    run.run()
    run.save('my_deconv')

``max_iterations`` counts full sweeps (all spaxels), not single spaxel
visits.  The run lives on ``device`` (default: the first CUDA device when
there is one, else the CPU); on a CUDA device every sweep goes through a
hand-written kernel of ``sampler`` (``'mh'`` or ``'gibbs'``), one launch
per sweep for all ``n_chains`` chains: the whole-cube kernel, or on a
field too large for the card's L2 (a full MUSE field) the tiled one
(``engine``, ``tile``: ``sampler.resolve_engine``; the resolved engine is
``config.engine`` and in ``diagnostics()``).  Meshes, ``run_until``,
``map_estimate`` and ``resume`` are not ported yet and raise.
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
from . import sampler as sm
from .cube import Cube, torch_dtype
from .instruments import Instrument, MUSE
from .metrics import MetricsWriter, logger


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
        device=None,
    ):
        if mesh is not None:
            raise sm.not_ported("mesh", mesh)
        if spatial_mesh is not None:
            raise sm.not_ported("mesh", spatial_mesh)
        self.device = torch.device(device) if device is not None else default_device()
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
            coarse_every=coarse_every or None,
            coarse_mode=coarse_mode,
            tile=None if tile is None else tuple(tile),
            chi2_rebaseline_every=chi2_rebaseline_every,
        )
        self.problem = sm.make_problem(cube, self.instrument, self.config,
                                       device=self.device)
        self.config = self.problem.config
        # The JAX package switches coarse pattern passes on by default for
        # mh on large blurred fields; the port has no coarse passes yet, so
        # it refuses to run such a field without them (coarse_every=0 opts
        # out explicitly).
        from .ops.coarse import auto_coarse_every

        auto_every = (
            auto_coarse_every(self.problem) if coarse_every is None else None
        )
        if auto_every:
            raise NotImplementedError(
                f"a {self.problem.Y}x{self.problem.X} field with footprint "
                f"{self.problem.f} enables coarse pattern passes by default "
                "(coarse_every=8), which are not ported to deconv3d_tpu_torch "
                "yet: see ROADMAP.md, Queue 1 item 13.  Pass coarse_every=0 "
                "to run plain single-site sweeps."
            )
        self._states = None
        self._traces = {"chi2": [], "accept": [], "flux": [], "monitor": []}
        self._last_result: Optional[ch.MultiChainResult] = None

    # -- execution -----------------------------------------------------------

    @property
    def states(self) -> sm.SamplerState:
        """Chain states (leading chain axis), allocated on first use."""
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
        """Execute the MCMC in segments of ``segment_size`` sweeps."""
        total = self.config.max_iterations if n_sweeps is None else n_sweeps
        seg = self.segment_size or max(1, min(total, 1000))
        writer = MetricsWriter(self.metrics_path)
        done = 0
        t_start = time.time()
        try:
            while done < total:
                n = min(seg, total - done)
                t0 = time.time()
                mc = ch.run_chains(self.problem, self.n_chains, n_sweeps=n,
                                   states=self.states)
                self.states = mc.result.state
                # NaN guard: a non-finite chi² means diverged numerics and
                # would poison every later segment and the accumulators
                chi2_now = self.states.chi2.cpu().numpy()
                dt = time.time() - t0
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
                    ckpt.save_state(
                        self.checkpoint_path, self.states,
                        meta={"sweeps_done": self.sweeps_done},
                    )
        finally:
            writer.close()
        logger.info("run finished: %d sweeps in %.2fs", total,
                    time.time() - t_start)
        acc = self.acceptance_rate
        if acc < self.min_acceptance_rate:
            logger.warning(
                "acceptance rate %.4f below min_acceptance_rate %.4f — "
                "jump amplitude is likely mistuned", acc,
                self.min_acceptance_rate,
            )
        return self

    def run_until(self, *args, **kwargs):
        raise NotImplementedError(
            "Run.run_until is not ported to deconv3d_tpu_torch yet: see "
            "ROADMAP.md, Queue 1 item 7"
        )

    def resume(self, path: Optional[str] = None):
        raise NotImplementedError(
            "Run.resume is not ported to deconv3d_tpu_torch yet: see "
            "ROADMAP.md, Queue 1 item 7"
        )

    def map_estimate(self, *args, **kwargs):
        raise NotImplementedError(
            "Run.map_estimate is not ported to deconv3d_tpu_torch yet: see "
            "ROADMAP.md, Queue 1 item 14"
        )

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
