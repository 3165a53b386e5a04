"""Command line over the library, the JAX package's ``run`` / ``map`` /
``info`` commands (``deconv3d_tpu/__main__.py``) on the port's ``Run``:

    python -m deconv3d_tpu_torch run --cube data.fits --out my_deconv \
        --iterations 10000 --chains 8 --sampler gibbs
    python -m deconv3d_tpu_torch map --cube data.fits --out my_map.fits
    python -m deconv3d_tpu_torch info --cube data.fits

``--device`` (``cuda`` by default) picks where ``run`` and ``map`` work;
``--device cpu`` runs the plain torch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _tau_arg(s: str):
    """--prior-precision value: a float, or "auto" (1e-4 of the mean
    weight, ``ops/direct.py::suggest_prior_precision``)."""
    return s if s == "auto" else float(s)


def _add_instrument_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fsf", choices=["moffat", "gaussian", "tabulated"],
                   default="moffat")
    p.add_argument("--fsf-fwhm", type=float, default=0.66,
                   help="FSF FWHM in arcsec")
    p.add_argument("--fsf-beta", type=float, default=2.6)
    p.add_argument("--fsf-image", default=None,
                   help="--fsf tabulated: .npy/.npz with the measured "
                        "[f,f] or [L,f,f] FSF raster")
    p.add_argument("--lsf", choices=["muse", "gaussian", "tabulated"],
                   default="muse")
    p.add_argument("--lsf-fwhm", type=float, default=2.5,
                   help="Gaussian LSF FWHM in Angstrom")
    p.add_argument("--lsf-kernel", default=None,
                   help="--lsf tabulated: .npy/.npz with the measured "
                        "[w] or [L,w] spectral kernel")
    p.add_argument("--pixel-scale", type=float, default=0.2)
    p.add_argument("--direct-radial-bins", type=int, default=256,
                   help="|k|-bin count of the radially-binned Fourier "
                        "preconditioner (full-field direct/MAP solves)")
    p.add_argument("--direct-precond-scale", action="store_true",
                   help="boundary/mask-aware diagonal scaling of the "
                        "Fourier preconditioner (direct/MAP solves)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run: 'cuda' (default) or 'cpu'")


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cube", required=True, help="FITS or NPZ cube path")
    p.add_argument("--out", default="deconv3d_out", help="output prefix")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--burn-in", type=int, default=None)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler",
                   choices=["mh", "gibbs", "gibbs_block", "direct"],
                   default="mh")
    p.add_argument("--engine",
                   choices=["auto", "cuda", "cuda_tiled", "torch",
                            "torch_tiled"], default="auto")
    p.add_argument("--positivity", action="store_true")
    _add_instrument_args(p)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--metrics", default=None)
    p.add_argument("--plots", action="store_true")
    p.add_argument("--initial", choices=["zeros", "data"], default="zeros")
    p.add_argument("--spatial-shards", type=int, default=None,
                   help="shard ONE chain's sweep over this many devices "
                        "(the first k CUDA devices; with --device cpu, k "
                        "slots of the CPU)")
    p.add_argument("--no-variance", action="store_true",
                   help="skip the posterior-variance accumulator (saves "
                        "~2 cubes of device memory on huge fields)")
    p.add_argument("--coarse-every", type=int, default=None,
                   help="interleave a coarse pattern pass every N sweeps "
                        "(spatial mixing accelerator; ops/coarse.py)")
    p.add_argument("--coarse-mode",
                   choices=["global", "soft", "block", "mixed"],
                   default="global")
    p.add_argument("--prior-precision", type=_tau_arg, default=0.0,
                   help="Gaussian ridge prior precision tau (1/flux^2) or "
                        "'auto', sampler='direct' only; bounds the "
                        "blur-null modes so PCG converges under heavy blur")
    p.add_argument("--until-rhat", type=float, default=None,
                   help="run until split-R-hat of chi2 AND every monitor "
                        "voxel is below this (needs --chains >= 2); "
                        "--iterations becomes the sweep budget")
    p.add_argument("--min-ess", type=float, default=None,
                   help="run until the chi2 effective sample size reaches "
                        "this (alone or combined with --until-rhat)")


def _load_kernel_array(path: str, what: str) -> np.ndarray:
    """Measured-kernel file: .npy, or .npz (key 'image'/'kernel'/sole array)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            for key in ("image", "kernel"):
                if key in z:
                    return np.asarray(z[key])
            names = list(z.keys())
            if len(names) != 1:
                raise SystemExit(
                    f"{what}: {path} has keys {names}; expected a single "
                    "array or an 'image'/'kernel' key"
                )
            return np.asarray(z[names[0]])
    return np.asarray(np.load(path))


def _build_instrument(args):
    from . import instruments as ins

    if args.fsf == "tabulated":
        if not args.fsf_image:
            raise SystemExit("--fsf tabulated requires --fsf-image PATH")
        fsf = ins.TabulatedFSF(
            image=_load_kernel_array(args.fsf_image, "--fsf-image"))
    elif args.fsf == "moffat":
        fsf = ins.MoffatFSF(fwhm=args.fsf_fwhm, beta=args.fsf_beta)
    else:
        fsf = ins.GaussianFSF(fwhm=args.fsf_fwhm)
    if args.lsf == "tabulated":
        if not args.lsf_kernel:
            raise SystemExit("--lsf tabulated requires --lsf-kernel PATH")
        lsf = ins.TabulatedLSF(
            kernel=_load_kernel_array(args.lsf_kernel, "--lsf-kernel"))
    elif args.lsf == "muse":
        lsf = ins.MUSELSF()
    else:
        lsf = ins.GaussianLSF(fwhm=args.lsf_fwhm)
    return ins.Instrument(fsf=fsf, lsf=lsf, pixel_scale=args.pixel_scale)


def cmd_run(args) -> int:
    from .run import Run

    run = Run(
        args.cube, _build_instrument(args),
        max_iterations=args.iterations, burn_in=args.burn_in,
        n_chains=args.chains, seed=args.seed, sampler=args.sampler,
        engine=args.engine, positivity=args.positivity,
        initial=args.initial, spatial_mesh=args.spatial_shards,
        track_variance=not args.no_variance,
        coarse_every=args.coarse_every, coarse_mode=args.coarse_mode,
        prior_precision=args.prior_precision,
        direct_radial_bins=args.direct_radial_bins,
        direct_precond_scale=args.direct_precond_scale,
        checkpoint_path=args.checkpoint, metrics_path=args.metrics,
        device=args.device,
    )
    if args.until_rhat is not None or args.min_ess is not None:
        until = run.run_until(rhat=args.until_rhat, min_ess=args.min_ess,
                              max_sweeps=args.iterations)
    else:
        until = None
        run.run()
    run.save(args.out, plots=args.plots)
    out = run.diagnostics()
    if until is not None:
        out["run_until"] = until
    print(json.dumps(out, indent=2, default=float))
    return 0


def cmd_map(args) -> int:
    """Deterministic MAP / posterior-mean solve (no MCMC) → one FITS cube."""
    from .run import Run

    run = Run(
        args.cube, _build_instrument(args), max_iterations=1,
        direct_tol=args.tol, direct_maxiter=args.maxiter,
        direct_radial_bins=args.direct_radial_bins,
        direct_precond_scale=args.direct_precond_scale, device=args.device,
    )
    run.map_estimate(prior_precision=args.prior_precision).to_fits(args.out)
    res = run.last_map_result
    print(json.dumps({
        "out": args.out, "tol": args.tol,
        # the resolved value ('auto' becomes the suggested float)
        "prior_precision": run.last_map_prior_precision,
        "iterations": int(res.iterations),
        "rel_residual": float(res.rel_residual),
        # machine-readable: the log warning is easily lost in pipelines
        "converged": bool(res.rel_residual <= args.tol),
    }))
    return 0


def cmd_info(args) -> int:
    from .cube import Cube

    cube = Cube.from_file(args.cube, device="cpu")
    lam = cube.wavelengths()
    data = cube.data.numpy()
    print(json.dumps({
        "shape_lyx": list(cube.shape),
        "lambda_range_A": [float(lam[0]), float(lam[-1])],
        "cdelt_A": cube.cdelt,
        "has_variance": cube.variance is not None,
        "nan_voxels": int(np.isnan(data).sum()),
        "flux_sum": float(np.nansum(data)),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deconv3d_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a deconvolution")
    _add_run_args(runp)
    mapp = sub.add_parser(
        "map", help="deterministic MAP/posterior-mean solve (no MCMC)")
    mapp.add_argument("--cube", required=True, help="FITS or NPZ cube path")
    mapp.add_argument("--out", default="deconv3d_map.fits")
    mapp.add_argument("--tol", type=float, default=1e-6)
    mapp.add_argument("--maxiter", type=int, default=500)
    mapp.add_argument(
        "--prior-precision", type=_tau_arg, default=None,
        help="Gaussian ridge prior precision tau (1/flux^2) or 'auto'; "
             "restores CG convergence under heavy blur")
    _add_instrument_args(mapp)
    infop = sub.add_parser("info", help="inspect a cube file")
    infop.add_argument("--cube", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "map":
        return cmd_map(args)
    return cmd_info(args)


if __name__ == "__main__":
    sys.exit(main())
