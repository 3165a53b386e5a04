"""Basic end-to-end deconvolution of a synthetic MUSE-style subcube, on the
PyTorch port (``deconv3d_tpu_torch``).

The port's twin of ``basic_deconvolution.py``: the same scene, sampler
settings and printed lines.  The flow mirrors the reference workflow:
build/observe a cube, hand it to ``Run`` with an instrument model, sample,
inspect diagnostics, save FITS products, then the MAP.

    python examples/torch_basic_deconvolution.py               # on the card
    python examples/torch_basic_deconvolution.py --device cpu  # plain torch

It runs on the CUDA card unless told otherwise: every gibbs sweep is one
launch of the resident (or classic) sweep kernel, the MAP's preconditioner
solves launch the banded solve kernel.  Without a card it raises — there is
no CPU fallback; ``--device cpu`` runs the plain torch versions of the same
steps (minutes at 400 sweeps).
"""

import argparse

import numpy as np
import torch

import deconv3d_tpu_torch as d3

L, Y, X = 32, 16, 16
NOISE = 0.05

#: what ``basic_deconvolution.py`` (the JAX package) printed on the CPU at
#: these settings (PERF.md §6).  This script's chain is another draw of the
#: same posterior, so its χ²/dof lands within CHI2_DOF_BAND of the JAX one:
#: 3σ of the difference of two draws' χ²/dof, σ = 2 / √N for N voxels.
JAX_CPU_FIGURES = {"chi2_dof": 1.0101, "peak": (16, 8, 8),
                   "map_peak": (16, 8, 8)}
CHI2_DOF_BAND = 3 * 2 / np.sqrt(L * Y * X)


def scene():
    """The JAX example's observation: one emission-line point source of 100
    at (16, 8, 8), blurred by ``MUSE()`` (Moffat FSF + MUSE UDF LSF
    defaults) and given N(0, 0.05²) noise from ``default_rng(0)``.
    Returns the noisy cube (on the CPU) and the instrument."""
    truth = np.zeros((L, Y, X), np.float32)
    truth[16, 8, 8] = 100.0
    cube = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25)
    muse = d3.MUSE()

    # forward-model the observation and add noise
    observed = muse.convolve(cube)
    rng = np.random.default_rng(0)
    data = observed.data.numpy() + rng.normal(0, NOISE, truth.shape)
    noisy = d3.Cube.from_data(
        data.astype(np.float32),
        variance=np.full(truth.shape, NOISE**2, np.float32),
        crval=4750.0, cdelt=1.25,
    )
    return noisy, muse


def main(device="cuda", max_iterations=400):
    """Run the example; return its printed figures (and the ``Run``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') "
                           "to run the plain torch versions on the CPU")
    noisy, muse = scene()
    n_vox = L * Y * X

    # --- deconvolve --------------------------------------------------------
    # sampler='gibbs' draws each voxel exactly from its conditional
    # (acceptance 1, no tuning) and reaches the noise floor far faster than
    # the reference's MH — use 'mh' for the reference-parity behaviour.
    # The port draws its uniforms from Philox streams keyed by the chain
    # and the absolute sweep, so seed 0 is not the JAX package's chain, and
    # every engine holds the weights bf16-valued (the kernels' type): the
    # figures agree with the JAX example's within the chains' noise, not
    # bit for bit.  The f = 17 footprint covers the 16 × 16 field, so Run
    # logs the blur warning (coarse passes are not auto-enabled here).
    run = d3.Run(noisy, muse, max_iterations=max_iterations, sampler="gibbs",
                 device=device)
    run.run()

    chi2_dof = run.chi2 / n_vox
    diagnostics = run.diagnostics()
    print(f"chi2/dof        : {chi2_dof:.4f}  (expect ≈ 1)")
    print(f"acceptance rate : {run.acceptance_rate:.3f}")
    print(f"diagnostics     : {diagnostics}")

    # the CONVOLVED posterior mean must reproduce the blurred truth; the
    # deconvolved cube concentrates flux back toward the injected voxel but
    # its per-voxel values carry large blur-null posterior variance — always
    # compare fluxes through the forward model.
    recon = run.convolved_cube().data.cpu().numpy()
    peak = tuple(int(i) for i in np.unravel_index(np.argmax(recon),
                                                  recon.shape))
    print(f"reconvolved peak: {peak}  (injected at (16, 8, 8))")

    run.save("deconv_out")                 # FITS cubes + traces + stats JSON
    print("wrote deconv_out*")

    # Deterministic MAP point estimate (no MCMC): the posterior mean of the
    # linear-Gaussian model by preconditioned CG — useful as a fast first
    # look or a convergence cross-check for the chains above.  The same
    # forward-model rule applies: under heavy blur the raw MAP voxels carry
    # the blur-null indeterminacy, so inspect the CONVOLVED MAP.  (The
    # port's CG runs in the problem's float32 and refines the solution
    # against the float64 residual.)
    map_cube = run.map_estimate(tol=2e-4, maxiter=2500)
    map_conv = muse.convolve(map_cube).data.cpu().numpy()
    peak_map = tuple(int(i) for i in np.unravel_index(np.argmax(map_conv),
                                                      map_conv.shape))
    print(f"MAP reconv peak : {peak_map}  (injected at (16, 8, 8))")
    return {
        "chi2_dof": chi2_dof,
        "acceptance": run.acceptance_rate,
        "diagnostics": diagnostics,
        "peak": peak,
        "map_peak": peak_map,
        "map_iterations": run.last_map_result.iterations,
        "map_rel_residual": run.last_map_result.rel_residual,
        "run": run,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
