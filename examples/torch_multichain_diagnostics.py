"""Multi-chain convergence workflow on the PyTorch port: R-hat / ESS over
batched chains.

The port's twin of ``multichain_diagnostics.py``: the same scene, sampler
settings and printed lines.  On one card the 8 chains run as ONE batch — a
single kernel launch per sweep for all of them, zero collectives in the
hot loop; with several cards visible, ``run_chains(..., mesh=make_mesh())``
spreads them over the cards (the JAX example's "shards over the mesh").

    python examples/torch_multichain_diagnostics.py               # on the card
    python examples/torch_multichain_diagnostics.py --device cpu  # plain torch

Without a card it raises unless ``--device cpu`` is given (no fallback).
"""

import argparse

import numpy as np
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch.parallel import make_mesh

L, Y, X = 32, 16, 16
N_CHAINS = 8


def scene():
    """The JAX example's observation: a line source of 50 at (16, 8, 8)
    through ``MUSE()``, N(0, 0.05²) noise from ``default_rng(1)``.
    Returns the noisy cube (on the CPU) and the instrument."""
    truth = np.zeros((L, Y, X), np.float32)
    truth[16, 8, 8] = 50.0
    cube = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25)
    muse = d3.MUSE()
    observed = muse.convolve(cube)
    rng = np.random.default_rng(1)
    noisy = d3.Cube.from_data(
        (observed.data.numpy()
         + rng.normal(0, 0.05, truth.shape)).astype(np.float32),
        variance=np.full(truth.shape, 0.05**2, np.float32),
        crval=4750.0, cdelt=1.25,
    )
    return noisy, muse


def chain_mesh(device: torch.device):
    """Several cards whose count divides the chains: one slot per card;
    else None — one batch on ``device``."""
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_cards > 1 and N_CHAINS % n_cards == 0:
        return make_mesh(n_cards, "chains")
    return None


def main(device="cuda", max_iterations=400):
    """Run the example; return its printed figures (and the problem and
    chains' result)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') "
                           "to run the plain torch versions on the CPU")
    noisy, muse = scene()

    # coarse_every interleaves globally-coherent pattern moves (exact Gibbs
    # draws along the blur-null directions, ops/coarse.py; on the card their
    # banded factor and draws run csrc/banded.cu) — without them,
    # single-site sweeps random-walk the blurred spatial modes and per-voxel
    # R-hat stays far from 1 at feasible chain lengths.  Each chain draws
    # from its own Philox key (the seed in the low word, the chain in the
    # high word), so the chains are not the JAX package's.
    cfg = d3.RunConfig(max_iterations=max_iterations, sampler="gibbs",
                       coarse_every=4)
    problem = d3.make_problem(noisy, muse, cfg, device=device)

    mc = d3.run_chains(problem, n_chains=N_CHAINS,
                       mesh=chain_mesh(device))    # one batch per card
    diagnostics = mc.diagnostics(discard_frac=0.5)
    print("per-statistic diagnostics:", diagnostics)

    # dense per-voxel Gelman-Rubin map from the accumulators (no extra
    # per-sweep cost) — the practical "has THIS voxel converged" answer
    rhat = mc.rhat_cube(problem)
    median, p99 = np.nanmedian(rhat), np.nanpercentile(rhat, 99)
    print(f"voxel R-hat: median {median:.3f}  p99 {p99:.3f}")

    pooled = mc.posterior_mean(problem)
    print("pooled posterior mean shape:", tuple(pooled.shape))
    return {
        "diagnostics": diagnostics,
        "rhat_median": float(median),
        "rhat_p99": float(p99),
        "posterior_mean_shape": tuple(pooled.shape),
        "rhat": rhat,
        "problem": problem,
        "chains": mc,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
