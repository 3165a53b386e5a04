"""deconv3d-tpu-torch: Bayesian deconvolution of hyperspectral cubes on
PyTorch and CUDA.

The PyTorch port of ``deconv3d_tpu``: Metropolis-Hastings-within-Gibbs
sampling of clean MUSE cubes under a separable FSF ⊛ LSF instrument model,
with incremental local-patch likelihood deltas and convergence diagnostics.
On a CUDA device every sweep runs through a hand-written Hopper kernel
(``csrc/resident_sweep.cu``, ``csrc/mh_sweep.cu``, ``csrc/gibbs_sweep.cu``,
or on fields whose residual and weights exceed the 1 GiB window budget,
``ops/tiled.py::WINDOW_BUDGET_BYTES``, the tiled ``csrc/tiled_sweep.cu``),
and MH on a large blurred field interleaves coarse pattern passes whose
banded draws run ``csrc/banded.cu``, as do the preconditioner solves of
the direct sampler (``sampler='direct'``) and of ``Run.map_estimate``; on
the CPU everything runs its plain torch version.

    from deconv3d_tpu_torch import Run, MUSE, Cube
    run = Run(cube, MUSE(), max_iterations=10_000)
    run.run()
    run.save("my_run")
"""

from .cube import Cube
from .instruments import (
    Instrument, MUSE,
    PointSpreadFunction, MoffatPointSpreadFunction,
    GaussianPointSpreadFunction, NoPointSpreadFunction,
    LineSpreadFunction, MUSELineSpreadFunction,
    GaussianLineSpreadFunction, NoLineSpreadFunction,
    TabulatedPointSpreadFunction, TabulatedLineSpreadFunction,
    MoffatFSF, GaussianFSF, NoFSF, TabulatedFSF,
    MUSELSF, GaussianLSF, NoLSF, TabulatedLSF,
)
from .convolve import convolve_cube
from .sampler import (
    RunConfig, SamplerState, make_problem, init_state, run_sweeps, ChainResult,
)
from .chains import MultiChainResult, gelman_rubin, run_chains
from .ops.direct import suggest_prior_precision
from .run import Run

#: the reference package's name for the cube type
HyperspectralCube = Cube

__version__ = "0.1.0"

__all__ = [
    "Cube", "HyperspectralCube", "Run", "RunConfig",
    "Instrument", "MUSE",
    "PointSpreadFunction", "MoffatPointSpreadFunction",
    "GaussianPointSpreadFunction", "NoPointSpreadFunction",
    "LineSpreadFunction", "MUSELineSpreadFunction",
    "GaussianLineSpreadFunction", "NoLineSpreadFunction",
    "TabulatedPointSpreadFunction", "TabulatedLineSpreadFunction",
    "MoffatFSF", "GaussianFSF", "NoFSF", "TabulatedFSF",
    "MUSELSF", "GaussianLSF", "NoLSF", "TabulatedLSF",
    "convolve_cube",
    "SamplerState", "make_problem", "init_state", "run_sweeps", "ChainResult",
    "MultiChainResult", "gelman_rubin", "run_chains",
    "suggest_prior_precision",
]
