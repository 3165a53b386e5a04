"""MH-within-Gibbs sampler core on torch — color-decomposed sweeps.

PyTorch counterpart of ``deconv3d_tpu/sampler.py`` for ``sampler='mh'``,
``'gibbs'`` and ``'gibbs_block'``, with any number of chains per kernel
launch.  The scheme is the JAX package's:

  * The FSF footprint is ``f×f`` (odd).  Spaxels whose (y, x) offsets are
    both multiples of ``f`` have disjoint likelihood patches, so their
    single-site MH updates commute.  Coloring the spaxel grid by
    ``(y mod f, x mod f)`` gives ``f²`` colors; one *sweep* scans the colors
    in order and updates every spaxel of a color at once.
  * A spaxel-spectrum perturbation δ changes the model by the separable
    outer product g[μ]·F[μ,dy,dx] with g = LSF(δ), so Δχ² needs only the
    residual patch and the precomputed ``quad = Σ F² w``.
  * ``'mh'`` proposes a Cauchy jump of each spaxel's whole spectrum;
    ``'gibbs'`` draws every voxel from its exact Gaussian conditional
    (precision ``qvox``), the wavelengths of one spaxel in ``lw`` phases
    (voxels ``lw`` apart have disjoint LSF footprints); ``'gibbs_block'``
    draws every spaxel's whole spectrum from its exact conditional through
    the banded Cholesky factor of its precision (``Problem.chol``,
    ``ops/banded.py``).
  * ``positivity=True`` (``'mh'``, ``'gibbs'``) restricts the posterior to
    clean ≥ 0: MH reflects each proposal, c' = |c + J|, gibbs draws each
    voxel from its one-sided truncated normal (``ops/truncnorm.py``).
  * With ``coarse_every`` set (``Run`` sets 8 for MH on large blurred
    fields), a coarse pattern pass (``ops/coarse.py``) follows every
    ``coarse_every``-th absolute sweep (:func:`coarse_interleave`).
  * ``'direct'`` (``ops/direct.py``) draws independent exact samples of
    the whole cube's Gaussian posterior by perturb-and-solve PCG; one
    sweep is one draw.  Its problem keeps the exact weights and the full
    FSF (the JAX package runs it on its jnp engine).

Every sweep engine builds the *kernel-engine problem* of the JAX package:
weights rounded to bfloat16 values before ``quad`` and χ², and the FSF
replaced by its low-rank reconstruction Σ_s spec_s ⊗ img_s (``'direct'``
keeps both exact).  The engine follows the
device: on a CUDA device every sweep runs a hand-written kernel, on the
CPU its plain torch version.  With positivity that is the w̃-weighted
posterior truncated to clean ≥ 0 — the JAX package runs positivity on its
jnp engine, whose exact weights and full FSF give the exact-weight one.
Two scans of the spaxels, each an engine per device: the whole-cube one
(colors over the whole field; ``'cuda'``, ``csrc/mh_sweep.cu`` /
``csrc/gibbs_sweep.cu``, and ``'torch'``, ``ops/sweep.py``;
``'gibbs_block'`` runs only here, its per-color draw on
``csrc/banded.cu``) and the tiled one for fields whose residual and weights
exceed the 1 GiB window budget (``ops/tiled.py::WINDOW_BUDGET_BYTES``;
tiles in wavefront order, all colors per tile; ``'cuda_tiled'``,
``csrc/tiled_sweep.cu``, and ``'torch_tiled'``, ``ops/tiled.py``).  All
sample the same posterior.

State layout (public, λ-major as in the JAX package):
    clean  [L, Yc, Xc]   Yc = ceil(Y/f)·f   (zero-padded clean cube)
    resid  [L, Hp, Wp]   Hp = f-1 + Yc      (data - conv(clean), zero-padded)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import convolve as cv
from . import metrics
from .cube import Cube, torch_dtype
from .instruments import Instrument
from .metrics import logger

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Sampler knobs — the JAX package's fields and defaults.

    ``max_iterations`` counts full sweeps (every unmasked spaxel visited
    once); the ``direct_*`` knobs only act through ``sampler='direct'``.
    ``coarse_every``: a coarse pass of ``coarse_mode`` (one of
    ``ops.coarse.MODES``) with proposal scale ``coarse_scale`` after every
    ``coarse_every``-th absolute sweep; None or 0 is off.
    ``engine``: ``'cuda'`` / ``'cuda_tiled'`` (the hand-written kernels)
    run on a CUDA device, ``'torch'`` / ``'torch_tiled'`` (their plain torch
    versions) elsewhere; naming the other device's engine raises.
    ``'auto'`` (:func:`resolve_engine`) takes the device's tiled engine
    when ``tile`` is given, or on a CUDA device when one chain's residual
    and weights exceed the measured window budget (``ops/tiled.py``); else
    the whole-cube engine.  ``tile`` = (ny_t, nx_t) spaxel blocks per tile
    (None: planned).
    ``lambda_chunk``: the plain engines (``'torch'``, ``'torch_tiled'``,
    ``'gibbs_block'``'s step and the plain band sweep) read and commit a
    color's residual slab this many λ-planes at a time, which bounds their
    slab temporaries on huge fields and leaves the chain bit-equal; 0 is
    off, None → :func:`auto_lambda_chunk` (the JAX package's rule).  The
    hand-written kernels have no slab temporaries: on the ``'cuda'``
    engines the knob does nothing.
    ``chi2_rebaseline_every``: None → 8 for gibbs with more than 2**28 B
    of clean cube, else 0 (off); an int works on every engine
    (:func:`rebaseline_interleave`).
    ``positivity``: clean ≥ 0 (``'mh'``, ``'gibbs'``; not with
    ``coarse_every``, ``'gibbs_block'`` or ``'direct'``).
    ``direct_*`` and ``prior_precision``: the PCG of ``sampler='direct'``
    and of ``Run.map_estimate`` (``ops/direct.py``): stop tolerance,
    iteration cap, preconditioner (``'banded'``, ``'banded_radial'``,
    ``'jacobi'``), radial bins, the diagonal scaling, the M-side ridge
    (``'auto'``: 1e-2 of the mean weight), the spatial convolution
    (``'auto'``: FFT); ``prior_precision`` τ ≥ 0 (or ``'auto'``: 1e-4 of
    the mean weight) adds the ridge prior c ~ N(0, τ⁻¹I), direct only.
    ``make_problem`` resolves both ``'auto'``s to floats.
    """

    max_iterations: int = 1000
    burn_in: Optional[int] = None          # default: max_iterations // 2
    keep_one_in: int = 1                   # thinning of the posterior mean
    track_variance: bool = True
    n_monitor: int = 8                     # voxels traced per sweep (for R̂)
    jump_scale: Optional[float] = None     # None → auto from weights
    target_acceptance: float = 0.234       # adaptive-MH target
    adapt_rate: float = 0.10               # Robbins-Monro step for log-scale
    # post-burn-in the adaptation decays as (sweeps past burn-in)^-decay;
    # None/0 freezes at burn-in
    adapt_decay: Optional[float] = 0.7
    positivity: bool = False
    sampler: str = "mh"
    initial: str = "zeros"                 # 'zeros' | 'data'
    fsf_size: Optional[int] = None
    lsf_width: Optional[int] = None
    seed: int = 0
    dtype: np.dtype = np.float32
    engine: str = "auto"                   # 'auto' | one of ENGINES
    tile: Optional[Tuple[int, int]] = None
    coarse_every: Optional[int] = None
    coarse_scale: float = 2.4
    coarse_mode: str = "global"
    lambda_chunk: Optional[int] = None
    fsf_tol: float = 1e-5                  # low-rank FSF tolerance
    fsf_max_rank: int = 8
    direct_tol: float = 1e-6
    direct_maxiter: int = 500
    direct_precond: str = "banded"
    direct_radial_bins: int = 256
    direct_precond_scale: bool = False
    direct_precond_tau: "float | str" = "auto"
    direct_spatial: str = "auto"
    chi2_rebaseline_every: Optional[int] = None
    prior_precision: "float | str" = 0.0

    def resolved_burn_in(self) -> int:
        if self.burn_in is not None:
            return self.burn_in
        if self.sampler == "direct":
            # iid draws: a burn-in would discard exact samples for nothing
            return 0
        return self.max_iterations // 2


def adapt_schedule(ids: torch.Tensor, cfg: RunConfig) -> torch.Tensor:
    """Per-sweep Robbins-Monro step sizes (float32) for absolute sweeps ``ids``.

    Full ``adapt_rate`` during burn-in; afterwards frozen (``adapt_decay``
    falsy) or decaying as t^-adapt_decay (diminishing adaptation).
    """
    burn = cfg.resolved_burn_in()
    in_burn = ids < burn
    rate = torch.tensor(cfg.adapt_rate, dtype=torch.float32)
    if not cfg.adapt_decay:
        return torch.where(in_burn, rate, torch.zeros((), dtype=torch.float32))
    t = torch.clamp(ids - burn + 1, min=1).to(torch.float32)
    tail = rate * t ** torch.tensor(-cfg.adapt_decay, dtype=torch.float32)
    return torch.where(in_burn, rate, tail)


def keep_schedule(ids: torch.Tensor, cfg: RunConfig) -> torch.Tensor:
    """1.0 for the absolute sweeps ``ids`` that enter the accumulators."""
    burn = cfg.resolved_burn_in()
    keep = (ids >= burn) & ((ids - burn) % cfg.keep_one_in == 0)
    return keep.to(torch.float32)


# ---------------------------------------------------------------------------
# Problem, state, result
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Problem:
    """Everything constant across sweeps (geometry + device tensors)."""

    L: int
    Y: int
    X: int
    f: int                          # FSF footprint (odd)
    ny: int                         # ceil(Y / f)
    nx: int                         # ceil(X / f)
    # [L, f, f] the low-rank reconstruction (the full bank for 'direct')
    fsf: torch.Tensor
    lsf: torch.Tensor               # [L, lw]
    data_pad: torch.Tensor          # [L, Hp, Wp]
    # [L, Hp, Wp] 1/variance, bf16-valued (exact for sampler='direct')
    w_pad: torch.Tensor
    # [L, Yc, Xc]  Σ_{dy,dx} F² w per spaxel (None for sampler='direct')
    quad: Optional[torch.Tensor]
    valid: torch.Tensor             # [Yc, Xc] bool
    monitor_idx: torch.Tensor       # [K] flat indices into clean
    fsf_spec: Optional[torch.Tensor]  # [S, L] (None for sampler='direct')
    fsf_imgs: Optional[torch.Tensor]  # [S, f, f]
    qvox: Optional[torch.Tensor] = None   # [L, Yc, Xc] voxel precision (gibbs)
    # [L, Yc, Xc] float64 quad − quad, the rounding's remainder (gibbs;
    # None counts as zero)
    quad_lo: Optional[torch.Tensor] = None
    # [Yc, Xc, L, lw] upper banded Cholesky factor of every spaxel's
    # spectrum precision Mᵀ diag(quad) M (gibbs_block)
    chol: Optional[torch.Tensor] = None
    # [Yc, Xc] λ-mean of quad, kept where quad is not (sampler='direct')
    quad_mean: Optional[torch.Tensor] = None
    config: RunConfig = RunConfig()
    # w_pad holds bfloat16 values (make_problem rounds them for every
    # sampler but 'direct'), so a bfloat16 copy of it is exact: the ring
    # kernels copy the weights as bfloat16 (ops/sweep.py sweep_state)
    w_bf16: bool = False

    @property
    def device(self) -> torch.device:
        return self.data_pad.device

    def to(self, device) -> "Problem":
        """This problem with every tensor on ``device`` (itself when it is
        there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def Yc(self) -> int:
        return self.ny * self.f

    @property
    def Xc(self) -> int:
        return self.nx * self.f

    @property
    def Hp(self) -> int:
        return self.f - 1 + self.Yc

    @property
    def Wp(self) -> int:
        return self.f - 1 + self.Xc

    @property
    def n_colors(self) -> int:
        return self.f * self.f

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


@dataclasses.dataclass
class SamplerState:
    clean: torch.Tensor        # [L, Yc, Xc]
    resid: torch.Tensor        # [L, Hp, Wp]
    key: torch.Tensor          # int64 scalar: the chain's 64-bit Philox key
    chi2: torch.Tensor         # float32 scalar, Kahan-compensated
    chi2_comp: torch.Tensor    # Kahan compensation term
    log_scale: torch.Tensor    # [Yc, Xc] per-spaxel log jump scale
    n_accept: torch.Tensor     # float32 scalar
    n_propose: torch.Tensor    # float32 scalar
    sum_clean: torch.Tensor    # [L, Yc, Xc] posterior-mean accumulator
    sum_sq: torch.Tensor       # [L, Yc, Xc] posterior-var accumulator
    n_kept: torch.Tensor       # float32 scalar
    sweep: torch.Tensor        # int64 absolute sweep counter


@dataclasses.dataclass
class ChainResult:
    """Output of run_sweeps: final state + per-sweep traces."""

    state: SamplerState
    chi2_trace: torch.Tensor        # [n_sweeps]
    accept_trace: torch.Tensor      # [n_sweeps] sweep acceptance rate
    flux_trace: torch.Tensor        # [n_sweeps] Σ clean over valid spaxels
    monitor_trace: torch.Tensor     # [n_sweeps, K] monitored clean voxels


# ---------------------------------------------------------------------------
# Problem construction
# ---------------------------------------------------------------------------

#: λ-planes per float64 ``quad`` conv: its float64 copy of the weights
#: holds one chunk, not the cube (2.9 GB for a full MUSE field)
_QUAD_CHUNK = 512


def _quad_conv(w_pad: torch.Tensor, fsf: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID correlation of w with F², in float64 → [L, Yc, Xc],
    :data:`_QUAD_CHUNK` planes at a time."""
    L, chunk = w_pad.shape[0], _QUAD_CHUNK
    out = None
    with cv.no_tf32():
        for lo in range(0, L, chunk):
            w = w_pad[lo : lo + chunk].to(torch.float64)
            fsf2 = fsf[lo : lo + chunk].to(torch.float64) ** 2
            q = torch.nn.functional.conv2d(w[None], fsf2[:, None],
                                           groups=w.shape[0])[0]
            if out is None:
                out = torch.empty((L, *q.shape[1:]), dtype=torch.float64,
                                  device=w_pad.device)
            out[lo : lo + q.shape[0]] = q
    return out


#: the sweep engines: (whole-cube, tiled) on a CUDA device and elsewhere
ENGINES = ("cuda", "cuda_tiled", "torch", "torch_tiled")

#: the ported samplers; the tiled engines run the first two
SAMPLERS = ("mh", "gibbs", "gibbs_block", "direct")

#: clean-cube bytes above which the auto rule switches the χ² rebaseline on
#: (the JAX package's big-field gate)
REBASELINE_AUTO_BYTES = 2**28


def _check_config(config: RunConfig) -> None:
    """The JAX package's refusals (``deconv3d_tpu/sampler.py:395-452``, in
    its order)."""
    from .ops.coarse import MODES

    if config.sampler == "gibbs_block" and config.positivity:
        raise ValueError(
            "gibbs_block draws whole spectra jointly; a positivity-"
            "truncated multivariate conditional has no closed form — use "
            "sampler='gibbs' (exact truncated-normal voxel draws) or 'mh'."
        )
    if config.coarse_every and config.positivity:
        raise ValueError(
            "coarse_every adds one shared jump per block, which cannot "
            "respect per-voxel positivity — disable one of the two."
        )
    if config.sampler == "direct" and config.positivity:
        raise ValueError(
            "sampler='direct' draws from the exact joint Gaussian; the "
            "positivity-truncated joint has no closed form — use "
            "sampler='gibbs' (exact truncated-normal voxel draws)."
        )
    tau = config.prior_precision
    if isinstance(tau, str):
        if tau != "auto":
            raise ValueError(
                f"prior_precision must be a float or 'auto', got {tau!r}")
    elif tau < 0:
        raise ValueError(f"prior_precision must be >= 0, got {tau}")
    if config.direct_radial_bins < 1:
        raise ValueError(f"direct_radial_bins must be >= 1, got "
                         f"{config.direct_radial_bins}")
    if config.direct_spatial not in ("auto", "direct", "fft"):
        raise ValueError(f"direct_spatial must be 'auto', 'direct' or 'fft', "
                         f"got {config.direct_spatial!r}")
    tm = config.direct_precond_tau
    if isinstance(tm, str):
        if tm != "auto":
            raise ValueError(
                f"direct_precond_tau must be a float or 'auto', got {tm!r}")
    elif tm < 0:
        raise ValueError(f"direct_precond_tau must be >= 0, got {tm}")
    if (tau == "auto" or tau > 0) and config.sampler != "direct":
        raise ValueError(
            "prior_precision (Gaussian ridge prior) is implemented for "
            "sampler='direct' and MAP solves only — the MCMC engines "
            "sample the reference's flat-prior posterior.  For a ridge "
            "MAP on any run, pass prior_precision to Run.map_estimate() "
            "instead of the config.")
    if config.sampler not in SAMPLERS:
        raise ValueError(
            f"sampler must be one of {SAMPLERS}, got {config.sampler!r}")
    if config.coarse_mode not in MODES:
        raise ValueError(
            f"coarse_mode must be one of {MODES}, got {config.coarse_mode!r}")
    if config.coarse_every is not None and config.coarse_every < 0:
        raise ValueError(
            f"coarse_every must be >= 0 (0 = off), got {config.coarse_every}")
    if config.engine not in ("auto", *ENGINES):
        raise ValueError(
            f"engine must be 'auto' or one of {ENGINES}, got {config.engine!r}"
        )
    every = config.chi2_rebaseline_every
    if every is not None and every < 0:
        raise ValueError(
            f"chi2_rebaseline_every must be >= 0 (0 = off), got {every}")


def _device_engines(device: torch.device, engine: str) -> Tuple[str, str]:
    """The device's (whole-cube, tiled) engines; ``engine`` naming another
    device's raises."""
    pair = (("cuda", "cuda_tiled") if device.type == "cuda"
            else ("torch", "torch_tiled"))
    if engine not in ("auto", *pair):
        raise RuntimeError(
            f"engine={engine!r} cannot run on {device}: on a CUDA device "
            "every sweep runs a CUDA kernel (engines 'cuda', 'cuda_tiled'), "
            "elsewhere its plain torch version ('torch', 'torch_tiled')"
        )
    return pair


def resolve_engine(config: RunConfig, device, f: int, ny: int, nx: int,
                   L: int, budget: Optional[int] = None
                   ) -> Tuple[str, Optional[Tuple[int, int]]]:
    """(engine, tile) of ``config`` on ``device`` for an f×f footprint over
    ny × nx spaxel blocks of L wavelengths.

    ``'auto'``: the tiled engine when ``config.tile`` is given, or on a CUDA
    device when one chain's padded residual and weights (float32) exceed
    ``budget`` (default ``ops.tiled.WINDOW_BUDGET_BYTES``) and a tile
    fits it; else the whole-cube engine.  The rule has the form of the JAX
    package's step from the whole-cube kernel down to the tiled one
    (``deconv3d_tpu/sampler.py:466-536``), with a budget measured on the
    card in place of VMEM's size: on an H100 the whole-cube kernel is the
    faster engine up to about a gigabyte of residual and weights
    (60×60×3681: 22 against 32 ms per MH sweep, 38 against 68 ms per gibbs
    sweep in (1, 2) tiles), and the tiled kernel in the planned tile above
    it (300×300×3681, (9, 9) tiles: 393 against 440 ms MH, 744 against 811
    ms gibbs; PERF.md §6, ``python -m
    deconv3d_tpu_torch.tile_sweep``).  A tiled engine without
    ``config.tile`` plans one (:func:`ops.tiled.plan_tiles`).
    ``'gibbs_block'`` stays on the whole-cube engine (its conditional
    draws are batched over a color's spaxels), and so does ``'direct'``
    (it sweeps no spaxels: the engine names the device); naming a tiled
    engine or a tile for either raises, as the JAX package's
    ``pallas_tiled`` does (``deconv3d_tpu/sampler.py:514-523``).
    """
    from .ops import tiled

    device = torch.device(device)
    whole, tiled_engine = _device_engines(device, config.engine)
    if budget is None:
        budget = tiled.WINDOW_BUDGET_BYTES
    tile, engine = config.tile, config.engine
    one_engine = config.sampler in ("gibbs_block", "direct")
    if one_engine and (engine == tiled_engine or tile is not None):
        raise ValueError(
            f"engine '{tiled_engine}' and tile support sampler='mh' and "
            f"'gibbs'; sampler={config.sampler!r} runs on engine '{whole}'")
    if engine == "auto":
        Hp, Wp = f - 1 + ny * f, f - 1 + nx * f
        big = Hp * Wp * L * 8 > budget
        if one_engine:
            engine = whole
        elif tile is not None or (device.type == "cuda" and big
                                  and tiled.plan_tiles(f, ny, nx, L, budget)):
            engine = tiled_engine
        else:
            engine = whole
    if engine == whole:
        if tile is not None:
            raise ValueError(f"tile={tile!r} needs a tiled engine "
                             f"('{tiled_engine}' or 'auto'), not {engine!r}")
        return engine, None
    if tile is None:
        tile = tiled.plan_tiles(f, ny, nx, L, budget)
        if tile is None:
            raise ValueError(
                f"no tile of the {ny}x{nx} spaxel-block grid (f={f}, L={L}) "
                f"fits the {budget} B window budget: use engine '{whole}'"
            )
    ny_t, nx_t = (int(t) for t in tile)
    if ny_t < 1 or nx_t < 1 or ny % ny_t or nx % nx_t:
        raise ValueError(f"tile={tuple(tile)!r} does not divide the {ny}x{nx} "
                         "spaxel-block grid")
    return engine, (ny_t, nx_t)


def auto_rebaseline_every(sampler: str, clean_bytes: int) -> int:
    """``chi2_rebaseline_every`` for None: 8 for gibbs with more than
    :data:`REBASELINE_AUTO_BYTES` of clean cube, else 0.  The JAX package
    ties the rule to its tiled engine, the only one that runs fields of
    that size there (``deconv3d_tpu/sampler.py:537-552``); here the
    whole-cube kernels run them too (``engine='cuda'`` pinned), so the rule
    holds on every engine."""
    return 8 if sampler == "gibbs" and clean_bytes > REBASELINE_AUTO_BYTES else 0


#: slab bytes (L·Yc·Xc·itemsize) above which the plain sweeps chunk λ
LAMBDA_CHUNK_AUTO_BYTES = 2**28


def auto_lambda_chunk(L: int, Yc: int, Xc: int, itemsize: int) -> int:
    """``lambda_chunk`` for None, the JAX package's rule
    (``deconv3d_tpu/sampler.py:689-694``): above
    :data:`LAMBDA_CHUNK_AUTO_BYTES` of slab, as many λ-planes as fit it
    (at least 1); else 0, off."""
    if L * Yc * Xc * itemsize <= LAMBDA_CHUNK_AUTO_BYTES:
        return 0
    return max(1, int(LAMBDA_CHUNK_AUTO_BYTES / (Yc * Xc * itemsize)))


def block_factors(lsf: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """``Problem.chol`` of ``sampler='gibbs_block'``: the upper banded
    Cholesky factor ``[Yc, Xc, L, lw]`` of every spaxel's spectrum
    precision Mᵀ diag(quad) M, ``quad`` ``[L, Yc, Xc]`` (the JAX package's
    ``make_problem``, ``deconv3d_tpu/sampler.py:696-705``).  quad is
    constant, so this runs once per problem, on a CUDA device as one
    launch of ``csrc/banded.cu`` for all Yc·Xc systems; a sweep only
    solves."""
    from .ops import banded

    return banded.cholesky_banded(banded.precision_bands(
        lsf, quad.movedim(0, -1).contiguous()).contiguous())


def make_problem(
    cube: Cube, instrument: Instrument, config: RunConfig = RunConfig(),
    device=None,
) -> Problem:
    """Rasterise kernels, build padded weights and per-spaxel quad terms.

    ``device`` defaults to the cube's.  The engine and tile resolve by
    :func:`resolve_engine`, ``chi2_rebaseline_every=None`` by
    :func:`auto_rebaseline_every`, ``lambda_chunk=None`` by
    :func:`auto_lambda_chunk`; naming another device's engine raises
    before any tensor moves.  Span ``setup.problem``, which with tracing
    on ends in a sync of a CUDA device; inside it ``setup.fsf_bank`` (the
    FSF at every λ and its rank-S factors, on the host) and
    ``setup.weights`` (the sanitised cube, the weights, the padded data,
    ``quad`` and the swept spaxels), and inside that ``setup.sanitize``
    (the cube and its variance moved to ``device`` and
    :meth:`Cube.sanitized`, ending in a sync like its parent).  Counters
    ``problem.fsf_rank`` (S; not for ``'direct'``, which keeps the full FSF),
    ``problem.swept_spaxels`` and ``problem.unswept_spaxels`` (of Y·X).
    """
    with metrics.span("setup.problem",
                      sync=device if device is not None else cube.device):
        return _make_problem(cube, instrument, config, device)


def _make_problem(cube: Cube, instrument: Instrument, config: RunConfig,
                  device) -> Problem:
    _check_config(config)
    device = torch.device(device) if device is not None else cube.device
    _device_engines(device, config.engine)
    dtype = torch_dtype(config.dtype)
    L, Y, X = cube.shape
    lam = cube.wavelengths()

    direct = config.sampler == "direct"
    spec_np = imgs_np = None
    with metrics.span("setup.fsf_bank"):
        fsf_np = instrument.fsf.bank(
            lam, size=config.fsf_size, pixel_scale=instrument.pixel_scale
        )
        if not direct:
            # The low-rank reconstruction F̃ = Σ_s spec ⊗ img becomes the
            # forward model of the sweeps, so the chain is exact for F̃
            # (ops/fsf_factor.py).  The direct sampler, like the JAX
            # package's jnp engine, keeps the full FSF.
            from .ops.fsf_factor import factor_bank

            spec_np, imgs_np, fsf_np, _err = factor_bank(
                fsf_np, tol=config.fsf_tol, max_rank=config.fsf_max_rank
            )
    lsf_np = instrument.lsf.bank(lam, cdelt=cube.cdelt, width=config.lsf_width)

    f = fsf_np.shape[-1]
    ny, nx = -(-Y // f), -(-X // f)
    Yc, Xc = ny * f, nx * f
    Hp, Wp = f - 1 + Yc, f - 1 + Xc
    h = f // 2
    engine, tile = resolve_engine(config, device, f, ny, nx, L)
    every = config.chi2_rebaseline_every
    if every is None:
        every = auto_rebaseline_every(config.sampler,
                                      L * Yc * Xc * dtype.itemsize)
    lam_chunk = config.lambda_chunk
    if lam_chunk is None:
        lam_chunk = auto_lambda_chunk(L, Yc, Xc, dtype.itemsize)
    config = dataclasses.replace(config, engine=engine, tile=tile,
                                 chi2_rebaseline_every=int(every),
                                 lambda_chunk=int(lam_chunk))

    weights = metrics.span("setup.weights", sync=device).start()
    with metrics.span("setup.sanitize", sync=device):
        cube = cube.to(device).sanitized()
        var = cube.variance.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=device)
    w = torch.where(torch.isfinite(var) & (var > 0), 1.0 / var, zero)
    w = torch.where(cube.mask[None], zero, w)
    # the two 'auto' ridges, τ = 1e-4·w̄ and τ_m = 1e-2·w̄ (ops/direct.py),
    # from the exact weights, resolved here so every consumer sees floats
    # (float32 products, as the JAX package's)
    wf = w.to(torch.float32)
    wbar = wf.sum() / torch.clamp((wf > 0).sum(), min=1)
    from .ops.direct import AUTO_PRIOR_REL, PRECOND_TAU_REL

    if config.prior_precision == "auto":
        config = dataclasses.replace(
            config, prior_precision=float(AUTO_PRIOR_REL * wbar))
        logger.info("prior_precision='auto' resolved to %.3e (rel=%.0e × "
                    "mean weight)", config.prior_precision, AUTO_PRIOR_REL)
    if config.direct_precond_tau == "auto":
        config = dataclasses.replace(
            config, direct_precond_tau=float(PRECOND_TAU_REL * wbar))
    del wf, wbar
    if not direct:
        # bfloat16-valued weights, as the TPU kernel engines keep them:
        # quad, chi² and accepts all see the same w̃, so the sampled
        # posterior is the w̃-weighted one on every engine and device.  The
        # direct sampler keeps the exact weights, as the JAX package's jnp
        # engine does.
        w = w.to(torch.bfloat16).to(dtype)
    w_pad = torch.zeros((L, Hp, Wp), dtype=dtype, device=device)
    w_pad[:, h : h + Y, h : h + X] = w
    data_pad = torch.zeros((L, Hp, Wp), dtype=dtype, device=device)
    data_pad[:, h : h + Y, h : h + X] = cube.data.to(dtype)

    fsf = torch.as_tensor(fsf_np, dtype=dtype, device=device)
    fsf_spec = fsf_imgs = None
    if not direct:
        fsf_spec = torch.as_tensor(spec_np, dtype=dtype, device=device)
        fsf_imgs = torch.as_tensor(imgs_np, dtype=dtype, device=device)
    # quad of the FSF the sweeps apply (Σ_s spec_s ⊗ img_s of the
    # working-precision factors), summed in float64: Δχ² = Σ g²·quad − 2g·lin
    # is exact only for that quad.  Any fixed error in it (another F, a
    # float32 sum over the f² footprint, or the float32 rounding itself,
    # which is the same for every spaxel of uniform weight) biases every
    # exact-Gibbs Δχ² the same way sweep after sweep, and the running χ²
    # drifts linearly from the from-scratch one.  Gibbs therefore also
    # keeps the rounding's remainder, quad_lo = quad₆₄ − quad.
    quad64 = _quad_conv(w_pad, fsf.double() if direct else torch.einsum(
        "sl,sab->lab", fsf_spec.double(), fsf_imgs.double()))
    quad = quad64.to(dtype)

    mask_np = cube.mask.cpu().numpy()
    valid = np.zeros((Yc, Xc), dtype=bool)
    valid[:Y, :X] = ~mask_np
    # spaxels with zero total weight in their footprint have an improper
    # flat conditional: freeze them at their initial value
    valid &= (quad.sum(dim=0) > 0).cpu().numpy()
    weights.stop()
    n_swept = int(valid.sum())
    if not direct:
        metrics.count("problem.fsf_rank", spec_np.shape[0])
    metrics.count("problem.swept_spaxels", n_swept)
    metrics.count("problem.unswept_spaxels", Y * X - n_swept)

    # deterministic set of monitored voxels (for per-parameter R̂)
    k = max(1, config.n_monitor)
    vy, vx = np.nonzero(valid)
    mon_rng = np.random.default_rng(config.seed + 7919)
    if len(vy) == 0:
        monitor = np.zeros(k, dtype=np.int64)
    else:
        pick = mon_rng.choice(len(vy), size=k, replace=len(vy) < k)
        lam_pick = mon_rng.integers(0, L, size=k)
        monitor = (lam_pick * Yc * Xc + vy[pick] * Xc + vx[pick]).astype(
            np.int64
        )

    lsf = torch.as_tensor(lsf_np, dtype=dtype, device=device)
    qvox = quad_lo = chol = None
    if config.sampler == "gibbs":
        # conditional precision of one voxel: Σ_μ M[μ,λ]² quad[μ], from the
        # bf16-valued-weight quad as the kernel engines build it
        from .ops.banded import precision_diag

        qvox = precision_diag(lsf, quad)
    if config.sampler in ("gibbs", "gibbs_block"):
        quad_lo = (quad64 - quad.double()).to(dtype)
    if config.sampler == "gibbs_block":
        chol = block_factors(lsf, quad)
    quad_mean = None
    if direct:
        # the direct draws never read quad: keep only the λ-mean that
        # init_state's jump-scale heuristic reads
        del quad64
        quad_mean, quad = quad.mean(dim=0), None

    return Problem(
        L=L, Y=Y, X=X, f=f, ny=ny, nx=nx,
        fsf=fsf,
        lsf=lsf,
        data_pad=data_pad,
        w_pad=w_pad,
        quad=quad,
        valid=torch.as_tensor(valid, device=device),
        monitor_idx=torch.as_tensor(monitor, device=device),
        fsf_spec=fsf_spec,
        fsf_imgs=fsf_imgs,
        qvox=qvox,
        quad_lo=quad_lo,
        chol=chol,
        quad_mean=quad_mean,
        config=config,
        w_bf16=not direct,
    )


def init_state(problem: Problem, cube: Optional[Cube] = None,
               key: Optional[int] = None) -> SamplerState:
    """Initial sampler state: clean guess, full-cube residual, chi².

    ``key`` is the chain's 64-bit Philox key (default ``config.seed``).
    """
    p, cfg = problem, problem.config
    dtype = torch_dtype(cfg.dtype)
    dev = p.device
    h = p.f // 2
    clean = torch.zeros((p.L, p.Yc, p.Xc), dtype=dtype, device=dev)
    if cfg.initial == "data":
        init_data = (
            torch.nan_to_num(cube.data.to(dev, dtype)) if cube is not None
            else p.data_pad[:, h : h + p.Y, h : h + p.X]
        )
        clean[:, : p.Y, : p.X] = init_data
    elif cfg.initial != "zeros":
        raise ValueError(f"initial must be 'zeros' or 'data', got {cfg.initial!r}")

    conv = cv.convolve_cube(clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    resid = p.data_pad.clone()
    resid[:, h : h + p.Y, h : h + p.X] -= conv
    # zero residual where weight is zero so chi² and patch updates agree
    resid = torch.where(p.w_pad > 0, resid, torch.zeros((), dtype=dtype, device=dev))
    chi2 = torch.sum(resid * resid * p.w_pad, dtype=torch.float32)

    if cfg.jump_scale is not None:
        log_scale = torch.full((p.Yc, p.Xc), float(np.log(cfg.jump_scale)),
                               dtype=dtype, device=dev)
    else:
        # Cauchy random-walk over an ~L-dimensional spectrum: measured
        # adapted scales follow ≈ 3.0·σ·L^(-5/6) (see the JAX package)
        qmean = p.quad_mean if p.quad is None else p.quad.mean(dim=0)
        sigma = 1.0 / torch.sqrt(torch.clamp(qmean, min=1e-20))
        log_scale = torch.log(3.0 * float(p.L) ** (-5.0 / 6.0) * sigma).to(dtype)
    log_scale = torch.where(p.valid, log_scale, torch.zeros((), dtype=dtype, device=dev))

    scalar = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    return SamplerState(
        clean=clean,
        resid=resid,
        key=scalar(cfg.seed if key is None else key, torch.int64),
        chi2=chi2,
        chi2_comp=scalar(0.0),
        log_scale=log_scale,
        n_accept=scalar(0.0),
        n_propose=scalar(0.0),
        sum_clean=torch.zeros((p.L, p.Yc, p.Xc), dtype=dtype, device=dev),
        sum_sq=(
            torch.zeros((p.L, p.Yc, p.Xc), dtype=dtype, device=dev)
            if cfg.track_variance
            else torch.zeros((1, 1, 1), dtype=dtype, device=dev)
        ),
        n_kept=scalar(0.0),
        sweep=scalar(0, torch.int64),
    )


# ---------------------------------------------------------------------------
# The hot loop
# ---------------------------------------------------------------------------

def run_sweeps(
    problem: Problem, state: SamplerState, n_sweeps: int
) -> ChainResult:
    """Run ``n_sweeps`` full sweeps of ``config.sampler`` (the hot path).

    ``state`` is one chain's, or a chain-stacked batch (leading chain axis
    on every field, chains at one sweep count) that advances in lockstep.
    On a CUDA device every sweep is one kernel launch for the whole batch;
    on the CPU the kernel's plain torch version runs
    (``ops.sweep.mh_segment`` / ``gibbs_segment``, or on a tiled engine
    ``ops.tiled.tiled_segment``).  ``'gibbs_block'``
    (``ops.sweep.gibbs_block_segment``) runs per color one launch of the
    banded draw kernel for the whole batch, the rest in torch ops;
    ``'direct'`` (``ops.direct.direct_run_sweeps``) one PCG solve per
    sweep and chain, the preconditioner's solves one launch of the banded
    solve kernel per iteration.  Burn-in
    sweeps adapt the per-spaxel MH jump scale and stay out of the posterior
    accumulators.

    With ``coarse_every`` set, a coarse pattern pass follows every
    ``coarse_every``-th absolute sweep (:func:`coarse_interleave`, the
    outer split).  With ``chi2_rebaseline_every`` set (auto for full-field
    gibbs) the running χ² is reset from :func:`full_chi2` at multiples of
    the absolute sweep counter (:func:`rebaseline_interleave`, inside); the
    chain itself is untouched.  Both split at absolute sweeps, so any
    segmentation of a run, and a resume, is bit-equal to one call.
    """
    return interleaved(problem, state, n_sweeps,
                       lambda s, k: _engine_run_sweeps(problem, s, k))


def interleaved(problem: Problem, state: SamplerState, n_sweeps: int,
                inner) -> ChainResult:
    """``inner(state, k)`` segments with the χ² rebaseline (inside) and the
    coarse passes (outside) at their absolute sweeps, as every engine
    runs them (the sharded ones of ``parallel/`` too)."""
    if problem.config.chi2_rebaseline_every:
        engine = inner

        def inner(s, k):
            return rebaseline_interleave(problem, s, k, engine)

    if problem.config.coarse_every:
        return coarse_interleave(problem, state, n_sweeps, inner)
    return inner(state, n_sweeps)


def _engine_run_sweeps(problem: Problem, state: SamplerState,
                       n_sweeps: int) -> ChainResult:
    if problem.config.sampler == "direct":
        from .ops.direct import direct_run_sweeps

        return direct_run_sweeps(problem, state, n_sweeps)
    if problem.config.engine.endswith("_tiled"):
        from .ops import tiled

        return tiled.tiled_segment(problem, state, n_sweeps).result
    from .ops import sweep as sw

    segment = {"mh": sw.mh_segment, "gibbs": sw.gibbs_segment,
               "gibbs_block": sw.gibbs_block_segment}[problem.config.sampler]
    return segment(problem, state, n_sweeps).result


def _interleave(state: SamplerState, n_sweeps: int, every: int, inner,
                at_boundary) -> ChainResult:
    """``inner(state, k)`` segments split where the absolute sweep counter
    reaches a multiple of ``every``, with ``at_boundary(state)`` there;
    the segments' traces concatenated (only the last segment's state is
    kept: a full field's state is 5.6 GB per chain)."""
    if n_sweeps <= 0:
        return inner(state, n_sweeps)
    traces, cur, left = [], state, n_sweeps
    while left > 0:
        done = int(cur.sweep.reshape(-1)[0])
        k = min(left, every - done % every)
        r = inner(cur, k)
        cur = r.state
        if int(cur.sweep.reshape(-1)[0]) % every == 0:
            cur = at_boundary(cur)
        traces.append((r.chi2_trace, r.accept_trace, r.flux_trace,
                       r.monitor_trace))
        left -= k
    dim = 0 if state.clean.dim() == 3 else 1     # the traces' sweep axis
    chi2_t, acc_t, flux_t, mon_t = (torch.cat(parts, dim=dim)
                                    for parts in zip(*traces))
    return ChainResult(state=cur, chi2_trace=chi2_t, accept_trace=acc_t,
                       flux_trace=flux_t, monitor_trace=mon_t)


def rebaseline_chi2(problem: Problem, state: SamplerState) -> SamplerState:
    """``state`` with χ² reset to :func:`full_chi2` (every chain of a
    chain-stacked state) and its Kahan compensation to 0.  Nothing else
    changes: clean, residual, key, log-scales and accumulators are the
    same tensors, so the sampled chain is bit-identical.  Span
    ``rebaseline``, timed on the device too."""
    with metrics.span("rebaseline", device=problem.device):
        if state.clean.dim() == 4:
            chi2 = torch.stack([
                full_chi2(problem, dataclasses.replace(state, clean=clean))
                for clean in state.clean
            ])
        else:
            chi2 = full_chi2(problem, state)
        return dataclasses.replace(state, chi2=chi2.to(torch.float32),
                                   chi2_comp=torch.zeros_like(state.chi2_comp))


def rebaseline_interleave(problem: Problem, state: SamplerState,
                          n_sweeps: int, inner) -> ChainResult:
    """``inner(state, k)`` segments split where the absolute sweep counter
    reaches a multiple of ``chi2_rebaseline_every``, with
    :func:`rebaseline_chi2` there: any segmentation of a run (``Run.run``
    segments, a resume) rebaselines at the same sweeps."""
    return _interleave(state, n_sweeps,
                       int(problem.config.chi2_rebaseline_every), inner,
                       lambda s: rebaseline_chi2(problem, s))


#: (weakref(problem), value) per (problem id, name): constants built once
#: per problem (a segmented run asks for them once per segment, and they
#: cost full-field convolutions); the weakref drops the entry with its
#: problem and guards against a recycled id
_PROBLEM_CACHE: dict = {}


def cached(problem: Problem, name, build):
    """``build()`` for ``problem`` under ``name``, built on first use and
    kept while the problem lives."""
    import weakref

    ckey = (id(problem), name)
    entry = _PROBLEM_CACHE.get(ckey)
    if entry is None or entry[0]() is not problem:
        ref = weakref.ref(problem, lambda _, k=ckey, c=_PROBLEM_CACHE:
                          c.pop(k, None))
        entry = (ref, build())
        _PROBLEM_CACHE[ckey] = entry
    return entry[1]


def coarse_constants_of(problem: Problem):
    """The coarse-pass constants of ``problem``'s ``coarse_mode``
    (``ops.coarse.coarse_constants``), built on first use and cached."""
    from .ops import coarse

    mode = problem.config.coarse_mode
    return cached(problem, ("coarse", mode),
                  lambda: coarse.coarse_constants(problem, mode))


def apply_coarse_pass(problem: Problem, state: SamplerState,
                      constants) -> SamplerState:
    """One coarse pass (``ops.coarse.coarse_pass``) on ``state``; a
    chain-stacked state chain by chain, each under its own key, so a chain
    is bit-equal alone and in a batch (and one chain's transients are live
    at a time).  Span ``coarse_pass``, timed on the device too."""
    from . import chains as ch
    from .ops import coarse

    mult = float(problem.config.coarse_scale)
    with metrics.span("coarse_pass", device=problem.device):
        if state.clean.dim() == 3:
            return coarse.coarse_pass(problem, state, constants, mult)
        return ch.stack_chains([
            coarse.coarse_pass(problem, ch.select_chains(state, c),
                               constants, mult)
            for c in range(state.clean.shape[0])
        ])


def coarse_interleave(problem: Problem, state: SamplerState, n_sweeps: int,
                      inner) -> ChainResult:
    """``inner(state, k)`` segments split at absolute-sweep multiples of
    ``coarse_every``, with :func:`apply_coarse_pass` there: any
    segmentation of a run, and a resume, passes at the same sweeps with the
    same draws (Philox keyed by the absolute sweep, ``ops/philox.py``).
    The pass changes the state, not the segment's traces."""
    constants = coarse_constants_of(problem)
    return _interleave(state, n_sweeps, int(problem.config.coarse_every),
                       inner,
                       lambda s: apply_coarse_pass(problem, s, constants))


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

#: cube bytes (L·Y·X·4, the other big-field gates' measure) above which
#: :func:`full_chi2` evaluates in λ-chunks
FULL_CHI2_CHUNK_BYTES = 2**28


def full_chi2(problem: Problem, state: SamplerState) -> torch.Tensor:
    """Recompute chi² from scratch via the full conv path (drift check).

    Above :data:`FULL_CHI2_CHUNK_BYTES` of cube this is
    :func:`full_chi2_chunked`, on every device: the monolithic
    ``convolve_cube`` holds several cube-size transients (10.4 GB above
    the live state at the full MUSE field on the card, the chunked path
    2.3 GB: PERF.md §6), at every χ² rebaseline of a full-field gibbs
    run."""
    p = problem
    if p.L * p.Y * p.X * 4 > FULL_CHI2_CHUNK_BYTES:
        return full_chi2_chunked(p, state)
    h = p.f // 2
    conv = cv.convolve_cube(state.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    resid = p.data_pad[:, h : h + p.Y, h : h + p.X] - conv
    w = p.w_pad[:, h : h + p.Y, h : h + p.X]
    return torch.sum(resid * resid * w, dtype=torch.float32)


def full_chi2_chunked(problem: Problem, state: SamplerState,
                      chunk: int = 256) -> torch.Tensor:
    """From-scratch χ² with bounded transients (the JAX package's
    ``full_chi2_chunked``): the arithmetic of the monolithic
    :func:`full_chi2` — the "same"-padded LSF conv as ``l`` shifted
    multiply-adds, then the per-plane FSF conv of the output wavelength —
    over chunks of ``chunk`` output planes.  The clean cube is zero-padded
    by lw//2 planes on the λ axis once (one cube copy), so plane lo + s of
    the pad is clean plane lo + s − lw//2 and the edges are the monolithic
    path's.  Each chunk's float32 sum is added in float64."""
    p = problem
    h, lw = p.f // 2, int(p.lsf.shape[1])
    chunk = max(1, min(int(chunk), p.L))
    clean = state.clean[:, : p.Y, : p.X]
    padl = torch.nn.functional.pad(clean, (0, 0, 0, 0, lw // 2, lw // 2))
    lsf, fsf = p.lsf.to(clean.dtype), p.fsf.to(clean.dtype)
    spatial = (cv.apply_fsf if cv.resolve_spatial("auto") == "fft"
               else cv.apply_fsf_direct)
    total = torch.zeros((), dtype=torch.float64, device=clean.device)
    for lo in range(0, p.L, chunk):
        n = min(chunk, p.L - lo)
        slab = padl[lo : lo + n + lw - 1]
        lrows = lsf.expand(n, lw) if lsf.shape[0] == 1 else lsf[lo : lo + n]
        out = torch.zeros((n, p.Y, p.X), dtype=clean.dtype,
                          device=clean.device)
        for d in range(lw):
            out = out + lrows[:, d, None, None] * slab[d : d + n]
        conv = spatial(out, fsf if fsf.shape[0] == 1 else fsf[lo : lo + n])
        del out
        resid = p.data_pad[lo : lo + n, h : h + p.Y, h : h + p.X] - conv
        w = p.w_pad[lo : lo + n, h : h + p.Y, h : h + p.X]
        total += torch.sum(resid * resid * w, dtype=torch.float32)
    return total.to(torch.float32)


def posterior_mean(problem: Problem, state: SamplerState) -> torch.Tensor:
    """Posterior-mean clean cube [L, Y, X] from the accumulators."""
    p = problem
    mean = state.sum_clean / torch.clamp(state.n_kept, min=1.0)
    return mean[:, : p.Y, : p.X]


def posterior_std(problem: Problem, state: SamplerState) -> torch.Tensor:
    p = problem
    if not p.config.track_variance:
        raise ValueError(
            "posterior std unavailable: the run used track_variance=False"
        )
    n = torch.clamp(state.n_kept, min=1.0)
    mean = state.sum_clean / n
    var = torch.clamp(state.sum_sq / n - mean * mean, min=0.0)
    return torch.sqrt(var)[:, : p.Y, : p.X]
