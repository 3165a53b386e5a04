"""Direct (exact) Gaussian posterior draws and the MAP — ``sampler='direct'``.

Counterpart of ``deconv3d_tpu/ops/direct.py``.  The model is linear and
Gaussian, d = K c + ε with ε ~ N(0, diag(1/w)), so the posterior of the
free voxels under the ridge prior c ~ N(0, τ⁻¹ I) (τ = 0: the flat prior)
is exactly N(A⁻¹ Kᵀ W d, A⁻¹) with A = Kᵀ W K + τ I.  One draw is one
perturb-and-solve:

    b = Kᵀ (W d + √w · z) + √τ · z2,     z, z2 ~ N(0, I)
    c = A⁻¹ b                      ⇒     c ~ N(μ, A⁻¹) exactly,

the solve by preconditioned conjugate gradients (:func:`pcg`, a plain
torch loop with the JAX package's stop test and guarded α / β).  Every
product with A is two separable convolutions (LSF band, then a per-λ
FFT convolution with cached kernel spectra); TF32 stays off in each
(``convolve.no_tf32``): a float32 CG to 1e-6 does not survive it.

Preconditioner (:func:`make_preconditioner`).  In spatial Fourier space,
under a periodic model with the mean weight w̄, A splits over the rfft2
frequencies k into λ-banded SPD matrices Λ_k = w̄ Mᵀ diag(|F̂_k(λ)|²) M
+ τ_m I, factorised once by the banded Cholesky kernel and applied in
every CG iteration as rfft2 → banded solves → irfft2.  ``'banded'`` keeps
one factor per frequency; above :data:`BANDED_BYTES_BUDGET` of factors
(a full MUSE field) it switches to ``'banded_radial'``, one factor per
|k| bin (:data:`N_RADIAL_BINS` equal-count bins, the bin-mean power).
Both solve on ``ops/banded.py::banded_solve``: on a CUDA device one
launch of ``csrc/banded.cu``'s ``banded_solve_kernel`` for the real and
imaginary parts of every frequency, each column naming its factor — no
per-frequency copy of the binned factors and no sort-and-pad layout.
``'jacobi'`` is the structure-free fallback.  Masks and the zero-padded
boundary make the true A differ from the model, which costs iterations,
not correctness.

Draws take their normals from Philox (``ops/philox.py::cube_normals``:
z from streams 9/10, z2 from 11/12, keyed by the chain key and the
absolute sweep), so a segmented or resumed run draws the same numbers.

Not ported on purpose (TPU memory and compiler workarounds): the
host-loop programs (``_host_pcg_programs``, ``pcg_host``,
``pcg_host_batch``), the jitted and host ``posterior_mean`` variants,
the lean segment layout, ``_maybe_delete``, the jitted state builder and
the λ-chunked lean branch of ``_radial_apply``.  One plain PCG loop fits
an 80 GB card at a full MUSE field.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import convolve as cv
from .. import sampler as sm
from . import banded, philox

logger = logging.getLogger("deconv3d_tpu_torch")

#: τ/w̄ of :func:`suggest_prior_precision` and ``prior_precision='auto'``
AUTO_PRIOR_REL = 1e-4

#: the preconditioners' M-side ridge τ_m/w̄ of ``direct_precond_tau='auto'``
#: (the JAX package measured a stall below 1e-2, ``deconv3d_tpu/sampler.py``
#: ``RunConfig.direct_precond_tau``)
PRECOND_TAU_REL = 1e-2

#: per-frequency factor bytes above which ``'banded'`` becomes
#: ``'banded_radial'`` (a full MUSE field: 7.3 GB of float32 factors)
BANDED_BYTES_BUDGET = 2 * 2**30
#: |k| bins of the radial preconditioner
N_RADIAL_BINS = 256

#: λ-planes per chunk of the radial state's power accumulation
RADIAL_POWER_CHUNK = 256


# ---------------------------------------------------------------------------
# Geometry and knobs
# ---------------------------------------------------------------------------

def _free_mask(problem) -> torch.Tensor:
    """[1, Y, X] mask of the sampled (valid-spaxel) voxels."""
    p = problem
    return p.valid[: p.Y, : p.X].to(p.data_pad.dtype)[None]


def _w_in(problem) -> torch.Tensor:
    p = problem
    h = p.f // 2
    return p.w_pad[:, h : h + p.Y, h : h + p.X]


def _d_in(problem) -> torch.Tensor:
    p = problem
    h = p.f // 2
    return p.data_pad[:, h : h + p.Y, h : h + p.X]


def _wbar(w: torch.Tensor) -> torch.Tensor:
    """Mean weight over the voxels of nonzero weight."""
    return w.sum() / torch.clamp((w > 0).sum(), min=1).to(w.dtype)


def _tau(problem, override=None) -> float:
    """The ridge prior's precision: ``override`` or ``config.prior_precision``,
    a float (``make_problem`` and ``Run.map_estimate`` resolve ``'auto'``)."""
    t = problem.config.prior_precision if override is None else override
    if isinstance(t, str):
        raise ValueError(f"prior_precision must be a float here (make_problem "
                         f"and map_estimate resolve 'auto'), got {t!r}")
    t = float(t)
    if t < 0:
        raise ValueError(f"prior_precision must be >= 0, got {t}")
    return t


def _precond_tau(problem, tau: float) -> float:
    """The preconditioners' ridge τ_m = max(τ, ``direct_precond_tau``); a
    flat prior (τ = 0) keeps τ_m = 0.  Only M⁻¹ sees τ_m: the operator,
    and so the posterior and the MAP, keep τ.  ``make_problem`` resolves
    ``direct_precond_tau='auto'`` to a float."""
    if tau <= 0:
        return tau
    t = problem.config.direct_precond_tau
    if isinstance(t, str):
        raise ValueError(f"direct_precond_tau must be a float here "
                         f"(make_problem resolves 'auto'), got {t!r}")
    return max(tau, float(t))


def suggest_prior_precision(problem, rel: float = AUTO_PRIOR_REL) -> float:
    """Ridge strength τ = rel · w̄ for direct draws and MAP solves, w̄ the
    mean weight over the free voxels of nonzero weight.  τ > 0 is a model
    choice (a proper Gaussian prior, σ = (rel·w̄)^-1/2 per voxel: 100× the
    noise σ at the default): the flat-prior normal operator is
    near-singular along the blur-null modes, and τ relative to w̄ sets how
    many CG iterations a solve takes (the JAX package's measured table,
    ``deconv3d_tpu/ops/direct.py::suggest_prior_precision``)."""
    if rel <= 0:
        raise ValueError(f"rel must be > 0, got {rel}")
    w = (_w_in(problem) * _free_mask(problem)).to(torch.float32)
    n = torch.clamp((w > 0).sum(), min=1).to(torch.float32)
    return float(rel * w.sum() / n)


def _resolve_precond_mode(problem, mode: Optional[str] = None) -> str:
    """The effective preconditioner mode: ``'banded'`` becomes
    ``'banded_radial'`` above :data:`BANDED_BYTES_BUDGET` of factors."""
    p = problem
    if mode is None:
        mode = p.config.direct_precond
    if mode == "banded":
        itemsize = p.data_pad.element_size()
        lw = int(p.lsf.shape[1])
        dense_bytes = p.Y * (p.X // 2 + 1) * p.L * lw * itemsize
        if dense_bytes > BANDED_BYTES_BUDGET:
            logger.info(
                "dense banded preconditioner would need %.1f GB — using "
                "the radially-binned variant (%d bins)",
                dense_bytes / 2**30, _radial_bins(p))
            mode = "banded_radial"
    if mode not in ("banded", "banded_radial", "jacobi"):
        raise ValueError(f"unknown direct_precond {mode!r}")
    return mode


def _radial_bins(problem) -> int:
    n = int(problem.config.direct_radial_bins)
    if n < 1:
        raise ValueError(f"direct_radial_bins must be >= 1, got {n}")
    return n


# ---------------------------------------------------------------------------
# Forward operator and its adjoint
# ---------------------------------------------------------------------------

def _spatial(problem, r: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Per-λ 'same' convolution of ``r`` with ``bank`` on the path of
    ``direct_spatial`` ('auto': FFT, ``convolve.resolve_spatial``)."""
    fft = cv.resolve_spatial(problem.config.direct_spatial) == "fft"
    return (cv.apply_fsf if fft else cv.apply_fsf_direct)(r, bank)


def _quad_like(problem, w: torch.Tensor) -> torch.Tensor:
    """Σ_ab F[μ,a,b]² w[μ, y~, x~]: the FSF part of diag(A)."""
    return _spatial(problem, w, torch.flip(problem.fsf, dims=(-2, -1)) ** 2)


def _fsf_bank(problem, adjoint: bool, device) -> torch.Tensor:
    """The FSF bank (``adjoint``: spatially flipped) on ``device``, cached
    per problem."""
    p = problem
    return sm.cached(p, ("fsf_bank", adjoint, device), lambda: (
        torch.flip(p.fsf, dims=(-2, -1)) if adjoint else p.fsf).to(device))


def _fsf_spectrum(problem, adjoint: bool, height: int,
                  device) -> torch.Tensor:
    """rfft2 of the FSF bank (``adjoint``: spatially flipped) at the padded
    size of ``convolve.apply_fsf`` for ``height`` rows, on ``device``,
    cached per problem."""
    return sm.cached(problem, ("fsf_hat", adjoint, height, device),
                     lambda: torch.fft.rfft2(
                         _fsf_bank(problem, adjoint, device),
                         s=_fft_size(problem, height)))


def _fft_size(problem, height: Optional[int] = None) -> Tuple[int, int]:
    """The padded rfft2 size of a 'same' FSF convolution over ``height``
    rows (default: the field's Y)."""
    p = problem
    height = p.Y if height is None else height
    return (cv._next_fast_len(height + p.f - 1),
            cv._next_fast_len(p.X + p.f - 1))


def _fsf(problem, r: torch.Tensor, adjoint: bool = False,
         halo: int = 0) -> torch.Tensor:
    """Per-λ 'same' convolution of ``r`` ``[L, H, X]`` with the FSF (its
    flip for the adjoint): ``convolve.apply_fsf`` on the cached spectrum
    (``direct_spatial='fft'``, the 'auto' choice), or the grouped conv.
    ``halo``: ``r`` is a slab whose first and last ``halo`` rows only
    feed its middle rows (a shard's neighbours' rows, or zeros past the
    field's edges); the result is those middle H − 2·halo rows."""
    p = problem
    H = r.shape[1]
    if p.f == 1 or cv.resolve_spatial(p.config.direct_spatial) == "direct":
        return _spatial(p, r, _fsf_bank(p, adjoint, r.device))[
            :, halo : H - halo]
    s = _fft_size(p, H)
    h = p.f // 2
    full = torch.fft.irfft2(torch.fft.rfft2(r, s=s)
                            * _fsf_spectrum(p, adjoint, H, r.device), s=s)
    return full[:, h + halo : h + H - halo, h : h + p.X].to(r.dtype)


def _lsf_matrix(problem) -> Optional[torch.Tensor]:
    """The dense LSF matrix where ``convolve_cube`` takes it (L ≤ 2048),
    cached per problem; None above (the band loop)."""
    p = problem
    if p.L > 2048:
        return None
    return sm.cached(p, "lsf_matrix", lambda: torch.as_tensor(
        cv.lsf_matrix(p.lsf.cpu().numpy()), dtype=p.lsf.dtype,
        device=p.lsf.device))


def _lsf_T(x: torch.Tensor, lsf: torch.Tensor) -> torch.Tensor:
    """Mᵀ along the leading λ axis: out[l] = Σ_d lsf[l + half − d, d] ·
    x[l + half − d] (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, half, half))
    lsfp = torch.nn.functional.pad(lsf, (0, 0, half, half))
    out = torch.zeros_like(x)
    for d in range(lw):
        o = 2 * half - d
        out.addcmul_(lsfp[o : o + L, d, None, None], xp[o : o + L])
    return out


def lsf_apply(c: torch.Tensor, mat: Optional[torch.Tensor],
              lsf: torch.Tensor) -> torch.Tensor:
    """M c along the leading λ axis: the dense LSF matrix ``mat``
    (:func:`_lsf_matrix`), or the band loop when it is None."""
    return (cv.apply_lsf_matrix(c, mat) if mat is not None
            else cv.apply_lsf_banded(c, lsf))


def lsf_adjoint(s: torch.Tensor, mat: Optional[torch.Tensor],
                lsf: torch.Tensor) -> torch.Tensor:
    """Mᵀ s, the adjoint of :func:`lsf_apply`."""
    return (cv.apply_lsf_matrix(s, mat.T) if mat is not None
            else _lsf_T(s, lsf))


def apply_K(problem, c: torch.Tensor) -> torch.Tensor:
    """K c on ``[L, Y, X]``: the LSF band, then the per-λ FSF — the
    forward model of ``convolve.convolve_cube`` (``direct_spatial``)."""
    return _fsf(problem, lsf_apply(c, _lsf_matrix(problem), problem.lsf))


def apply_KT(problem, r: torch.Tensor) -> torch.Tensor:
    """Kᵀ r = Mᵀ (Sᵀ r): the spatial adjoint is the 'same' convolution with
    the flipped FSF (exact for odd kernels), Mᵀ the transposed LSF band."""
    return lsf_adjoint(_fsf(problem, r, adjoint=True), _lsf_matrix(problem),
                       problem.lsf)


def make_normal_operator(problem, prior_precision=None
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A(c) = P (Kᵀ W K + τ I) P c on the free subspace (P the free mask,
    τ ``prior_precision`` or the config's)."""
    w = _w_in(problem)
    free = _free_mask(problem)
    tau = _tau(problem, prior_precision)

    def A(c):
        out = apply_KT(problem, apply_K(problem, c * free) * w)
        if tau > 0:
            out = out + tau * c
        return out * free

    return A


# ---------------------------------------------------------------------------
# Fourier-banded preconditioner
# ---------------------------------------------------------------------------

def _diag_scale_map(problem, tau: float) -> torch.Tensor:
    """Boundary- and mask-aware symmetric scaling s [1, Y, X] of the Fourier
    preconditioners (``direct_precond_scale``): M⁻¹ = s ⊙ C⁻¹(s ⊙ ·) with
    s = √(diag(C)/diag(A)), the λ-mean of the ratio, clipped to [1, 32]."""
    p = problem
    w = _w_in(p)
    wbar = _wbar(w)
    quad_local = torch.mean(_quad_like(p, w), dim=0)
    quad_circ = wbar * torch.mean(torch.sum(p.fsf ** 2, dim=(1, 2)))
    ratio = (quad_circ + tau) / torch.clamp(quad_local + tau, min=1e-30)
    return torch.sqrt(torch.clamp(ratio, 1.0, 32.0)).to(w.dtype)[None]


def radial_bins(Y: int, X: int, n_bins: int) -> Tuple[int, np.ndarray,
                                                      np.ndarray]:
    """(B, bin of every rfft2 frequency [Y·(X//2+1)], frequencies per bin):
    equal-count quantile bins on |k|², frequencies in stable |k|² order
    (the bin assignment of the JAX package's ``_radial_layout``)."""
    K = Y * (X // 2 + 1)
    B = min(n_bins, K)
    ky = np.fft.fftfreq(Y)
    kx = np.fft.rfftfreq(X)
    r2 = (ky[:, None] ** 2 + kx[None, :] ** 2).ravel()
    order = np.argsort(r2, kind="stable")
    bins = np.empty(K, np.int64)
    bins[order] = np.arange(K, dtype=np.int64) * B // K
    return B, bins, np.bincount(bins, minlength=B).astype(np.float64)


def _factor(problem, q: torch.Tensor, tau: float) -> torch.Tensor:
    """Upper banded Cholesky ``[n, L, lw]`` of wbar-scaled power rows ``q``
    ``[n, L]``: Λ = Mᵀ diag(q) M + (ridge + τ) I, the ridge 1e-8 of the
    stiffest diagonal (keeps near-null frequencies factorisable)."""
    bands = banded.precision_bands(problem.lsf, q)
    ridge = 1e-8 * bands[..., 0].max()
    bands[..., 0] += ridge + tau
    return banded.cholesky_banded(bands.contiguous())


def _column_factors(problem, fidx_freq: np.ndarray) -> torch.Tensor:
    """int32 factor index of every column of the real view of an rfft2
    cube: frequency j's real and imaginary parts are columns 2j, 2j + 1."""
    return torch.as_tensor(np.repeat(fidx_freq, 2).astype(np.int32),
                           device=problem.device)


@dataclasses.dataclass(frozen=True)
class PrecondState:
    """M⁻¹'s constants for a resolved mode: the Jacobi diagonal, or the
    banded factors ``R`` ``[n_factors, L, lw]`` with the factor index of
    every real-view column; ``s_map`` under ``direct_precond_scale``."""

    mode: str
    diag: Optional[torch.Tensor] = None
    R: Optional[torch.Tensor] = None
    fidx: Optional[torch.Tensor] = None
    s_map: Optional[torch.Tensor] = None


def _precond_state(problem, mode: str, tau: float) -> PrecondState:
    """M⁻¹'s constants for the RESOLVED ``mode`` and the M-side ridge
    ``tau`` (:func:`_precond_tau`)."""
    p = problem
    w = _w_in(p)
    if mode == "jacobi":
        # diag(A) ≈ Σ_μ M[μ,λ]² (Σ_ab F[μ,a,b]² w): the qvox-like diagonal
        diag = banded.precision_diag(p.lsf, _quad_like(p, w)) + tau
        inv = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30),
                          torch.zeros_like(diag))
        return PrecondState(mode, diag=inv)
    Y, X, L = p.Y, p.X, p.L
    Xr = X // 2 + 1
    wbar = _wbar(w)
    if mode == "banded_radial":
        B, bins, counts = radial_bins(Y, X, _radial_bins(p))
        bin_idx = torch.as_tensor(bins, device=p.device)
        q = torch.zeros((B, L), dtype=w.dtype, device=p.device)
        for lo in range(0, L, RADIAL_POWER_CHUNK):
            fhat = torch.fft.rfft2(p.fsf[lo : lo + RADIAL_POWER_CHUNK],
                                   s=(Y, X))
            power = (fhat.abs() ** 2).to(w.dtype).reshape(fhat.shape[0], -1)
            q[:, lo : lo + power.shape[0]] = torch.zeros(
                (B, power.shape[0]), dtype=w.dtype,
                device=p.device).index_add_(0, bin_idx, power.T)
        q = q / torch.as_tensor(counts, dtype=w.dtype,
                                device=p.device)[:, None] * wbar
        R, fidx = _factor(p, q, tau), _column_factors(p, bins)
    else:
        fhat = torch.fft.rfft2(p.fsf, s=(Y, X))                  # [L, Y, Xr]
        q = ((fhat.abs() ** 2).to(w.dtype) * wbar).reshape(L, Y * Xr).T
        R = _factor(p, q.contiguous(), tau)
        fidx = _column_factors(p, np.arange(Y * Xr))
    s_map = _diag_scale_map(p, tau) if p.config.direct_precond_scale else None
    return PrecondState(mode, R=R, fidx=fidx, s_map=s_map)


def _precond_apply(problem, state: PrecondState,
                   r: torch.Tensor) -> torch.Tensor:
    """M⁻¹ r for ``state`` (:func:`_precond_state`)."""
    p = problem
    free = _free_mask(p)
    if state.mode == "jacobi":
        return r * state.diag * free
    if state.s_map is not None:
        r = state.s_map * r
    rf = torch.fft.rfft2(r)                                      # [L, Y, Xr]
    cols = torch.view_as_real(rf).reshape(p.L, -1)   # [L, Y·Xr·2], λ-major
    banded.banded_solve(state.R, state.fidx, cols, out=cols)
    out = torch.fft.irfft2(rf, s=(p.Y, p.X)).to(r.dtype)
    if state.s_map is not None:
        out = state.s_map * out
    return out * free


def make_preconditioner(problem, mode: Optional[str] = None,
                        prior_precision=None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """M⁻¹ ≈ A⁻¹ (``'banded'``, ``'banded_radial'`` or ``'jacobi'``; the
    mode resolves by :func:`_resolve_precond_mode`).  The M-side ridge
    τ_m (:func:`_precond_tau`) enters every mode on the λ-band diagonal
    (the prior is diagonal in any orthonormal basis) or the Jacobi
    diagonal.  The constants are built once per problem, mode and τ_m."""
    p = problem
    mode = _resolve_precond_mode(p, mode)
    state = precond_state(p, mode, _precond_tau(p, _tau(p, prior_precision)))
    return lambda r: _precond_apply(p, state, r)


def precond_state(problem, mode: str, tau_m: float) -> PrecondState:
    """:func:`_precond_state`, built once per problem, resolved mode and
    M-side ridge."""
    return sm.cached(problem, ("precond", mode, tau_m),
                     lambda: _precond_state(problem, mode, tau_m))


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------

class PCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    rel_residual: float


class VectorOps:
    """:func:`pcg`'s vector operations on one tensor: ``map`` applies a
    function to the vectors' tensors, ``dot`` gives a 0-d tensor, ``norm``
    a float, ``axpy`` is y += value · s · v in place (``s`` 0-d, on the
    first tensor's device).  A sharded solve passes its own
    (``parallel/direct_sharded.py::ShardOps``, a vector = the slots'
    tensors)."""

    @staticmethod
    def map(fn, *vecs):
        return fn(*vecs)

    @staticmethod
    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a.reshape(-1), b.reshape(-1))

    @staticmethod
    def norm(a: torch.Tensor) -> float:
        return float(torch.linalg.vector_norm(a))

    @staticmethod
    def axpy(y: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
             value: float = 1.0) -> torch.Tensor:
        return y.addcmul_(v, s, value=value)

    def dot_norm(self, a, b):
        """(a·b, ‖a‖) — one exchange where the vectors span ranks."""
        return self.dot(a, b), self.norm(a)


LOCAL = VectorOps()


def pcg(A, Minv, b, tol: float, maxiter: int,
        ops: VectorOps = LOCAL) -> PCGResult:
    """Preconditioned CG for SPD ``A`` from x = 0: the JAX package's loop
    (stop when ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations; α = 0 where
    pᵀAp ≤ 0, β = 0 where rᵀz ≤ 0).  The carried vectors update in place;
    the stop test reads ‖r‖ on the host once per iteration.  ``ops``: the
    vector operations (:class:`VectorOps`), so that the sharded solve runs
    this same body on its slots' tensors."""
    bnorm = max(ops.norm(b), 1e-30)
    x = ops.map(torch.zeros_like, b)
    r = ops.map(torch.clone, b)
    z = Minv(r)
    rz, rnorm = ops.dot_norm(r, z)
    pvec = z
    it = 0
    zero = torch.zeros_like(rz)
    while it < maxiter and rnorm > tol * bnorm:
        Ap = A(pvec)
        denom = ops.dot(pvec, Ap)
        alpha = torch.where(denom <= 0, zero,
                            rz / torch.clamp(denom, min=1e-30))
        ops.axpy(x, alpha, pvec)
        ops.axpy(r, alpha, Ap, -1.0)
        del Ap
        z = Minv(r)
        rz_new, rnorm = ops.dot_norm(r, z)
        beta = torch.where(rz <= 0, zero, rz_new / torch.clamp(rz, min=1e-30))
        pvec = ops.axpy(z, beta, pvec)
        rz = rz_new
        it += 1
    return PCGResult(x=x, iterations=it, rel_residual=rnorm / bnorm)


#: refinement rounds at most after a float32 solve (:func:`posterior_mean`)
MAX_REFINE = 4


def _float64(problem):
    """``problem`` with the operator's tensors in float64."""
    return dataclasses.replace(problem, **{
        n: getattr(problem, n).double()
        for n in ("fsf", "lsf", "data_pad", "w_pad")})


def posterior_mean(problem, tol=None, maxiter=None,
                   prior_precision=None) -> PCGResult:
    """μ = A⁻¹ Kᵀ W d, the MAP and posterior mean of the Gaussian model;
    ``prior_precision`` overrides the config's τ for this solve only (a
    ridge MAP of an MCMC run, ``Run.map_estimate``).

    The JAX package's PCG, then, for a float32 problem, iterative
    refinement against the float64 residual: a float32 product with A
    carries the rounding of its largest terms, and under heavy blur the
    solution's blur-null modes dwarf the data, so the float32 recurrence
    can reach ``tol`` while b − A x in float64 has not.  The solve measures
    that residual and, above ``tol``, solves for the correction on the
    same operator and measures again (at most :data:`MAX_REFINE` rounds,
    within ``maxiter`` iterations in all).  ``rel_residual`` is then the float64 one of the
    returned x."""
    p = problem
    cfg = p.config
    tol = cfg.direct_tol if tol is None else tol
    maxiter = cfg.direct_maxiter if maxiter is None else maxiter

    def make64():
        p64 = _float64(p)
        return (make_normal_operator(p64, prior_precision),
                apply_KT(p64, _d_in(p64) * _w_in(p64)) * _free_mask(p64))

    with cv.no_tf32():
        A = make_normal_operator(p, prior_precision)
        M = make_preconditioner(p, prior_precision=prior_precision)
        res = pcg(A, M, apply_KT(p, _d_in(p) * _w_in(p)) * _free_mask(p),
                  tol, maxiter)
        if p.data_pad.dtype == torch.float64:
            return res
        return refine(A, M, res, make64, tol, maxiter)


def refine(A, M, res: PCGResult, make64, tol: float, maxiter: int,
           ops: VectorOps = LOCAL) -> PCGResult:
    """The refinement of :func:`posterior_mean` after the float32 solve
    ``res`` of ``A x = b``: ``make64()`` = (A64, b64), the operator and
    right-hand side in float64; while ‖b64 − A64 x‖ exceeds ``tol``·‖b64‖,
    a correction solve on ``A`` (at most :data:`MAX_REFINE` rounds,
    ``maxiter`` iterations in all)."""
    A64, b64 = make64()
    bnorm = max(ops.norm(b64), 1e-30)
    x, it, rounds = res.x, res.iterations, 0
    while True:
        r64 = ops.map(torch.sub, b64, A64(ops.map(torch.Tensor.double, x)))
        rnorm = ops.norm(r64)
        if rnorm <= tol * bnorm or it >= maxiter or rounds == MAX_REFINE:
            break
        corr = pcg(A, M, ops.map(lambda r_, x_: r_.to(x_.dtype), r64, x),
                   tol * bnorm / rnorm, maxiter - it, ops)
        x, it, rounds = (ops.map(torch.add, x, corr.x),
                         it + corr.iterations, rounds + 1)
    return PCGResult(x=x, iterations=it, rel_residual=rnorm / bnorm)


# ---------------------------------------------------------------------------
# Posterior draws: the run_sweeps contract
# ---------------------------------------------------------------------------

def draw_rhs(problem, key: int, sweep: int, z=None, z2=None) -> torch.Tensor:
    """Perturbed right-hand side of the draw at absolute sweep ``sweep``:
    b = Kᵀ(W d + √w z) + √τ z2 on the free voxels, the normals from Philox
    (``philox.cube_normals``, streams 9/10 and 11/12 under ``key``) unless
    ``z`` / ``z2`` ``[L, Y, X]`` are given.  Cov(b) = A, so A⁻¹b is an
    exact draw."""
    p = problem
    w = _w_in(p)
    free = _free_mask(p)
    dt, dev = w.dtype, p.device
    tau = _tau(p)
    if z is None:
        z = philox.cube_normals(key, sweep, (philox.STREAM_DRAW_U1,
                                             philox.STREAM_DRAW_U2),
                                p.L, p.Y, p.X, dev, dt)
    b = apply_KT(p, _d_in(p) * w + torch.sqrt(w) * z.to(dev, dt)) * free
    if tau > 0:
        if z2 is None:
            z2 = philox.cube_normals(key, sweep, (philox.STREAM_PRIOR_U1,
                                                  philox.STREAM_PRIOR_U2),
                                     p.L, p.Y, p.X, dev, dt)
        b = b + float(np.sqrt(tau)) * z2.to(dev, dt) * free
    return b


def _local_draw(problem):
    """The draw of :func:`direct_run_sweeps` on one device: ``draw(key,
    sweep, z, z2)`` → (PCGResult, K x, None: χ² from the residual)."""
    p = problem
    cfg = p.config
    A = make_normal_operator(p)
    Minv = make_preconditioner(p)

    def draw(key, sweep, z, z2):
        res = pcg(A, Minv, draw_rhs(p, key, sweep, z, z2), cfg.direct_tol,
                  cfg.direct_maxiter)
        return res, apply_K(p, res.x), None

    return draw


def _draws(problem, state, n_sweeps: int, normals, draw):
    """One chain's ``n_sweeps`` draws (``state`` unbatched), each solved by
    ``draw`` (:func:`_local_draw`, or the sharded one)."""
    p = problem
    cfg = p.config
    h = p.f // 2
    dt = p.data_pad.dtype
    free = _free_mask(p)
    n_free = float(free.sum()) * p.L
    validf = p.valid.to(dt)
    key = int(state.key)
    sweep0 = int(state.sweep)
    ids = torch.arange(sweep0, sweep0 + n_sweeps)
    keep = sm.keep_schedule(ids, cfg).tolist()
    st = state
    chi2_t, acc_t, flux_t, mon_t = [], [], [], []
    for i in range(n_sweeps):
        z, z2 = (None, None) if normals is None else (
            normals[0][i], None if normals[1] is None else normals[1][i])
        res, kx, chi2 = draw(key, sweep0 + i, z, z2)
        clean = torch.zeros((p.L, p.Yc, p.Xc), dtype=dt, device=p.device)
        clean[:, : p.Y, : p.X] = res.x
        resid = p.data_pad.clone()
        resid[:, h : h + p.Y, h : h + p.X] -= kx
        del kx
        resid = torch.where(p.w_pad > 0, resid, torch.zeros((), dtype=dt,
                                                            device=p.device))
        if chi2 is None:
            chi2 = torch.sum(resid * resid * p.w_pad, dtype=torch.float32)
        kc = keep[i]
        st = dataclasses.replace(
            st, clean=clean, resid=resid, chi2=chi2,
            chi2_comp=torch.zeros_like(st.chi2_comp),
            n_accept=st.n_accept + n_free, n_propose=st.n_propose + n_free,
            sum_clean=st.sum_clean + kc * clean,
            sum_sq=(st.sum_sq + kc * clean * clean if cfg.track_variance
                    else st.sum_sq),
            n_kept=st.n_kept + kc, sweep=st.sweep + 1)
        chi2_t.append(chi2)
        # the "acceptance" of a draw: its solve's convergence flag
        acc_t.append(float(res.rel_residual <= cfg.direct_tol))
        flux_t.append(torch.sum(clean * validf[None], dtype=torch.float32))
        mon_t.append(clean.reshape(-1)[p.monitor_idx])
    dev = p.device
    return sm.ChainResult(
        state=st,
        chi2_trace=torch.stack(chi2_t) if chi2_t
        else torch.zeros((0,), dtype=torch.float32, device=dev),
        accept_trace=torch.tensor(acc_t, dtype=torch.float32, device=dev),
        flux_trace=torch.stack(flux_t) if flux_t
        else torch.zeros((0,), dtype=torch.float32, device=dev),
        monitor_trace=torch.stack(mon_t) if mon_t
        else torch.zeros((0, p.monitor_idx.shape[0]), dtype=dt, device=dev),
    )


def direct_run_sweeps(problem, state, n_sweeps: int, normals=None):
    """``run_sweeps`` of ``sampler='direct'`` (the ChainResult contract):
    one sweep is one independent draw.  The state threads as in the MCMC
    engines: ``clean`` is the last draw, ``resid`` = data − K·clean
    recomputed from scratch (so χ² is the from-scratch one), the key and
    log-scales unchanged, ``n_accept`` and ``n_propose`` raised by the
    free voxels, the accumulators fed after burn-in (0 by default).  The
    accept trace carries each solve's convergence flag.

    ``state`` is one chain's or a chain-stacked batch; each chain draws
    alone under its own key, so it is the same in any batch.  ``normals``
    = (z, z2) ``[n_sweeps, (C,) L, Y, X]`` (z2 may be None) replaces the
    Philox normals."""
    with cv.no_tf32():
        return run_draws(problem, state, n_sweeps, normals,
                         _local_draw(problem))


def run_draws(problem, state, n_sweeps: int, normals, draw):
    """:func:`direct_run_sweeps` with each draw's solve by ``draw(key,
    sweep, z, z2)`` → (PCGResult with x ``[L, Y, X]``, K x, χ² or None),
    every chain of a chain-stacked ``state`` alone."""
    from .. import chains as ch

    if state.clean.dim() == 3:
        return _draws(problem, state, n_sweeps, normals, draw)
    results = []
    for c in range(state.clean.shape[0]):
        nc = None if normals is None else tuple(
            None if t is None else t[:, c] for t in normals)
        results.append(_draws(problem, ch.select_chains(state, c),
                              n_sweeps, nc, draw))
    return ch.stack_chains(results)


def draw_bytes(problem) -> int:
    """Device bytes one draw's solve needs beyond the problem and the
    chains' states: the six PCG vectors, the rfft2 cube of the
    preconditioner and the FFT convolution's transients (padded complex
    spectra and the padded real result), at the working precision."""
    p = problem
    item = p.data_pad.element_size()
    cube = p.L * p.Y * p.X * item
    py, px = _fft_size(p)
    padded = p.L * py * (px // 2 + 1) * 2 * item
    return 6 * cube + 2 * cube + 3 * padded
