"""Low-rank (SVD) factorisation of wavelength-dependent FSF banks.

The Pallas fused-sweep kernel (ops/pallas_sweep.py) wants the per-color patch
contraction  Σ_{a,b} F[λ,a,b]·RW[λ, a, b]  as an MXU matmul.  A λ-dependent
bank makes that a batched-per-λ contraction — hostile to the MXU.  Writing
the bank as a short sum of separable modes

    F[λ, a, b] ≈ Σ_s  spec_s[λ] · img_s[a, b]        (S modes)

turns it into ONE [S, f²] × [f², ·] matmul plus a cheap per-λ combine.

For λ-independent kernels S = 1 *exactly* (single SVD mode).  For MUSE
chromatic Moffat/Gaussian banks the λ-dependence is smooth (FWHM linear or
quadratic in λ), so a handful of modes reaches ~1e-5 relative error.

The sampler then uses the *reconstruction* F̃ = Σ spec·img as its forward
model everywhere (quad term, full-cube init convolution, incremental deltas)
— the chain is exact for the F̃-model; the only approximation is F̃ vs F,
bounded by ``tol`` and fully under user control (SURVEY.md §7 "hard parts"
(2): λ-indexed kernels in VMEM).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def factor_bank(
    bank: np.ndarray, tol: float = 1e-5, max_rank: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """SVD-factor a [L, f, f] bank into (spec [S, L], imgs [S, f, f]).

    Returns (spec, imgs, reconstruction, relative_frobenius_error) where the
    rank S is the smallest achieving ``err ≤ tol`` (capped at ``max_rank``).
    """
    bank = np.asarray(bank, dtype=np.float64)
    L = bank.shape[0]
    f = bank.shape[-1]
    mat = bank.reshape(L, f * f)
    u, s, vt = np.linalg.svd(mat, full_matrices=False)
    total = float(np.sum(s**2))
    if total == 0.0:
        raise ValueError("FSF bank is all zeros")
    # smallest S with tail energy ≤ tol² (relative Frobenius)
    tail = np.sqrt(np.maximum(1.0 - np.cumsum(s**2) / total, 0.0))
    S = int(np.searchsorted(-tail, -tol) + 1)
    S = max(1, min(S, max_rank, len(s)))
    spec = u[:, :S].T * s[:S, None]          # [S, L]
    imgs = vt[:S].reshape(S, f, f)           # [S, f, f]
    recon = (spec.T @ vt[:S]).reshape(L, f, f)
    err = float(np.linalg.norm(recon - bank) / np.linalg.norm(bank))
    return spec, imgs, recon, err
