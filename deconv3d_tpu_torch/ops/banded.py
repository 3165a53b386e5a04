"""Diagonal of the banded spectral precision, for the exact-Gibbs sampler.

Counterpart of ``precision_diag`` in ``deconv3d_tpu/ops/banded.py``.  The
conditional precision of one voxel (λ, y, x) under the separable model is
``qvox[λ] = Σ_μ M[μ, λ]² · quad[μ]``, with M the banded LSF matrix
(``M[μ, μ + d − half] = lsf[μ, d]``) and ``quad[μ] = Σ F²[μ] w`` the
per-spaxel quadratic weight (``sampler.Problem.quad``).  The banded
Cholesky machinery of the JAX module belongs to ``sampler='gibbs_block'``,
which is not ported yet.
"""

from __future__ import annotations

import torch


def precision_diag(lsf: torch.Tensor, q_lfirst: torch.Tensor) -> torch.Tensor:
    """diag(Mᵀ diag(q) M) for λ-leading ``q_lfirst`` ``[L, ...spatial]``:
    ``out[λ] = Σ_d lsf[λ + half − d, d]² · q[λ + half − d]`` (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    pads = (0, 0) * (q_lfirst.ndim - 1) + (lw, lw)
    qp = torch.nn.functional.pad(q_lfirst, pads)
    lsfp = torch.nn.functional.pad(lsf, (0, 0, lw, lw))
    out = torch.zeros_like(q_lfirst)
    shape = (L,) + (1,) * (q_lfirst.ndim - 1)
    for d in range(lw):
        off = lw + half - d
        col = (lsfp[off : off + L, d] ** 2).reshape(shape)
        out = out + col * qp[off : off + L]
    return out
