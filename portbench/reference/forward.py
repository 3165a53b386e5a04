"""The separable forward model, written as plain sums.

    model[μ] = F[μ] ⊛ (Σ_d lsf[μ, d] · clean[μ + d − lw//2])

the spectral LSF first, then the spatial FSF of the output wavelength as a
true 2-D convolution, each with the cube embedded in zeros ("same").  The
spatial stage is f² shifted multiply-adds and the spectral one lw, over
blocks of λ-planes, in whatever dtype the inputs come in: float64 for the
reference, bfloat16 for the control that stands in for a program working
one precision below float32.  ``quad`` (Σ F² w over each spaxel's
footprint) and ``qvox`` (one voxel's conditional precision, Σ_μ M[μ,λ]²
quad[μ]) follow the sampler's documented definitions.
"""

from __future__ import annotations

import torch

#: λ-planes per block: bounds the temporaries at the full MUSE field
BLOCK = 128


def lsf_rows(clean: torch.Tensor, lsf: torch.Tensor, lo: int, hi: int,
             base: int = 0) -> torch.Tensor:
    """Σ_d lsf[μ, d] · clean[..., μ + d − lw//2, :, :] for μ in [lo, hi),
    planes outside [0, L) taken as zero; ``clean`` ``[..., n, Y, X]``
    holds planes [base, base + n) of the cube, at least those the rows
    reach, and L = ``lsf.shape[0]``."""
    L, lw = lsf.shape
    half = lw // 2
    out = torch.zeros(clean.shape[:-3] + (hi - lo,) + clean.shape[-2:],
                      dtype=clean.dtype, device=clean.device)
    for d in range(lw):
        a, b = max(lo, half - d), min(hi, L + half - d)
        if a >= b:
            continue
        coef = lsf[a:b, d].reshape(-1, 1, 1)
        src = clean[..., a + d - half - base:b + d - half - base, :, :]
        out[..., a - lo:b - lo, :, :].addcmul_(coef, src)
    return out


def fsf_same(x: torch.Tensor, fsf: torch.Tensor) -> torch.Tensor:
    """True 2-D convolution of each plane of ``x`` ``[..., n, Y, X]`` with
    its kernel ``fsf`` ``[n, f, f]``, zero-padded, output the size of x."""
    f = fsf.shape[-1]
    h = f // 2
    Y, X = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (h, h, h, h))
    out = torch.zeros_like(x)
    for a in range(f):
        for b in range(f):
            coef = fsf[:, f - 1 - a, f - 1 - b].reshape(-1, 1, 1)
            out.addcmul_(coef, xp[..., a:a + Y, b:b + X])
    return out


def reach(lo: int, hi: int, lw: int, L: int):
    """The clean planes [a, b) that model planes [lo, hi) read."""
    return max(0, lo - lw // 2), min(L, hi + lw // 2)


def model_block(clean: torch.Tensor, fsf: torch.Tensor, lsf: torch.Tensor,
                lo: int, hi: int, base: int = 0) -> torch.Tensor:
    """Planes [lo, hi) of the forward model of ``clean`` ``[..., n, Y, X]``
    (planes [base, base + n) of the cube, as :func:`lsf_rows`)."""
    return fsf_same(lsf_rows(clean, lsf, lo, hi, base), fsf[lo:hi])


def quad_block(w_pad: torch.Tensor, fsf: torch.Tensor, lo: int, hi: int
               ) -> torch.Tensor:
    """Planes [lo, hi) of quad[λ, y, x] = Σ_{a,b} F[λ,a,b]² w_pad[λ, y+a,
    x+b] over the padded weights ``[L, Yc + f − 1, Xc + f − 1]``."""
    f = fsf.shape[-1]
    Yc, Xc = w_pad.shape[1] - f + 1, w_pad.shape[2] - f + 1
    w = w_pad[lo:hi]
    f2 = fsf[lo:hi] ** 2
    out = torch.zeros((hi - lo, Yc, Xc), dtype=w.dtype, device=w.device)
    for a in range(f):
        for b in range(f):
            out.addcmul_(f2[:, a, b].reshape(-1, 1, 1),
                         w[:, a:a + Yc, b:b + Xc])
    return out


def qvox_block(quad: torch.Tensor, lsf: torch.Tensor, lo: int, hi: int
               ) -> torch.Tensor:
    """Planes [lo, hi) of qvox[λ] = Σ_μ M[μ, λ]² quad[μ], M[μ, μ + d −
    lw//2] = lsf[μ, d]: the precision of one voxel's conditional."""
    L, lw = quad.shape[0], lsf.shape[1]
    half = lw // 2
    out = torch.zeros((hi - lo,) + quad.shape[1:], dtype=quad.dtype,
                      device=quad.device)
    for d in range(lw):
        # λ = μ + d − half  ⇔  μ = λ − d + half
        a, b = max(lo, d - half), min(hi, L + d - half)
        if a >= b:
            continue
        mu = slice(a - d + half, b - d + half)
        out[a - lo:b - lo].addcmul_((lsf[mu, d] ** 2).reshape(-1, 1, 1),
                                     quad[mu])
    return out


def blocks(L: int, block: int = BLOCK):
    """[lo, hi) ranges of at most ``block`` planes covering [0, L)."""
    return [(lo, min(L, lo + block)) for lo in range(0, L, block)]
