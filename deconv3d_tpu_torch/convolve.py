"""Separable 3-D instrument convolution — the forward model, in torch.

PyTorch counterpart of ``deconv3d_tpu/convolve.py``.  Canonical model:
spectral LSF first, then per-plane spatial FSF of the *output* wavelength:

    conv[mu] = FSF[mu] (*)2D ( Σ_d  lsf[mu, d] · clean[mu + d - l//2] )

Boundary semantics are zero-padded "same" everywhere (the cube embedded in
zeros) — exactly what the sampler's incremental patch updates assume.

Spatial implementations: ``apply_fsf`` (batched rFFT2 via ``torch.fft``) and
``apply_fsf_direct`` (grouped ``conv2d``).  ``spatial='auto'`` resolves to
``'fft'`` on every device this package runs on: cuFFT and the CPU FFT are
full float32 (the JAX package picks the direct conv only on a TPU, whose
non-power-of-two FFTs run at reduced precision).  Spectral implementations:
``lsf_matrix`` + matmul, and ``apply_lsf_banded`` (``l`` shifted
multiply-adds, memory-light for full-field L ≈ 3681).

Every convolution and matmul here runs under :func:`no_tf32`: cuDNN runs
float32 convolutions in TF32 by default on the card (about three decimal
digits), which would break the 1e-5 running-vs-from-scratch chi² check.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Full-float32 cuDNN convolutions and CUDA matmuls inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Spectral stage (LSF)
# ---------------------------------------------------------------------------

def lsf_matrix(lsf_bank: np.ndarray) -> np.ndarray:
    """Dense banded convolution matrix ``M[mu, lam]`` from an LSF bank.

    ``out = M @ in`` along the spectral axis, zero-padded "same" semantics.
    Built host-side in float64.
    """
    lsf_bank = np.asarray(lsf_bank, dtype=np.float64)
    nl, width = lsf_bank.shape
    half = width // 2
    mat = np.zeros((nl, nl), dtype=np.float64)
    mu = np.arange(nl)
    for d in range(width):
        lam = mu + (d - half)
        ok = (lam >= 0) & (lam < nl)
        mat[mu[ok], lam[ok]] += lsf_bank[mu[ok], d]
    return mat


def apply_lsf_matrix(data: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Spectral convolution as a dense matmul."""
    nl = data.shape[0]
    with no_tf32():
        return (mat @ data.reshape(nl, -1)).reshape(data.shape)


def apply_lsf_banded(data: torch.Tensor, lsf_bank: torch.Tensor) -> torch.Tensor:
    """Spectral convolution as ``l`` shifted multiply-adds (memory path)."""
    nl = data.shape[0]
    width = lsf_bank.shape[1]
    half = width // 2
    padded = F.pad(data, (0, 0, 0, 0, half, half))
    out = torch.zeros_like(data)
    for d in range(width):
        out = out + lsf_bank[:, d, None, None] * padded[d : d + nl]
    return out


# ---------------------------------------------------------------------------
# Spatial stage (FSF)
# ---------------------------------------------------------------------------

def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer ≥ n (good FFT sizes on every backend)."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def apply_fsf(data: torch.Tensor, fsf_bank: torch.Tensor) -> torch.Tensor:
    """Per-λ-plane 2-D convolution via batched rFFT2 (zero-padded "same").

    ``fsf_bank`` is ``[L, f, f]`` (λ-dependent) or ``[1, f, f]`` / ``[f, f]``
    (shared kernel, broadcast over planes).
    """
    if fsf_bank.ndim == 2:
        fsf_bank = fsf_bank[None]
    nl, ny, nx = data.shape
    f = fsf_bank.shape[-1]
    if f == 1:
        return data * fsf_bank[..., 0, 0][:, None, None]
    half = f // 2
    py = _next_fast_len(ny + f - 1)
    px = _next_fast_len(nx + f - 1)
    dataf = torch.fft.rfft2(data, s=(py, px))
    kernf = torch.fft.rfft2(fsf_bank, s=(py, px))
    full = torch.fft.irfft2(dataf * kernf, s=(py, px))
    return full[:, half : half + ny, half : half + nx].to(data.dtype)


def apply_fsf_direct(data: torch.Tensor, fsf_bank: torch.Tensor) -> torch.Tensor:
    """Per-λ-plane 2-D convolution as a grouped ``conv2d``.

    λ-planes become channels with ``groups = L``.  ``conv2d`` computes a
    cross-correlation, so the kernel is flipped to keep true convolution
    semantics (as the JAX package does before its ``lax.conv``).
    """
    if fsf_bank.ndim == 2:
        fsf_bank = fsf_bank[None]
    nl = data.shape[0]
    if fsf_bank.shape[0] == 1:
        fsf_bank = fsf_bank.expand((nl,) + tuple(fsf_bank.shape[1:]))
    kern = torch.flip(fsf_bank, dims=(-2, -1))[:, None].to(data.dtype)
    with no_tf32():
        out = F.conv2d(
            data[None], kern, padding=fsf_bank.shape[-1] // 2, groups=nl
        )
    return out[0]


# ---------------------------------------------------------------------------
# Full separable forward model
# ---------------------------------------------------------------------------

def resolve_spatial(spatial: str = "auto") -> str:
    """Resolve the ``spatial='auto'`` rule in ONE place: ``'fft'``."""
    if spatial == "auto":
        return "fft"
    if spatial not in ("fft", "direct"):
        raise ValueError(f"unknown spatial {spatial!r}")
    return spatial


def convolve_cube(
    clean: torch.Tensor,
    fsf_bank,
    lsf_bank,
    lsf_mat: Optional[torch.Tensor] = None,
    spatial: str = "auto",
    spectral: str = "auto",
    order: str = "lsf_first",
) -> torch.Tensor:
    """Separable instrument convolution of a clean cube ``[L, Y, X]``.

    ``order='lsf_first'`` is the package-canonical model; ``'fsf_first'``
    reproduces the reference's stage order (the two differ only for
    λ-dependent FSFs).  The banks may be NumPy arrays or tensors; they are
    cast to the cube's dtype and device.
    """
    fsf_bank = torch.as_tensor(fsf_bank).to(clean.device, clean.dtype)
    lsf_bank = torch.as_tensor(lsf_bank).to(clean.device, clean.dtype)
    spatial = resolve_spatial(spatial)
    spatial_fn = apply_fsf if spatial == "fft" else apply_fsf_direct
    if spectral == "auto":
        spectral = (
            "matrix" if (lsf_mat is not None or clean.shape[0] <= 2048)
            else "banded"
        )
    if spectral == "matrix":
        mat = lsf_mat
        if mat is None:
            mat = torch.as_tensor(lsf_matrix(lsf_bank.cpu().numpy()))
        mat = mat.to(clean.device, clean.dtype)
        spectral_fn = lambda x: apply_lsf_matrix(x, mat)  # noqa: E731
    elif spectral == "banded":
        spectral_fn = lambda x: apply_lsf_banded(x, lsf_bank)  # noqa: E731
    else:
        raise ValueError(f"unknown spectral {spectral!r}")

    if order == "lsf_first":
        return spatial_fn(spectral_fn(clean), fsf_bank)
    if order == "fsf_first":
        return spectral_fn(spatial_fn(clean, fsf_bank))
    raise ValueError(f"unknown order {order!r}")
