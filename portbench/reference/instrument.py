"""The instrument's kernel banks and the sweep engines' weights, from a
configuration file and the run's inputs alone.

Frozen copies of the formulas the sampler under test documents for its
MUSE instrument: the Moffat (or Gaussian) FSF rasterised on an f×f pixel
grid and normalised to unit sum per plane, the Gaussian LSF whose FWHM(λ)
follows the MUSE calibration polynomial (or a constant), normalised per
row, and the inverse-variance weights rounded to bfloat16 values, as the
sampler's kernel engines keep them.  Nothing here reads what the program
computed.
"""

from __future__ import annotations

import numpy as np
import torch

_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def wavelengths(config: dict) -> np.ndarray:
    """Wavelength (Å) of each spectral plane: crval + i·cdelt."""
    L = int(config["shape"][0])
    return float(config["crval"]) + np.arange(L, dtype=np.float64) * float(
        config["cdelt"])


def _fwhm_fsf(spec: dict, lam: np.ndarray) -> np.ndarray:
    """FSF FWHM(λ) in arcsec: fwhm + fwhm_slope·(λ − lambda_ref)."""
    slope = float(spec.get("fwhm_slope", 0.0))
    if slope == 0.0 or spec.get("lambda_ref") is None:
        return np.full(lam.shape, float(spec["fwhm"]))
    return float(spec["fwhm"]) + slope * (lam - float(spec["lambda_ref"]))


def fsf_bank(config: dict) -> np.ndarray:
    """``[L, f, f]`` float64, each plane summing to 1; f = ``fsf_size``."""
    spec, f = config["fsf"], int(config["fsf_size"])
    lam = wavelengths(config)
    half = f // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    r2 = (yy * yy + xx * xx)[None]
    fw = (_fwhm_fsf(spec, lam) / float(config["pixel_scale"]))[:, None, None]
    if spec["kind"] == "moffat":
        beta = float(spec["beta"])
        alpha = fw / (2.0 * np.sqrt(2.0 ** (1.0 / beta) - 1.0))
        kern = (1.0 + r2 / (alpha * alpha)) ** (-beta)
    elif spec["kind"] == "gaussian":
        sigma = fw * _FWHM_TO_SIGMA
        kern = np.exp(-0.5 * r2 / (sigma * sigma))
    else:
        raise ValueError(f"unknown FSF kind {spec['kind']!r}")
    return kern / kern.sum(axis=(1, 2), keepdims=True)


def lsf_bank(config: dict) -> np.ndarray:
    """``[L, lw]`` float64, each row summing to 1; row μ weighs input plane
    μ + d − lw//2 with entry d; lw = ``lsf_width``."""
    spec, lw = config["lsf"], int(config["lsf_width"])
    lam = wavelengths(config)
    if spec["kind"] == "muse":
        fwhm = (float(spec["c2"]) * lam * lam + float(spec["c1"]) * lam
                + float(spec["c0"]))
    elif spec["kind"] == "gaussian":
        fwhm = np.full(lam.shape, float(spec["fwhm"]))
    else:
        raise ValueError(f"unknown LSF kind {spec['kind']!r}")
    half = lw // 2
    offsets = np.arange(-half, half + 1, dtype=np.float64) * abs(
        float(config["cdelt"]))
    sigma = fwhm[:, None] * _FWHM_TO_SIGMA
    kern = np.exp(-0.5 * (offsets[None, :] / sigma) ** 2)
    return kern / kern.sum(axis=1, keepdims=True)


def weights(variance: torch.Tensor, data=None, mask=None) -> torch.Tensor:
    """1/variance where the variance is finite and positive, the datum is
    not NaN and the spaxel not masked (``mask`` ``[Y, X]``, True =
    excluded), else 0, rounded to the nearest bfloat16 value and held in
    the variance's dtype: the weights every sweep engine's χ² and Δχ²
    use.  A spaxel whose every datum is NaN gets no weight on that rule
    alone."""
    good = torch.isfinite(variance) & (variance > 0)
    if data is not None:
        good &= ~torch.isnan(data)
    if mask is not None:
        good &= ~mask
    w = torch.where(good, 1.0 / variance, torch.zeros_like(variance))
    return w.to(torch.bfloat16).to(variance.dtype)
