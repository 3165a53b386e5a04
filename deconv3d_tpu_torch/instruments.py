"""Instrument forward models: spatial FSF and spectral LSF kernel banks.

Counterpart of ``deconv3d_tpu/instruments.py`` (the reference's
``Instrument``/``MUSE``, Moffat/Gaussian PSF classes, MUSE/Gaussian LSF
classes).  The kernel banks are NumPy, rasterised once on the host in
float64 into ``fsf[nlambda, f, f]`` and ``lsf[nlambda, l]`` — unchanged from
the JAX package; only :meth:`Instrument.convolve` goes through the torch
forward model (:func:`deconv3d_tpu_torch.convolve.convolve_cube`).

Every kernel is discretely normalised (sums to 1 over its footprint), so
convolution conserves flux on the sampled grid.

Canonical forward model (applies everywhere in this package):

    conv[mu] = FSF[mu] (*)_spatial ( LSF applied along lambda )(clean)[mu]

i.e. the spectral LSF mixes wavelengths first, then the spatial FSF *of the
output wavelength* blurs each plane; this buys exact separability of the
incremental local-patch delta: a spaxel-spectrum perturbation δ produces
Δconv[mu,dy,dx] = (Lδ)[mu] · FSF[mu,dy,dx].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .cube import Cube

__all__ = [
    "PointSpreadFunction", "MoffatPointSpreadFunction",
    "GaussianPointSpreadFunction", "NoPointSpreadFunction",
    "LineSpreadFunction", "MUSELineSpreadFunction",
    "GaussianLineSpreadFunction", "NoLineSpreadFunction",
    "Instrument", "MUSE",
    "MoffatFSF", "GaussianFSF", "NoFSF",
    "MUSELSF", "GaussianLSF", "NoLSF",
]

_GAUSS_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def _next_odd(n: int) -> int:
    n = max(int(n), 1)
    return n if n % 2 == 1 else n + 1


# ---------------------------------------------------------------------------
# Spatial FSF (Field/Point Spread Function)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointSpreadFunction:
    """Base spatial PSF.  FWHM is in arcsec, optionally λ-dependent.

    ``fwhm_at(wavelengths)`` returns FWHM(λ) in arcsec; the linear drift
    ``fwhm + fwhm_slope * (λ - lambda_ref)`` is the standard MUSE
    parameterisation of seeing chromaticity.
    """

    fwhm: float = 0.66
    lambda_ref: Optional[float] = None
    fwhm_slope: float = 0.0

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        wavelengths = np.asarray(wavelengths, dtype=np.float64)
        if self.fwhm_slope == 0.0 or self.lambda_ref is None:
            return np.full(wavelengths.shape, float(self.fwhm))
        return self.fwhm + self.fwhm_slope * (wavelengths - self.lambda_ref)

    def default_size(self, wavelengths, pixel_scale: float) -> int:
        fw_px = float(np.max(self.fwhm_at(wavelengths))) / pixel_scale
        return _next_odd(int(np.ceil(4.0 * fw_px)) | 1)

    def profile(self, r2: np.ndarray, fwhm_px: float) -> np.ndarray:
        """Unnormalised radial profile given squared radius in px²."""
        raise NotImplementedError

    def bank(
        self, wavelengths, size: Optional[int] = None, pixel_scale: float = 0.2
    ) -> np.ndarray:
        """Rasterise to ``[nlambda, size, size]`` normalised kernels."""
        wavelengths = np.asarray(wavelengths, dtype=np.float64)
        if size is None:
            size = self.default_size(wavelengths, pixel_scale)
        if size % 2 != 1:
            raise ValueError("FSF footprint size must be odd")
        half = size // 2
        yy, xx = np.mgrid[-half : half + 1, -half : half + 1].astype(np.float64)
        r2 = yy * yy + xx * xx
        fw_px = self.fwhm_at(wavelengths) / pixel_scale
        kern = self.profile(r2[None, :, :], fw_px[:, None, None])
        norm = kern.sum(axis=(1, 2), keepdims=True)
        return (kern / norm).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class MoffatPointSpreadFunction(PointSpreadFunction):
    """Moffat profile (1 + (r/α)²)^(−β); the MUSE seeing model.

    Reference parity: deconv3d's MoffatPointSpreadFunction (SURVEY.md §2).
    α is derived from FWHM: α = FWHM / (2 √(2^{1/β} − 1)).
    """

    beta: float = 2.6

    def profile(self, r2, fwhm_px):
        alpha = fwhm_px / (2.0 * np.sqrt(2.0 ** (1.0 / self.beta) - 1.0))
        return (1.0 + r2 / (alpha * alpha)) ** (-self.beta)

    def default_size(self, wavelengths, pixel_scale: float) -> int:
        # Moffat wings are heavy: use a wider support than the Gaussian rule.
        fw_px = float(np.max(self.fwhm_at(wavelengths))) / pixel_scale
        return _next_odd(int(np.ceil(5.0 * fw_px)) | 1)


@dataclasses.dataclass(frozen=True)
class GaussianPointSpreadFunction(PointSpreadFunction):
    """Circular Gaussian PSF parameterised by FWHM (arcsec)."""

    def profile(self, r2, fwhm_px):
        sigma = fwhm_px * _GAUSS_FWHM_TO_SIGMA
        return np.exp(-0.5 * r2 / (sigma * sigma))


@dataclasses.dataclass(frozen=True)
class NoPointSpreadFunction(PointSpreadFunction):
    """Identity spatial kernel (delta function) — for tests."""

    def bank(self, wavelengths, size=None, pixel_scale: float = 0.2):
        wavelengths = np.asarray(wavelengths, dtype=np.float64)
        if size is None:
            size = 1
        kern = np.zeros((wavelengths.shape[0], size, size))
        kern[:, size // 2, size // 2] = 1.0
        return kern

    def default_size(self, wavelengths, pixel_scale: float) -> int:
        return 1


# ---------------------------------------------------------------------------
# Spectral LSF (Line Spread Function)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TabulatedPointSpreadFunction(PointSpreadFunction):
    """User-supplied (measured) FSF image(s) instead of an analytic profile.

    MUSE practice often measures the FSF from stars in the field rather
    than fitting a Moffat (reference scope: SURVEY.md §2 "kernel
    rasterization" — the reference rasterises analytic kernels; accepting a
    measured raster is the natural superset).  ``image`` is ``[f, f]``
    (achromatic, broadcast over λ) or ``[L, f, f]`` (per-plane, C7), with
    odd ``f``, centred on the middle pixel.  Each plane is renormalised to
    unit sum.  ``size`` requests a centred crop (never zero-padding growth:
    a measured kernel has no data outside its raster).

    ``pixel_scale`` (arcsec/px, optional) makes :meth:`fwhm_at` honour the
    base-class contract (FWHM in arcsec); without it the moment-based FWHM
    is returned in *pixels* — see the method docstring.
    """

    image: "np.ndarray | None" = None
    pixel_scale: Optional[float] = None

    def __post_init__(self):
        img = np.asarray(self.image, dtype=np.float64)
        if img.ndim == 2:
            img = img[None]
        if img.ndim != 3 or img.shape[1] != img.shape[2]:
            raise ValueError(
                f"image must be [f,f] or [L,f,f] with square planes, "
                f"got shape {np.asarray(self.image).shape}"
            )
        if img.shape[1] % 2 != 1:
            raise ValueError("FSF raster size must be odd (centred kernel)")
        if not np.all(np.isfinite(img)):
            raise ValueError("FSF image contains non-finite values")
        object.__setattr__(self, "image", img)

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        """Effective Gaussian-equivalent FWHM from second moments.

        Returned in **arcsec** when ``pixel_scale`` was given at
        construction (the base-class contract), otherwise in **pixels** —
        a measured raster knows nothing about the sky scale.  Informational
        only; nothing samples from it (``bank``/``default_size`` use the
        raster directly).
        """
        lam = np.asarray(wavelengths, dtype=np.float64)
        img = self.image
        if img.shape[0] not in (1, lam.shape[0]):
            raise ValueError(
                f"per-λ FSF image has {img.shape[0]} planes but "
                f"{lam.shape[0]} wavelengths were given"
            )
        half = img.shape[1] // 2
        yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
        w = img / img.sum(axis=(1, 2), keepdims=True)
        var = (w * (yy * yy + xx * xx)[None]).sum(axis=(1, 2)) / 2.0
        fw = np.sqrt(var) / _GAUSS_FWHM_TO_SIGMA
        if self.pixel_scale is not None:
            fw = fw * float(self.pixel_scale)
        fw = np.broadcast_to(fw, (lam.shape[0],) if fw.shape[0] == 1
                             else fw.shape)
        return np.asarray(fw)

    def default_size(self, wavelengths, pixel_scale: float) -> int:
        return int(self.image.shape[1])

    def bank(
        self, wavelengths, size: Optional[int] = None, pixel_scale: float = 0.2
    ) -> np.ndarray:
        lam = np.asarray(wavelengths, dtype=np.float64)
        img = self.image
        if img.shape[0] == 1:
            img = np.broadcast_to(img, (lam.shape[0],) + img.shape[1:])
        elif img.shape[0] != lam.shape[0]:
            raise ValueError(
                f"per-λ FSF image has {img.shape[0]} planes but the cube "
                f"has {lam.shape[0]} wavelengths"
            )
        f = img.shape[1]
        if size is not None:
            if size % 2 != 1:
                raise ValueError("FSF footprint size must be odd")
            if size > f:
                raise ValueError(
                    f"requested size {size} exceeds the measured raster {f} "
                    "— a tabulated kernel cannot be extrapolated"
                )
            half, c = size // 2, f // 2
            img = img[:, c - half:c + half + 1, c - half:c + half + 1]
        norm = img.sum(axis=(1, 2), keepdims=True)
        if np.any(norm <= 0):
            raise ValueError("FSF image planes must have positive total flux")
        return (img / norm).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class LineSpreadFunction:
    """Base spectral LSF.  ``fwhm_at`` returns FWHM(λ) in Angstrom."""

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def default_width(self, wavelengths, cdelt: float) -> int:
        fw = float(np.max(self.fwhm_at(np.asarray(wavelengths)))) / abs(cdelt)
        return _next_odd(int(np.ceil(4.0 * fw)) | 1)

    def bank(
        self, wavelengths, cdelt: float, width: Optional[int] = None
    ) -> np.ndarray:
        """Rasterise to ``[nlambda, width]`` normalised Gaussian kernels.

        Row ``mu`` is the kernel centred on output plane ``mu``; entry ``d``
        weights input plane ``mu + (d - width//2)``.
        """
        wavelengths = np.asarray(wavelengths, dtype=np.float64)
        if width is None:
            width = self.default_width(wavelengths, cdelt)
        if width % 2 != 1:
            raise ValueError("LSF width must be odd")
        half = width // 2
        offsets = np.arange(-half, half + 1, dtype=np.float64) * abs(cdelt)
        sigma = self.fwhm_at(wavelengths)[:, None] * _GAUSS_FWHM_TO_SIGMA
        kern = np.exp(-0.5 * (offsets[None, :] / sigma) ** 2)
        return (kern / kern.sum(axis=1, keepdims=True)).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class MUSELineSpreadFunction(LineSpreadFunction):
    """MUSE spectral LSF: Gaussian with the calibrated FWHM(λ) polynomial.

    Reference parity: deconv3d's MUSELineSpreadFunction (SURVEY.md §2), which
    models the MUSE LSF as a Gaussian whose FWHM follows the instrument
    calibration, quadratic in wavelength (Å):

        FWHM(λ) = c2·λ² + c1·λ + c0

    Defaults are the published MUSE UDF calibration (Bacon et al. 2017).
    """

    c2: float = 5.866e-8
    c1: float = -9.187e-4
    c0: float = 6.040

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        lam = np.asarray(wavelengths, dtype=np.float64)
        return self.c2 * lam * lam + self.c1 * lam + self.c0


@dataclasses.dataclass(frozen=True)
class GaussianLineSpreadFunction(LineSpreadFunction):
    """Gaussian LSF with constant FWHM in Angstrom."""

    fwhm: float = 2.5

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        lam = np.asarray(wavelengths, dtype=np.float64)
        return np.full(lam.shape, float(self.fwhm))


@dataclasses.dataclass(frozen=True)
class TabulatedLineSpreadFunction(LineSpreadFunction):
    """User-supplied (measured) spectral kernel(s): ``[w]`` or ``[L, w]``.

    Odd ``w``, centred; rows are renormalised to unit sum.  Mirrors
    :class:`TabulatedPointSpreadFunction` for the spectral axis (e.g. an
    LSF measured from arc lines, or exported from mpdaf).

    ``cdelt`` (Å/bin, optional) makes :meth:`fwhm_at` honour the base-class
    contract (FWHM in Angstrom); without it the moment-based FWHM is
    returned in *spectral bins* — see the method docstring.
    """

    kernel: "np.ndarray | None" = None
    cdelt: Optional[float] = None

    def __post_init__(self):
        k = np.asarray(self.kernel, dtype=np.float64)
        if k.ndim == 1:
            k = k[None]
        if k.ndim != 2:
            raise ValueError(
                f"kernel must be [w] or [L,w], got shape "
                f"{np.asarray(self.kernel).shape}"
            )
        if k.shape[1] % 2 != 1:
            raise ValueError("LSF width must be odd (centred kernel)")
        if not np.all(np.isfinite(k)):
            raise ValueError("LSF kernel contains non-finite values")
        object.__setattr__(self, "kernel", k)

    def fwhm_at(self, wavelengths: np.ndarray) -> np.ndarray:
        """Effective Gaussian-equivalent FWHM from second moments.

        Returned in **Angstrom** when ``cdelt`` was given at construction
        (the base-class contract), otherwise in **spectral bins** — a
        measured kernel knows nothing about the wavelength step.
        Informational only; ``bank``/``default_width`` use the kernel
        directly.
        """
        lam = np.asarray(wavelengths, dtype=np.float64)
        if self.kernel.shape[0] not in (1, lam.shape[0]):
            raise ValueError(
                f"per-λ LSF kernel has {self.kernel.shape[0]} rows but "
                f"{lam.shape[0]} wavelengths were given"
            )
        k = self.kernel / self.kernel.sum(axis=1, keepdims=True)
        half = k.shape[1] // 2
        off = np.arange(-half, half + 1, dtype=np.float64)
        var = (k * off * off).sum(axis=1)
        fw = np.sqrt(var) / _GAUSS_FWHM_TO_SIGMA
        if self.cdelt is not None:
            fw = fw * abs(float(self.cdelt))
        return np.asarray(np.broadcast_to(
            fw, (lam.shape[0],) if fw.shape[0] == 1 else fw.shape
        ))

    def default_width(self, wavelengths, cdelt: float) -> int:
        return int(self.kernel.shape[1])

    def bank(
        self, wavelengths, cdelt: float, width: Optional[int] = None
    ) -> np.ndarray:
        lam = np.asarray(wavelengths, dtype=np.float64)
        k = self.kernel
        if k.shape[0] == 1:
            k = np.broadcast_to(k, (lam.shape[0], k.shape[1]))
        elif k.shape[0] != lam.shape[0]:
            raise ValueError(
                f"per-λ LSF kernel has {k.shape[0]} rows but the cube has "
                f"{lam.shape[0]} wavelengths"
            )
        w = k.shape[1]
        if width is not None:
            if width % 2 != 1:
                raise ValueError("LSF width must be odd")
            if width > w:
                raise ValueError(
                    f"requested width {width} exceeds the measured kernel "
                    f"{w} — a tabulated kernel cannot be extrapolated"
                )
            half, c = width // 2, w // 2
            k = k[:, c - half:c + half + 1]
        norm = k.sum(axis=1, keepdims=True)
        if np.any(norm <= 0):
            raise ValueError("LSF kernel rows must have positive total sum")
        return (k / norm).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class NoLineSpreadFunction(LineSpreadFunction):
    """Identity spectral kernel (delta function) — for tests."""

    def fwhm_at(self, wavelengths):
        return np.zeros(np.asarray(wavelengths).shape)

    def default_width(self, wavelengths, cdelt: float) -> int:
        return 1

    def bank(self, wavelengths, cdelt: float, width: Optional[int] = None):
        wavelengths = np.asarray(wavelengths, dtype=np.float64)
        if width is None:
            width = 1
        kern = np.zeros((wavelengths.shape[0], width))
        kern[:, width // 2] = 1.0
        return kern


# ---------------------------------------------------------------------------
# Instrument: couples one FSF and one LSF on a pixel grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Instrument:
    """One FSF + one LSF + the spatial pixel scale (arcsec/px).

    Rasterises both kernels onto a cube's grid and exposes full-cube
    convolution.  The heavy lifting lives in
    :mod:`deconv3d_tpu_torch.convolve`.
    """

    fsf: PointSpreadFunction = dataclasses.field(
        default_factory=MoffatPointSpreadFunction
    )
    lsf: LineSpreadFunction = dataclasses.field(
        default_factory=MUSELineSpreadFunction
    )
    pixel_scale: float = 0.2

    def kernel_banks(
        self,
        cube: Cube,
        fsf_size: Optional[int] = None,
        lsf_width: Optional[int] = None,
    ):
        """Rasterise (fsf_bank [L,f,f], lsf_bank [L,l]) on the cube's grid."""
        lam = cube.wavelengths()
        fsf = self.fsf.bank(lam, size=fsf_size, pixel_scale=self.pixel_scale)
        lsf = self.lsf.bank(lam, cdelt=cube.cdelt, width=lsf_width)
        return fsf, lsf

    def convolve(self, cube: Cube) -> Cube:
        """Full-cube separable convolution of ``cube.data`` (FFT path, C5)."""
        from . import convolve as conv

        fsf, lsf = self.kernel_banks(cube)
        out = conv.convolve_cube(cube.data, fsf, lsf)
        return dataclasses.replace(cube, data=out)


@dataclasses.dataclass(frozen=True)
class MUSE(Instrument):
    """VLT/MUSE wide-field mode defaults: 0.2″/px, Moffat FSF, MUSE LSF."""

    pixel_scale: float = 0.2


# Short aliases; the long names match the reference API.
MoffatFSF = MoffatPointSpreadFunction
GaussianFSF = GaussianPointSpreadFunction
NoFSF = NoPointSpreadFunction
TabulatedFSF = TabulatedPointSpreadFunction
MUSELSF = MUSELineSpreadFunction
GaussianLSF = GaussianLineSpreadFunction
NoLSF = NoLineSpreadFunction
TabulatedLSF = TabulatedLineSpreadFunction
