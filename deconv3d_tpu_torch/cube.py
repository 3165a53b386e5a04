"""Hyperspectral cube data model on torch tensors.

PyTorch counterpart of ``deconv3d_tpu/cube.py``: the same immutable
dataclass (data + variance + mask + spectral WCS + passthrough header), with
``torch.Tensor`` fields in place of JAX arrays.  FITS and NPZ I/O happen on
the host through the NumPy-only ``io/fits.py``.

Axis convention: ``data[nlambda, ny, nx]`` (λ first, as the FITS NAXIS3
spectral axis of MUSE products loads in C order).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from .io import fits as fitsio


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32`` for ``np.float32``/``"float32"``/``torch.float32``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _to_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Cube:
    """Immutable hyperspectral cube: data + variance + mask + spectral WCS.

    Attributes:
      data:     ``[nlambda, ny, nx]`` flux values.
      variance: same shape, per-voxel noise variance, or None.
      mask:     ``[ny, nx]`` bool, True = spaxel EXCLUDED (masked spaxels are
                skipped by the sampler and excluded from chi²), or None.
      crval/cdelt/crpix: spectral axis WCS (Angstrom; FITS 1-based crpix).
      header:   passthrough FITS cards as a tuple of ``(key, value)`` pairs
                (spatial WCS, units, instrument cards), written back by
                :meth:`to_fits`.
    """

    data: torch.Tensor
    variance: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    crval: float = 0.0
    cdelt: float = 1.0
    crpix: float = 1.0
    header: tuple = ()

    @property
    def header_dict(self) -> dict:
        return dict(self.header)

    # -- shape helpers ------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    @property
    def nlambda(self) -> int:
        return self.data.shape[0]

    @property
    def ny(self) -> int:
        return self.data.shape[1]

    @property
    def nx(self) -> int:
        return self.data.shape[2]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def wavelengths(self) -> np.ndarray:
        """Wavelength of each spectral plane (host-side, float64)."""
        i = np.arange(self.data.shape[0], dtype=np.float64)
        return self.crval + (i + 1.0 - self.crpix) * self.cdelt

    def to(self, device) -> "Cube":
        """The same cube with every tensor on ``device``."""
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, data=move(self.data), variance=move(self.variance),
            mask=move(self.mask),
        )

    # -- construction -------------------------------------------------------
    @classmethod
    def from_data(
        cls,
        data,
        variance=None,
        mask=None,
        crval: float = 0.0,
        cdelt: float = 1.0,
        crpix: float = 1.0,
        dtype=torch.float32,
        header=(),
        device=None,
    ) -> "Cube":
        dtype = torch_dtype(dtype)
        data = _to_tensor(data, dtype, device)
        if data.ndim != 3:
            raise ValueError(
                f"Cube data must be 3-D [lambda,y,x], got {tuple(data.shape)}"
            )
        if variance is not None:
            variance = _to_tensor(variance, dtype, data.device)
            if variance.shape != data.shape:
                try:
                    variance = torch.broadcast_to(variance, data.shape).clone()
                except RuntimeError:
                    raise ValueError(
                        f"variance shape {tuple(variance.shape)} is not "
                        f"broadcastable to data shape {tuple(data.shape)}"
                    ) from None
        if mask is not None:
            mask = _to_tensor(mask, torch.bool, data.device)
            if mask.shape != data.shape[1:]:
                raise ValueError("mask must be [ny, nx]")
        return cls(
            data=data, variance=variance, mask=mask,
            crval=float(crval), cdelt=float(cdelt), crpix=float(crpix),
            header=tuple(header.items()) if isinstance(header, dict)
            else tuple(header),
        )

    # FITS cards NOT carried in the passthrough header: structural keys the
    # writer regenerates, and the spectral axis, which lives in the
    # crval/cdelt/crpix fields (written back as CRVAL3/CDELT3/CRPIX3).
    _NON_PASSTHROUGH = frozenset(
        {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT",
         "EXTEND", "EXTNAME", "BSCALE", "BZERO",
         "CRVAL3", "CDELT3", "CD3_3", "CRPIX3", "CTYPE3", "CUNIT3"}
        | {f"NAXIS{i}" for i in range(1, 10)}
    )

    @classmethod
    def _passthrough_cards(cls, *headers) -> tuple:
        """Merge headers (later wins) into the passthrough card tuple."""
        merged: dict = {}
        for hdr in headers:
            for key, value in hdr.items():
                if key.upper() not in cls._NON_PASSTHROUGH:
                    merged[key] = value
        return tuple(merged.items())

    @classmethod
    def from_fits(cls, path: str, dtype=torch.float32, device=None) -> "Cube":
        """Load a MUSE-style FITS cube (DATA + optional STAT extension)."""
        hdus = fitsio.read(path)
        data_hdu, stat_hdu = fitsio.find_cube_hdus(hdus)
        crval, cdelt, crpix = fitsio.spectral_wcs(data_hdu.header)
        if (crval, cdelt, crpix) == (0.0, 1.0, 1.0) and hdus[0] is not data_hdu:
            crval, cdelt, crpix = fitsio.spectral_wcs(hdus[0].header)
        header = (
            cls._passthrough_cards(hdus[0].header, data_hdu.header)
            if hdus[0] is not data_hdu
            else cls._passthrough_cards(data_hdu.header)
        )
        variance = stat_hdu.data if stat_hdu is not None else None
        return cls.from_data(
            np.ascontiguousarray(data_hdu.data),
            variance=None if variance is None else np.ascontiguousarray(variance),
            crval=crval, cdelt=cdelt, crpix=crpix, dtype=dtype,
            header=header, device=device,
        )

    @classmethod
    def from_file(cls, path: str, dtype=torch.float32, device=None) -> "Cube":
        """Load a cube by file extension (``.npz`` or FITS)."""
        if path.endswith(".npz"):
            return cls.from_npz(path, dtype=dtype, device=device)
        return cls.from_fits(path, dtype=dtype, device=device)

    @classmethod
    def from_npz(cls, path: str, dtype=torch.float32, device=None) -> "Cube":
        with np.load(path) as z:
            header = ()
            if "header_json" in z:
                header = tuple(json.loads(str(z["header_json"])).items())
            return cls.from_data(
                z["data"],
                variance=z["variance"] if "variance" in z else None,
                mask=z["mask"] if "mask" in z else None,
                crval=float(z.get("crval", 0.0)),
                cdelt=float(z.get("cdelt", 1.0)),
                crpix=float(z.get("crpix", 1.0)),
                dtype=dtype,
                header=header,
                device=device,
            )

    # -- persistence ---------------------------------------------------------
    def to_fits(self, path: str, header_extra: Optional[dict] = None) -> None:
        """Write MUSE-pipeline layout: empty primary + DATA (+ STAT) HDUs."""
        wcs_cards: dict[str, Any] = dict(self.header)
        wcs_cards.update({
            "CRVAL3": self.crval, "CDELT3": self.cdelt, "CRPIX3": self.crpix,
            "CTYPE3": "AWAV", "CUNIT3": "Angstrom",
        })
        if header_extra:
            wcs_cards.update(header_extra)
        hdus = [fitsio.HDU(header=dict(wcs_cards))]
        hdus.append(
            fitsio.HDU(
                header={"EXTNAME": "DATA", **wcs_cards},
                data=self.data.detach().cpu().numpy().astype(np.float32),
            )
        )
        if self.variance is not None:
            hdus.append(
                fitsio.HDU(
                    header={"EXTNAME": "STAT", **wcs_cards},
                    data=self.variance.detach().cpu().numpy().astype(np.float32),
                )
            )
        fitsio.write(path, hdus)

    def write(self, path: str, header_extra: Optional[dict] = None) -> None:
        """Write by file extension (``.npz`` or FITS)."""
        if path.endswith(".npz"):
            self.to_npz(path, header_extra=header_extra)
        else:
            self.to_fits(path, header_extra=header_extra)

    def to_npz(self, path: str, header_extra: Optional[dict] = None) -> None:
        out = {"data": self.data.cpu().numpy(), "crval": self.crval,
               "cdelt": self.cdelt, "crpix": self.crpix}
        if self.variance is not None:
            out["variance"] = self.variance.cpu().numpy()
        if self.mask is not None:
            out["mask"] = self.mask.cpu().numpy()
        cards = dict(self.header)
        if header_extra:
            cards.update(header_extra)
        if cards:
            out["header_json"] = np.str_(json.dumps(cards))
        np.savez(path, **out)

    # -- sanitisation --------------------------------------------------------
    def sanitized(self, default_variance: Optional[float] = None) -> "Cube":
        """NaN-clean cube ready for sampling.

        * NaN data voxels → 0 flux with infinite variance (zero weight).
        * Missing variance → ``default_variance`` (or the variance of the data
          itself as a crude noise floor).
        * All-NaN spaxels are folded into the exclusion mask.
        """
        data = self.data
        nan = torch.isnan(data)
        if self.variance is None:
            if default_variance is None:
                mean = torch.nanmean(data)
                default_variance = float(torch.nanmean((data - mean) ** 2))
                if not np.isfinite(default_variance) or default_variance <= 0:
                    default_variance = 1.0
            variance = torch.full_like(data, default_variance)
        else:
            variance = torch.where(
                torch.isnan(self.variance) | (self.variance <= 0),
                torch.inf, self.variance,
            )
        variance = torch.where(nan, torch.inf, variance)
        data = torch.where(nan, 0.0, data)
        dead = torch.all(nan, dim=0)
        mask = dead if self.mask is None else (self.mask | dead)
        return dataclasses.replace(self, data=data, variance=variance, mask=mask)

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op) -> "Cube":
        other_data = other.data if isinstance(other, Cube) else other
        return dataclasses.replace(self, data=op(self.data, other_data))

    def __add__(self, other):
        return self._binop(other, torch.add)

    def __sub__(self, other):
        return self._binop(other, torch.subtract)

    def __mul__(self, other):
        return self._binop(other, torch.multiply)

    def __truediv__(self, other):
        return self._binop(other, torch.divide)
