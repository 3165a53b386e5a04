"""The inputs of a run, made from the configuration and ``--seed``.

Gaussian noise on every voxel, drawn on the device by one
``torch.Generator`` call, plus each source of ``sources``: a flux at the
voxel (⌊L·a/b⌋, ⌊Y·c/d⌋, ⌊X·e/g⌋) for ``"at": [[a, b], [c, d], [e, g]]``,
so a scene keeps its layout when the cube is scaled.  The same seed gives
the same cube on the same device.

Without the optional keys below the variance is ``noise_sigma``²
everywhere, the noise's standard deviation ``noise_sigma``, and no spaxel
is masked or NaN.  The optional keys, each read only where the file has
it:

``variance``
    ``{"sky_lines": [{"lambda": λᵢ, "fwhm": FWHMᵢ, "amplitude": aᵢ}, ...],
    "spaxel_scale": [lo, hi]}``: the per-voxel law

        σ²(λ, y, x) = noise_sigma² · (1 + Σᵢ aᵢ·exp(−½((λ − λᵢ)/sᵢ)²))
                      · u(y, x),   sᵢ = FWHMᵢ / (2√(2 ln 2)),

    sky lines in λ (Å) and an exposure factor u per spaxel, uniform on
    [lo, hi] and drawn after the noise on the same generator.  The noise
    is then the same normal draw scaled by σ(λ, y, x).
``mask``
    a list of spaxel rectangles ``{"y": [[a, b], [c, d]], "x": [[e, g],
    [h, k]]}``, rows ⌊Y·a/b⌋ ≤ y < ⌊Y·c/d⌋ and columns ⌊X·e/g⌋ ≤ x <
    ⌊X·h/k⌋: the spaxels the user excludes (``Cube.from_data(mask=…)``).
``nan``
    rectangles of the same form, written as NaN into both the data and the
    variance, over every plane or, with ``"lam": [[m, n], [p, q]]``, over
    planes ⌊L·m/n⌋ ≤ λ < ⌊L·p/q⌋: the undefined voxels of a reduced cube.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


def _span(n: int, ends) -> slice:
    (a, b), (c, d) = ends
    return slice(n * int(a) // int(b), n * int(c) // int(d))


def _sky_profile(config: dict, lines) -> np.ndarray:
    """``[L]`` float64: 1 + Σᵢ aᵢ·exp(−½((λ − λᵢ)/sᵢ)²) over the sky
    ``lines`` at the planes' wavelengths crval + i·cdelt."""
    L = int(config["shape"][0])
    lam = float(config["crval"]) + np.arange(L, dtype=np.float64) * float(
        config["cdelt"])
    prof = np.ones(L, dtype=np.float64)
    for line in lines:
        s = float(line["fwhm"]) * _FWHM_TO_SIGMA
        prof += float(line["amplitude"]) * np.exp(
            -0.5 * ((lam - float(line["lambda"])) / s) ** 2)
    return prof


def make_inputs(config: dict, seed: int, device):
    """(data, variance) ``[L, Y, X]`` float32 and the spatial mask ``[Y,
    X]`` bool (None without ``mask``), all on ``device``."""
    L, Y, X = (int(v) for v in config["shape"])
    sigma = float(config["noise_sigma"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    data = torch.randn((L, Y, X), generator=gen, device=device)
    law = config.get("variance")
    if law is None:
        data.mul_(sigma)
        variance = torch.full_like(data, sigma * sigma)
    else:
        lo, hi = (float(v) for v in law["spaxel_scale"])
        u = torch.rand((Y, X), generator=gen, device=device).mul_(
            hi - lo).add_(lo)
        sky = torch.as_tensor(sigma * sigma * _sky_profile(config, law["sky_lines"]),
                              dtype=torch.float32, device=device)
        variance = sky[:, None, None] * u[None]
        data.mul_(torch.sqrt(variance))
    for src in config["sources"]:
        (a, b), (c, d), (e, g) = src["at"]
        data[L * a // b, Y * c // d, X * e // g] += float(src["flux"])
    for rect in config.get("nan", ()):
        lam = _span(L, rect["lam"]) if "lam" in rect else slice(None)
        where = (lam, _span(Y, rect["y"]), _span(X, rect["x"]))
        data[where] = math.nan
        variance[where] = math.nan
    mask = None
    if "mask" in config:
        mask = torch.zeros((Y, X), dtype=torch.bool, device=device)
        for rect in config["mask"]:
            mask[_span(Y, rect["y"]), _span(X, rect["x"])] = True
    return data, variance, mask
