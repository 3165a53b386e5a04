"""The torch forward model against the JAX package's, on the CPU.

Same float32 inputs (from a seeded numpy generator) go through
``deconv3d_tpu.convolve.convolve_cube`` and its torch counterpart.
Tolerance: atol 1e-5·max|output| — float32 FFTs and sums in another order
(both libraries run full float32 on the CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deconv3d_tpu import convolve as jcv
from deconv3d_tpu import instruments as jins
from deconv3d_tpu_torch import convolve as tcv
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch.cube import Cube

ATOL_REL = 1e-5


def _banks(L=16, f=5, lw=5):
    lam = 4750.0 + 1.25 * np.arange(L)
    # chromatic FSF, so the two stage orders really differ
    fsf = jins.MoffatFSF(fwhm=0.5, lambda_ref=4760.0, fwhm_slope=2e-3).bank(
        lam, size=f, pixel_scale=0.2
    )
    lsf = jins.MUSELSF().bank(lam, cdelt=1.25, width=lw)
    return fsf.astype(np.float32), lsf.astype(np.float32)


@pytest.mark.parametrize("order", ["lsf_first", "fsf_first"])
@pytest.mark.parametrize("spatial", ["fft", "direct"])
@pytest.mark.parametrize("spectral", ["matrix", "banded"])
def test_convolve_cube_matches_jax(order, spatial, spectral):
    rng = np.random.default_rng(3)
    clean = rng.standard_normal((16, 9, 7)).astype(np.float32)
    fsf, lsf = _banks()
    want = np.asarray(jcv.convolve_cube(
        jnp.asarray(clean), jnp.asarray(fsf), jnp.asarray(lsf),
        spatial=spatial, spectral=spectral, order=order,
    ))
    got = tcv.convolve_cube(
        torch.as_tensor(clean), fsf, lsf, spatial=spatial, spectral=spectral,
        order=order,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_REL * np.abs(want).max())


def test_auto_resolves_to_fft():
    assert tcv.resolve_spatial("auto") == "fft"
    with pytest.raises(ValueError):
        tcv.resolve_spatial("winograd")


def test_lsf_matrix_equals_jax():
    _, lsf = _banks()
    np.testing.assert_array_equal(tcv.lsf_matrix(lsf), jcv.lsf_matrix(lsf))


def test_instrument_convolve_matches_jax():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((16, 8, 8)).astype(np.float32)
    want = jins.MUSE().convolve(
        __import__("deconv3d_tpu").Cube.from_data(data, crval=4750.0,
                                                  cdelt=1.25)
    ).data
    got = tins.MUSE().convolve(
        Cube.from_data(data, crval=4750.0, cdelt=1.25)
    ).data
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize(
    "name, make",
    [
        ("moffat", lambda m: m.MoffatFSF(fwhm=0.66)),
        ("moffat_chromatic",
         lambda m: m.MoffatFSF(fwhm=0.66, lambda_ref=7000.0, fwhm_slope=-3e-5)),
        ("gaussian", lambda m: m.GaussianFSF(fwhm=0.8)),
        ("none", lambda m: m.NoFSF()),
        ("tabulated", lambda m: m.TabulatedFSF(
            image=np.outer([1.0, 2.0, 1.0], [1.0, 3.0, 1.0]))),
    ],
)
def test_fsf_banks_equal(name, make):
    lam = np.linspace(4750.0, 9350.0, 32)
    np.testing.assert_array_equal(
        make(tins).bank(lam, pixel_scale=0.2), make(jins).bank(lam, pixel_scale=0.2)
    )


@pytest.mark.parametrize(
    "name, make",
    [
        ("muse", lambda m: m.MUSELSF()),
        ("gaussian", lambda m: m.GaussianLSF(fwhm=2.5)),
        ("none", lambda m: m.NoLSF()),
        ("tabulated", lambda m: m.TabulatedLSF(kernel=[1.0, 4.0, 6.0, 4.0, 1.0])),
    ],
)
def test_lsf_banks_equal(name, make):
    lam = np.linspace(4750.0, 9350.0, 32)
    np.testing.assert_array_equal(
        make(tins).bank(lam, cdelt=1.25), make(jins).bank(lam, cdelt=1.25)
    )
