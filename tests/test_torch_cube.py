"""The torch port's Cube: construction, sanitisation and file round trips."""

import numpy as np
import pytest
import torch

from deconv3d_tpu import Cube as JCube
from deconv3d_tpu_torch import Cube


def _cube(rng, **kw):
    data = rng.standard_normal((8, 5, 4)).astype(np.float32)
    var = (0.5 + rng.random((8, 5, 4))).astype(np.float32)
    mask = np.zeros((5, 4), bool)
    mask[1, 2] = True
    return Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                          cdelt=1.25, crpix=2.0,
                          header={"OBJECT": "toy", "CRVAL1": 150.1}, **kw)


def test_from_data_shapes_and_wavelengths(rng):
    cube = _cube(rng)
    assert cube.shape == (8, 5, 4) and cube.data.dtype == torch.float32
    assert cube.mask.dtype == torch.bool
    np.testing.assert_allclose(cube.wavelengths(),
                               4750.0 + (np.arange(8) - 1.0) * 1.25)
    scalar_var = Cube.from_data(np.zeros((3, 2, 2)), variance=2.0)
    assert scalar_var.variance.shape == (3, 2, 2)
    with pytest.raises(ValueError, match="broadcastable"):
        Cube.from_data(np.zeros((3, 2, 2)), variance=np.ones((4,)))
    with pytest.raises(ValueError, match="mask"):
        Cube.from_data(np.zeros((3, 2, 2)), mask=np.zeros((3, 3), bool))


def test_sanitized_matches_jax(rng):
    data = rng.standard_normal((6, 3, 3)).astype(np.float32)
    var = np.ones_like(data)
    var[0, 0, 0] = 0.0
    var[1, 1, 1] = -2.0
    mask = np.zeros((3, 3), bool)
    mask[2, 2] = True
    got = Cube.from_data(data, variance=var, mask=mask).sanitized()
    want = JCube.from_data(data, variance=var, mask=mask).sanitized()
    np.testing.assert_array_equal(got.variance.numpy(), np.asarray(want.variance))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # missing variance falls back to the data variance
    nov = Cube.from_data(data).sanitized()
    np.testing.assert_allclose(float(nov.variance[0, 0, 0]),
                               float(np.var(data)), rtol=1e-5)


def test_sanitized_nan_spaxel_is_masked():
    data = np.ones((4, 2, 2), np.float32)
    data[:, 0, 1] = np.nan
    data[2, 1, 1] = np.nan
    s = Cube.from_data(data, variance=np.ones_like(data)).sanitized()
    assert bool(s.mask[0, 1]) and not bool(s.mask[1, 1])
    assert float(s.data[2, 1, 1]) == 0.0
    assert float(s.variance[2, 1, 1]) == float("inf")


@pytest.mark.parametrize("ext", [".fits", ".npz"])
def test_file_round_trip(rng, tmp_path, ext):
    cube = _cube(rng)
    path = str(tmp_path / f"c{ext}")
    cube.write(path, header_extra={"HISTORY1": "port"})
    back = Cube.from_file(path)
    np.testing.assert_array_equal(back.data.numpy(), cube.data.numpy())
    np.testing.assert_array_equal(back.variance.numpy(), cube.variance.numpy())
    assert (back.crval, back.cdelt, back.crpix) == (4750.0, 1.25, 2.0)
    assert back.header_dict["OBJECT"] == "toy"
    assert back.header_dict["HISTORY1"] == "port"
    if ext == ".npz":
        np.testing.assert_array_equal(back.mask.numpy(), cube.mask.numpy())


def test_fits_readable_by_jax_package(rng, tmp_path):
    cube = _cube(rng)
    path = str(tmp_path / "c.fits")
    cube.to_fits(path)
    j = JCube.from_fits(path)
    np.testing.assert_array_equal(np.asarray(j.data), cube.data.numpy())
    assert j.header_dict["CRVAL1"] == 150.1


def test_arithmetic(rng):
    cube = _cube(rng)
    np.testing.assert_allclose((cube * 2 - cube).data.numpy(),
                               cube.data.numpy())
    np.testing.assert_allclose((cube / 2 + cube).data.numpy(),
                               1.5 * cube.data.numpy(), rtol=1e-6)
