"""The port's command line (``python -m deconv3d_tpu_torch``), in process on
the CPU (``--device cpu``): ``info``, ``run`` (mh, gibbs, direct,
``--until-rhat``, tabulated kernels), ``map`` against the JAX package's
``map`` on the same FITS cube, and the mesh refusal.  Mirrors
``tests/test_cli.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deconv3d_tpu_torch import Cube
from deconv3d_tpu_torch.__main__ import main

CPU = ["--device", "cpu"]
INSTRUMENT = ["--fsf", "gaussian", "--fsf-fwhm", "0.5", "--lsf", "gaussian",
              "--lsf-fwhm", "2.0"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These toys are a few hundred voxels: torch's intra-op threads cost
    more than they give (a 4× slower FFT at 8×8), and under a parallel
    test run they contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_cube(tmp_path, rng):
    data = rng.normal(size=(16, 6, 6)).astype(np.float32)
    cube = Cube.from_data(data, variance=np.full_like(data, 0.04),
                          crval=4750.0, cdelt=1.25, device="cpu")
    path = str(tmp_path / "in.fits")
    cube.to_fits(path)
    return path


def test_cli_info(tmp_path, rng, capsys):
    path = _write_cube(tmp_path, rng)
    assert main(["info", "--cube", path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["shape_lyx"] == [16, 6, 6]
    assert out["has_variance"] is True
    assert out["lambda_range_A"] == [4750.0, 4750.0 + 15 * 1.25]


@pytest.mark.parametrize("sampler, n, extra, accept", [
    ("gibbs", 20, [], 1.0),
    ("mh", 20, ["--burn-in", "10"], None),
    ("direct", 4, ["--prior-precision", "auto"], 1.0),
])
def test_cli_run(tmp_path, rng, capsys, sampler, n, extra, accept):
    path = _write_cube(tmp_path, rng)
    out_prefix = str(tmp_path / "res")
    rc = main(["run", "--cube", path, "--out", out_prefix, "--iterations",
               str(n), "--sampler", sampler, *INSTRUMENT, *CPU, *extra])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["sweeps"] == n
    if accept is not None:
        assert stats["acceptance_rate"] == accept
    else:
        assert 0.0 < stats["acceptance_rate"] < 1.0
    assert stats["engine"] == "torch"
    for suffix in ("_clean.fits", "_stats.json", "_traces.npz"):
        assert os.path.exists(out_prefix + suffix)


def test_cli_run_until(tmp_path, rng, capsys):
    path = _write_cube(tmp_path, rng)
    rc = main(["run", "--cube", path, "--out", str(tmp_path / "until"),
               "--iterations", "96", "--burn-in", "8", "--chains", "2",
               "--sampler", "mh", "--until-rhat", "2.0", "--min-ess",
               "5", *INSTRUMENT, *CPU])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["run_until"]["sweeps"] <= 96
    assert stats["run_until"]["ess_chi2"] > 0


def test_cli_map_matches_jax(tmp_path, rng, capsys):
    """``map`` on a FITS cube: a converged MAP of the cube's shape that
    agrees with the JAX package's ``map`` command on the same file to 1e-4
    of its scale (the port's problem keeps the MCMC path's bf16-valued
    weights and low-rank FSF, as the JAX package's pallas engine; its jnp
    engine, which the JAX command takes on the CPU, keeps exact ones: the
    two models differ by ~1e-5), and the resolved τ of 'auto'."""
    from deconv3d_tpu.__main__ import main as jmain

    path = _write_cube(tmp_path, rng)
    args = ["--cube", path, "--fsf", "gaussian", "--fsf-fwhm", "0.3",
            "--lsf", "gaussian", "--lsf-fwhm", "1.5", "--tol", "1e-7",
            "--prior-precision", "auto"]
    out = str(tmp_path / "map.fits")
    assert main(["map", "--out", out, *args, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    jout = str(tmp_path / "jmap.fits")
    assert jmain(["map", "--out", jout, *args]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["out"] == out and got["converged"] is True
    assert got["rel_residual"] <= 1e-7
    assert got["prior_precision"] == pytest.approx(want["prior_precision"],
                                                   rel=1e-6)
    m = Cube.from_fits(out).data.numpy()
    jm = Cube.from_fits(jout).data.numpy()
    assert m.shape == (16, 6, 6) and np.isfinite(m).all()
    np.testing.assert_allclose(m, jm, rtol=0, atol=1e-4 * np.abs(jm).max())


def test_cli_run_tabulated_kernels(tmp_path, rng, capsys):
    """--fsf/--lsf tabulated load measured rasters from .npy/.npz files."""
    from deconv3d_tpu_torch import instruments as ins

    path = _write_cube(tmp_path, rng)
    lam = 4750.0 + 1.25 * np.arange(16)
    fsf_path, lsf_path = str(tmp_path / "fsf.npy"), str(tmp_path / "lsf.npz")
    np.save(fsf_path, ins.GaussianFSF(fwhm=0.5).bank(lam, size=5,
                                                     pixel_scale=0.2))
    np.savez(lsf_path, kernel=ins.GaussianLSF(fwhm=2.0).bank(
        lam, cdelt=1.25, width=5))
    out_prefix = str(tmp_path / "res_tab")
    rc = main(["run", "--cube", path, "--out", out_prefix, "--iterations",
               "10", "--sampler", "gibbs", "--fsf", "tabulated",
               "--fsf-image", fsf_path, "--lsf", "tabulated", "--lsf-kernel",
               lsf_path, *CPU])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["sweeps"] == 10
    assert os.path.exists(out_prefix + "_clean.fits")
    with pytest.raises(SystemExit, match="fsf-image"):
        main(["run", "--cube", path, "--fsf", "tabulated", *CPU])


def test_cli_refuses_spatial_shards(tmp_path, rng):
    """``--spatial-shards 2 --device cpu`` shards the chain over two slots
    of the CPU and runs to its products; so does ``--sampler direct
    --spatial-shards 2`` (the sharded PCG; it was refused before
    ``parallel/direct_sharded.py``)."""
    data = rng.normal(size=(16, 20, 10)).astype(np.float32)
    path = str(tmp_path / "tall.fits")
    Cube.from_data(data, variance=np.full_like(data, 0.04), crval=4750.0,
                   cdelt=1.25, device="cpu").to_fits(path)
    out = str(tmp_path / "sh")
    # a 5 x 5 FSF: 4 x 2 spaxel blocks, two block rows per shard
    narrow = ["--fsf", "gaussian", "--fsf-fwhm", "0.2", "--lsf", "gaussian",
              "--lsf-fwhm", "2.0"]
    assert main(["run", "--cube", path, "--out", out, "--iterations", "4",
                 "--burn-in", "1", "--spatial-shards", "2", *narrow,
                 *CPU]) == 0
    with open(f"{out}_stats.json") as fh:
        assert json.load(fh)["sweeps"] == 4
    out = str(tmp_path / "dsh")
    assert main(["run", "--cube", path, "--out", out, "--iterations", "2",
                 "--spatial-shards", "2", "--sampler", "direct",
                 "--prior-precision", "auto", *narrow,
                 *CPU]) == 0
    with open(f"{out}_stats.json") as fh:
        stats = json.load(fh)
    assert stats["sweeps"] == 2 and stats["acceptance_rate"] == 1.0
    assert os.path.exists(out + "_clean.fits")


def test_cli_module_entry_point(tmp_path, rng):
    """``python -m deconv3d_tpu_torch info`` in a child process."""
    path = _write_cube(tmp_path, rng)
    out = subprocess.run(
        [sys.executable, "-m", "deconv3d_tpu_torch", "info", "--cube", path],
        capture_output=True, text=True, check=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert json.loads(out.stdout)["shape_lyx"] == [16, 6, 6]
