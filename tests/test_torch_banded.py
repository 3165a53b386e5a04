"""The port's banded linear algebra (``deconv3d_tpu_torch/ops/banded.py``).

The plain loops against a dense oracle and against the JAX package's
``deconv3d_tpu.ops.banded`` on the same NumPy inputs (float64), the
conditional draw's moments, the wrappers' dispatch (plain on CPU tensors,
the kernel or an error elsewhere), and — marked ``gpu``, deciding inside
its body — the kernels of ``csrc/banded.cu`` against their plain versions
on the card.  JAX is imported inside the tests that compare with it, so
the card's test run (``pytest --noconftest -m gpu``, no JAX there) can
import this file.
"""

import numpy as np
import pytest
import torch

from deconv3d_tpu_torch.ops import banded as bd


def _jax():
    """(jax.numpy, deconv3d_tpu.ops.banded) in float64 mode."""
    import jax
    import jax.numpy as jnp

    from deconv3d_tpu.ops import banded as jbd

    jax.config.update("jax_enable_x64", True)
    return jnp, jbd


def _dense_M(lsf):
    """M[μ, l] = lsf[μ, l − μ + half] (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    M = np.zeros((L, L))
    for mu in range(L):
        for d in range(lw):
            l = mu + d - half
            if 0 <= l < L:
                M[mu, l] = lsf[mu, d]
    return M


def _dense_from_bands(bands):
    L, W = bands.shape
    A = np.zeros((L, L))
    for l in range(L):
        for k in range(W):
            if l + k < L:
                A[l, l + k] = A[l + k, l] = bands[l, k]
    return A


def _upper_from_bands(R):
    L, W = R.shape
    U = np.zeros((L, L))
    for l in range(L):
        for k in range(W):
            if l + k < L:
                U[l, l + k] = R[l, k]
    return U


def _system(rng, L, lw, batch=()):
    lsf = rng.random((L, lw)) + 0.1
    q = rng.random((*batch, L)) + 0.5
    return lsf, q


@pytest.mark.parametrize("L, lw", [(1, 1), (12, 1), (16, 3), (24, 5),
                                   (32, 11)])
def test_precision_bands_match_dense(rng, L, lw):
    lsf, q = _system(rng, L, lw)
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q)).numpy()
    M = _dense_M(lsf)
    np.testing.assert_allclose(_dense_from_bands(bands), M.T @ np.diag(q) @ M,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("L, lw", [(1, 1), (12, 1), (16, 3), (24, 5),
                                   (32, 11)])
def test_cholesky_and_solves_match_dense(rng, L, lw):
    """RᵀR == A; Rᵀz = b and Rx = b solved exactly; the draw's mean part
    is A⁻¹b (noise 0) and its fluctuation R⁻¹·noise."""
    lsf, q = _system(rng, L, lw)
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q))
    R = bd.cholesky_banded(bands)
    U = _upper_from_bands(R.numpy())
    A = _dense_from_bands(bands.numpy())
    np.testing.assert_allclose(U.T @ U, A, rtol=1e-10,
                               atol=1e-12 * np.abs(A).max())
    b = rng.standard_normal(L)
    bt = torch.tensor(b)
    np.testing.assert_allclose(bd.solve_transposed_banded(R, bt).numpy(),
                               np.linalg.solve(U.T, b), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(bd.solve_banded(R, bt).numpy(),
                               np.linalg.solve(U, b), rtol=1e-9, atol=1e-12)
    zero = torch.zeros(L, dtype=torch.float64)
    np.testing.assert_allclose(bd.sample_conditional(R, bt, zero).numpy(),
                               np.linalg.solve(A, b), rtol=1e-8, atol=1e-12)
    noise = rng.standard_normal(L)
    got = bd.sample_conditional(R, torch.zeros_like(bt), torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(U, noise),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("L, lw, batch", [(16, 3, (2,)), (32, 11, (3, 2)),
                                          (20, 5, ())])
def test_match_jax_banded(rng, L, lw, batch):
    """Parity with ``deconv3d_tpu.ops.banded`` on the same float64 inputs
    (rel 1e-10; the sums run in another order)."""
    jnp, jbd = _jax()
    lsf, q = _system(rng, L, lw, batch)
    bt = bd.precision_bands(torch.tensor(lsf), torch.tensor(q)).numpy()
    bj = np.asarray(jbd.precision_bands(jnp.asarray(lsf), jnp.asarray(q)))
    np.testing.assert_allclose(bt, bj, rtol=1e-10, atol=0)
    Rt = bd.cholesky_banded(torch.tensor(bj)).numpy()
    Rj = np.asarray(jbd.cholesky_banded(jnp.asarray(bj)))
    np.testing.assert_allclose(Rt, Rj, rtol=1e-10,
                               atol=1e-10 * np.abs(Rj).max())
    b = rng.standard_normal((*batch, L))
    noise = rng.standard_normal((*batch, L))
    for name, args in (
        ("solve_transposed_banded", (Rj, b)),
        ("solve_banded", (Rj, b)),
        ("sample_conditional", (Rj, b, noise)),
    ):
        got = getattr(bd, name)(*map(torch.tensor, args)).numpy()
        want = np.asarray(getattr(jbd, name)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(),
                                   err_msg=name)


def test_cholesky_jitter_and_zero_rows_match_jax(rng):
    """The pivot floor (a zero row and column of A, as a fully masked
    plane gives, stays finite) and the jitter scaling, as the JAX package
    has them."""
    jnp, jbd = _jax()
    lsf, q = _system(rng, 16, 5)
    bands = np.array(jbd.precision_bands(jnp.asarray(lsf), jnp.asarray(q)))
    bands[7] = 0.0
    for m in range(1, 5):
        bands[7 - m, m] = 0.0
    for jitter in (0.0, 1e-3):
        got = bd.cholesky_banded(torch.tensor(bands), jitter=jitter).numpy()
        want = np.asarray(jbd.cholesky_banded(jnp.asarray(bands),
                                              jitter=jitter))
        assert np.all(np.isfinite(got)) and got[7, 0] == np.sqrt(bd.EPS)
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_sample_conditional_moments(rng):
    """20k draws of a 6-λ system: mean A⁻¹b and covariance A⁻¹ (a batch
    dimension carries the draws)."""
    L, lw, n = 6, 3, 20_000
    lsf, q = _system(rng, L, lw)
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q))
    R = bd.cholesky_banded(bands)
    A = _dense_from_bands(bands.numpy())
    cov = np.linalg.inv(A)
    b = rng.standard_normal(L)
    x = bd.sample_conditional(
        R.expand(n, L, lw), torch.tensor(b).expand(n, L).contiguous(),
        torch.tensor(rng.standard_normal((n, L)))).numpy()
    z = (x.mean(0) - cov @ b) / np.sqrt(np.diag(cov) / n)
    assert np.abs(z).max() < 5.0, z
    np.testing.assert_allclose(np.cov(x.T), cov, rtol=0,
                               atol=0.05 * np.abs(cov).max())


def test_wrappers_dispatch_by_device(rng):
    """CPU tensors take the plain loops and count no launch; a tensor on
    neither the CPU nor a CUDA device raises (no plain fallback); a band
    wider than the kernels' raises before any launch."""
    lsf, q = _system(rng, 8, 3)
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q)).float()
    n0 = (bd.cholesky_banded.launches, bd.sample_conditional.launches)
    R = bd.cholesky_banded(bands)
    torch.testing.assert_close(R, bd.cholesky_banded_reference(bands),
                               rtol=0, atol=0)
    b = torch.ones(8)
    x = bd.sample_conditional(R, b, b)
    torch.testing.assert_close(x, bd.sample_conditional_reference(R, b, b),
                               rtol=0, atol=0)
    assert (bd.cholesky_banded.launches,
            bd.sample_conditional.launches) == n0
    with pytest.raises(ValueError, match="CUDA"):
        bd.cholesky_banded(bands.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        bd.sample_conditional(R.to("meta"), b.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="bandwidth"):
        bd.cholesky_banded(torch.zeros((4, 12), device="meta"))


#: tolerances of the kernels against their plain versions, float32, of
#: the output's scale: the sums run in another order, and the solves
#: amplify rounding by the system's condition (at the MUSE LSF and the
#: shapes below, the plain float32 factor is up to 8e-6 and the draw
#: 1.2e-4 of its scale off the float64 ones)
CHOL_TOL, SAMPLE_TOL = 1e-4, 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [(), (3,), (40,)])
@pytest.mark.parametrize("L, lw", [(300, 11), (57, 5), (9, 1)])
def test_banded_kernels_match_plain_on_card(L, lw, batch):
    """Both kernels of ``csrc/banded.cu`` against their plain versions on
    the card, float32: one system, a batch within one warp and one over
    two blocks; L = 300 crosses the staged chunks of 32 systems.  The
    MUSE LSF, as the coarse passes see it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the banded kernels have no CPU mode")
    from deconv3d_tpu_torch import MUSE

    rng = np.random.default_rng(3)
    lsf = MUSE().lsf.bank(4750.0 + 1.25 * np.arange(L), cdelt=1.25,
                          width=lw)
    q = rng.random((*batch, L)) + 0.5
    bands = bd.precision_bands(torch.tensor(lsf, dtype=torch.float32),
                               torch.tensor(q, dtype=torch.float32)).cuda()
    n0 = (bd.cholesky_banded.launches, bd.sample_conditional.launches)
    R = bd.cholesky_banded(bands)
    R_ref = bd.cholesky_banded_reference(bands)
    torch.cuda.synchronize()
    torch.testing.assert_close(R, R_ref, rtol=0,
                               atol=CHOL_TOL * float(R_ref.abs().max()))
    b = torch.tensor(rng.standard_normal((*batch, L)),
                     dtype=torch.float32).cuda()
    noise = torch.tensor(rng.standard_normal((*batch, L)),
                         dtype=torch.float32).cuda()
    x = bd.sample_conditional(R_ref, b, noise)
    x_ref = bd.sample_conditional_reference(R_ref, b, noise)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, x_ref, rtol=0,
                               atol=SAMPLE_TOL * float(x_ref.abs().max()))
    assert (bd.cholesky_banded.launches - n0[0],
            bd.sample_conditional.launches - n0[1]) == (1, 1)


@pytest.mark.gpu
def test_block_sweep_on_card_matches_cpu():
    """``sampler='gibbs_block'`` on the card: the factors are one Cholesky
    launch, every color's draw one banded draw launch (f² per sweep), and
    the sweep matches the CPU's on the same problem and Philox draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the banded kernels have no CPU mode")
    import deconv3d_tpu_torch as d3
    from deconv3d_tpu_torch import instruments as ins
    from deconv3d_tpu_torch import sampler as sm
    from deconv3d_tpu_torch.ops import sweep as sw

    gen = np.random.default_rng(2)
    data = (0.1 * gen.standard_normal((16, 6, 6))).astype(np.float32)
    data[8, 3, 3] += 5.0
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.01),
                             crval=4750.0, cdelt=1.25)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cfg = sm.RunConfig(fsf_size=5, lsf_width=5, sampler="gibbs_block",
                       seed=4)
    n_chol = bd.cholesky_banded.launches
    p_gpu = sm.make_problem(cube.to("cuda"), inst, cfg)
    assert bd.cholesky_banded.launches - n_chol == 1
    p_cpu = sm.make_problem(cube, inst, cfg)
    np.testing.assert_allclose(p_gpu.chol.cpu().numpy(), p_cpu.chol.numpy(),
                               rtol=1e-5, atol=1e-6)
    n0 = bd.sample_conditional.launches
    got = sw.gibbs_block_segment(p_gpu, sm.init_state(p_gpu), 2)
    want = sw.gibbs_block_segment_reference(p_cpu, sm.init_state(p_cpu), 2)
    assert bd.sample_conditional.launches - n0 == 2 * p_gpu.n_colors
    for name in ("resid", "clean"):
        w = getattr(want.result.state, name)
        np.testing.assert_allclose(
            getattr(got.result.state, name).cpu().numpy(), w.numpy(),
            rtol=0, atol=1e-4 * float(w.abs().max()), err_msg=name)
    np.testing.assert_allclose(float(got.result.state.chi2),
                               float(want.result.state.chi2), rtol=1e-5)
