"""The port's banded linear algebra (``deconv3d_tpu_torch/ops/banded.py``).

The plain loops against a dense oracle and against the JAX package's
``deconv3d_tpu.ops.banded`` on the same NumPy inputs (float64), the
conditional draw's moments, the wrappers' dispatch (plain on CPU tensors,
the kernel or an error elsewhere), the Cholesky kernel's right-looking
order (``rightlooking_cholesky_reference``: the factor in float64, within
``CHOL_TOL`` in float32 at the MUSE LSF), the kernels' segmented arithmetic
(``segmented_solve_reference``: exact in float64 on ragged splits, and in
float32 at the MUSE LSF within twice the sequential float32 error at the
kernels' own splits), and — marked ``gpu``, deciding inside its body —
the kernels of ``csrc/banded.cu`` against their plain versions on the
card.  JAX is imported inside the tests that compare with it, so
the card's test run (``pytest --noconftest -m gpu``, no JAX there) can
import this file.
"""

import functools

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


def _muse_lsf(L):
    """The MUSE LSF bank at L wavelengths from 4750 Å (lw = 11)."""
    from deconv3d_tpu_torch import MUSE

    return MUSE().lsf.bank(4750.0 + 1.25 * np.arange(L), cdelt=1.25,
                           width=None)


@functools.lru_cache(maxsize=2)
def _muse_factors(L, n):
    """n float64 factors of the MUSE LSF's conditional precisions at L
    wavelengths (q in [1, 2]); made once per L."""
    lsf = _muse_lsf(L)
    q = 1.0 + np.random.default_rng(L).random((n, L))
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q))
    return bd.cholesky_banded_reference(bands)


def test_split_rules_at_the_paths_shapes():
    """The kernels' splits at the shapes their paths launch (lw = 11): the
    draws of 1-324 systems run 32 segments of a warp; the solve splits
    960 columns into blocks of 8 columns × 32 segments, 3720 into 32 × 8,
    and leaves 90,600 (the full field) unsegmented; every split is a power
    of two and keeps max(p, 4) rows a segment where it can."""
    for n, L in ((1, 3681), (4, 3681), (324, 3681), (4, 600), (128, 600)):
        assert bd.segments(n, L, 10) == 32
    assert bd.solve_split(960, 600, 10) == (8, 32)
    assert bd.solve_split(3720, 3681, 10) == (32, 8)
    assert bd.solve_split(90600, 3681, 10) == (32, 1)
    assert bd.segments(90600, 3681, 10, "solve") == 1
    assert bd.segment_rows(600, 32) == 19 and bd.segment_rows(3681, 32) == 117
    for n in (1, 3, 40, 1000, 5000, 40000):
        for L, p in ((9, 0), (57, 4), (300, 10), (3681, 10)):
            S = bd.segments(n, L, p)
            C, Ss = bd.solve_split(n, L, p)
            for k in (S, C, Ss):
                assert k & (k - 1) == 0 and 1 <= k <= 256
            assert S == 1 or S * max(p, 4) <= L
            m = bd.segment_rows(L, S)
            assert m % 2 == 1 and S * m >= L


@pytest.mark.parametrize("L, lw, m", [
    (50, 5, 16),     # L % m != 0
    (7, 4, 16),      # L < m: one segment
    (40, 1, 8),      # p = 0: no state to carry
    (60, 11, 16),    # p = 10
    (30, 6, 30),     # exactly one segment
    (33, 11, 3),     # segments shorter than p
    (600, 11, 19),   # the draw's split at L = 600
])
@pytest.mark.parametrize("kind", ["sample", "solve"])
def test_segmented_arithmetic_is_exact(rng, L, lw, m, kind):
    """The segmented recurrence (zero-state runs, the carry of part + T·in,
    the re-runs) is the sequential solve: float64, rel 1e-10, for the
    draw (systems, noise) and the solve (columns sharing factors)."""
    lsf, q = _system(rng, L, lw, (3,))
    R = bd.cholesky_banded_reference(
        bd.precision_bands(torch.tensor(lsf), torch.tensor(q)))
    if kind == "sample":
        fidx = torch.arange(3)
        b, noise = (torch.tensor(rng.standard_normal((L, 3)))
                    for _ in range(2))
        want = bd.sample_conditional_reference(R, b.T, noise.T).T
    else:
        fidx = torch.tensor([0, 2, 2, 1, 0])
        b, noise = torch.tensor(rng.standard_normal((L, 5))), None
        want = bd.solve_banded_reference(R, fidx, b)
    got = bd.segmented_solve_reference(R, fidx, b, m, noise)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("L, n_path, kind", [
    (600, 4, "sample"),       # gibbs_block: S = 32, m = 19
    (600, 960, "solve"),      # the bench's direct path: S = 32, m = 19
    (3681, 1, "sample"),      # the global coarse pass: S = 32, m = 117
    (3681, 3720, "solve"),    # 60×60×3681 direct: S = 8, m = 461
    (3681, 90600, "solve"),   # the full field direct: S = 1, m = L
])
def test_segmented_float32_at_muse_lsf(rng, L, n_path, kind):
    """At the kernels' own split for the path's batch, the segmented
    arithmetic in float32 at the MUSE LSF is no further from the float64
    solve than twice the sequential float32 solve is (errors of max|x|)."""
    S = bd.segments(n_path, L, 10, kind)
    m = bd.segment_rows(L, S)
    R64 = _muse_factors(L, 3)
    R32 = R64.float()
    if kind == "sample":
        fidx = torch.arange(3)
        b, noise = (torch.tensor(rng.standard_normal((L, 3)))
                    for _ in range(2))
        x64 = bd.sample_conditional_reference(R64, b.T, noise.T).T
        seq = bd.sample_conditional_reference(R32, b.T.float(),
                                              noise.T.float()).T
        seg = bd.segmented_solve_reference(R32, fidx, b.float(), m,
                                           noise.float())
    else:
        fidx = torch.tensor([0, 0, 1, 1, 2, 2])
        b = torch.tensor(rng.standard_normal((L, 6)))
        x64 = bd.solve_banded_reference(R64, fidx, b)
        seq = bd.solve_banded_reference(R32, fidx, b.float())
        seg = bd.segmented_solve_reference(R32, fidx, b.float(), m)
    scale = float(x64.abs().max())
    err_seq = float((seq.double() - x64).abs().max()) / scale
    err_seg = float((seg.double() - x64).abs().max()) / scale
    assert err_seg <= 2 * err_seq, (err_seg, err_seq, S, m)


@pytest.mark.parametrize("L, lw, batch, jitter", [
    (1, 1, (), 0.0), (12, 1, (2,), 0.0), (16, 3, (2,), 1e-3),
    (24, 5, (), 0.0), (32, 11, (3, 2), 0.0), (7, 11, (2,), 1e-3),
])
def test_rightlooking_cholesky_matches_dense_and_jax(rng, L, lw, batch,
                                                     jitter):
    """The Cholesky kernel's order of operations
    (``rightlooking_cholesky_reference``) is the factor: RᵀR == A (the
    dense oracle, ``jitter`` 0) and the JAX package's ``cholesky_banded``
    on the same float64 bands (jitter and L ≤ p included), rel 1e-10."""
    jnp, jbd = _jax()
    lsf, q = _system(rng, L, lw, batch)
    bands = bd.precision_bands(torch.tensor(lsf), torch.tensor(q))
    R = bd.rightlooking_cholesky_reference(bands, jitter)
    Rj = np.asarray(jbd.cholesky_banded(jnp.asarray(bands.numpy()),
                                        jitter=jitter))
    np.testing.assert_allclose(R.numpy(), Rj, rtol=1e-10,
                               atol=1e-10 * np.abs(Rj).max())
    if jitter == 0.0:
        flat_R = R.reshape(-1, L, lw).numpy()
        flat_A = bands.reshape(-1, L, lw).numpy()
        for Rs, As in zip(flat_R, flat_A):
            U, A = _upper_from_bands(Rs), _dense_from_bands(As)
            np.testing.assert_allclose(U.T @ U, A, rtol=1e-10,
                                       atol=1e-12 * np.abs(A).max())


def test_rightlooking_cholesky_zero_rows():
    """A fully masked row (zero precision) takes the pivot floor, as the
    plain loop does: the factor stays finite and equal to it."""
    bands = torch.zeros(2, 9, 4, dtype=torch.float64)
    bands[0, :, 0] = 2.0
    bands[0, :8, 1] = 0.5
    bands[1, 4:, 0] = 1.0
    want = bd.cholesky_banded_reference(bands)
    got = bd.rightlooking_cholesky_reference(bands)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("L", [600, 3681])
def test_rightlooking_cholesky_float32_at_muse_lsf(L):
    """In float32 at the MUSE LSF, the kernel's order of operations is
    within CHOL_TOL of the float64 factor's scale (L = 600: gibbs_block
    and the bench's preconditioner; 3681: the coarse pass and the full
    field's)."""
    lsf = torch.tensor(_muse_lsf(L))
    q = 1.0 + torch.tensor(np.random.default_rng(L).random((3, L)))
    bands = bd.precision_bands(lsf, q)
    R64 = bd.cholesky_banded_reference(bands)
    R32 = bd.rightlooking_cholesky_reference(bands.float())
    err = float((R32.double() - R64).abs().max())
    assert err <= CHOL_TOL * float(R64.abs().max()), err


#: tolerances of the kernels against their plain versions, float32, of
#: the output's scale: the sums run in another order, and the solves
#: amplify rounding by the system's condition (at the MUSE LSF and the
#: shapes below, the plain float32 factor is up to 8e-6 and the draw
#: 1.2e-4 of its scale off the float64 ones)
CHOL_TOL, SAMPLE_TOL = 1e-4, 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("L, lw, batch", [
    *((L, lw, batch) for L, lw in ((300, 11), (57, 5), (9, 1), (600, 11),
                                   (3681, 11))
      for batch in ((), (3,), (40,), (128,))),
    # the paths' own batches: the coarse pass's constants (4 × 3681),
    # gibbs_block's factors (1156 × 600), the direct preconditioner's
    # (480 × 600 on the bench, 256 × 3681 radial at the full field)
    (3681, 11, (4,)), (600, 11, (1156,)), (600, 11, (480,)),
    (3681, 11, (256,)),
])
def test_banded_kernels_match_plain_on_card(L, lw, batch):
    """The kernels of ``csrc/banded.cu`` against their plain versions on
    the card, float32: one system, a batch within one warp and ones over
    several blocks; L = 300 and 57 end the Cholesky inside a chunk of 16
    rows, L = 9 inside its first; the draw's splits of the paths (1 system
    at L = 3681, 128 at 600: 32 segments, the system in shared memory) and
    ragged ones (L = 57, 9); the solve on 2·n + 1 columns that share the n
    factors through ``fidx``; the kernels' split rules == ``segments`` /
    ``solve_split``; and the paths' batches.  The MUSE LSF, as the coarse
    passes see it."""
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
    factors = R_ref.reshape(-1, L, lw)
    nf = factors.shape[0]
    fidx = torch.tensor(rng.integers(0, nf, 2 * nf + 1),
                        dtype=torch.int32).cuda()
    cols = torch.tensor(rng.standard_normal((L, 2 * nf + 1)),
                        dtype=torch.float32).cuda()
    n_solve = bd.banded_solve.launches
    xs = bd.banded_solve(factors, fidx, cols)
    xs_ref = bd.solve_banded_reference(factors, fidx, cols)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs, xs_ref, rtol=0,
                               atol=SAMPLE_TOL * float(xs_ref.abs().max()))
    assert (bd.cholesky_banded.launches - n0[0],
            bd.sample_conditional.launches - n0[1],
            bd.banded_solve.launches - n_solve) == (1, 1, 1)
    from deconv3d_tpu_torch import _build

    lib = _build.load_library()
    n = max(nf, 1)
    assert lib.banded_segments(n, L, lw - 1, 0) == bd.segments(n, L, lw - 1)
    assert lib.banded_segments(cols.shape[1], L, lw - 1, 1) == \
        bd.segments(cols.shape[1], L, lw - 1, "solve")


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
