"""The port's direct sampler and MAP (``deconv3d_tpu_torch/ops/direct.py``).

Float64 on the CPU at ``tests/test_direct.py``'s toy sizes: the operator,
the preconditioners, PCG, the MAP and a draw with injected normals held
against the JAX package's ``deconv3d_tpu.ops.direct`` on the same problem
(built by the JAX ``make_problem`` and carried across with ``interop``);
the port's own ``make_problem`` against the JAX one; the dense oracles
(normal equations, ridge, analytic posterior moments); the run contract
(state, masks, chains, resume); the plain banded solve against
``torch.cholesky_solve``; and — marked ``gpu``, deciding inside its body —
the banded solve kernel against its plain version on the card.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import banded as bd
from deconv3d_tpu_torch.ops import direct as td
from deconv3d_tpu_torch.ops import philox


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These toys are a few hundred voxels: torch's intra-op threads cost
    more than they give (a 4× slower FFT at 8×8), and under a parallel
    test run they contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """(jax.numpy, deconv3d_tpu.sampler, deconv3d_tpu.ops.direct, Cube,
    instruments) in float64 mode."""
    import jax
    import jax.numpy as jnp

    from deconv3d_tpu import Cube, instruments, sampler
    from deconv3d_tpu.ops import direct

    jax.config.update("jax_enable_x64", True)
    return jnp, sampler, direct, Cube, instruments


def _toy_data(rng, L=8, Y=6, X=6, noise=0.5, fsf_fwhm=0.25, lsf_fwhm=1.0,
              fsf_size=3, lsf_width=3):
    """``tests/test_direct.py::_problem``'s cube: one blurred point source
    plus noise, and its FSF / LSF banks."""
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 4.0
    lam = 4750.0 + 1.25 * np.arange(L)
    fsf = tins.GaussianFSF(fwhm=fsf_fwhm).bank(lam, size=fsf_size,
                                               pixel_scale=0.2)
    lsf = tins.GaussianLSF(fwhm=lsf_fwhm).bank(lam, cdelt=1.25,
                                               width=lsf_width)
    conv = d3.convolve_cube(torch.tensor(truth), torch.tensor(fsf),
                            torch.tensor(lsf)).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    return data, fsf, lsf


def _pair(rng, L=8, Y=6, X=6, noise=0.5, fsf_fwhm=0.25, lsf_fwhm=1.0,
          fsf_size=3, lsf_width=3, n=200, mask=None, **cfg_kw):
    """(JAX problem, port problem carried across, port problem of the
    port's make_problem, data, fsf bank, lsf bank) of one toy cube."""
    jnp, jsm, _, JCube, jins = _jax()
    data, fsf, lsf = _toy_data(rng, L, Y, X, noise, fsf_fwhm, lsf_fwhm,
                               fsf_size, lsf_width)
    var = np.full_like(data, noise ** 2)
    cfg = dict(max_iterations=n, burn_in=0, seed=3, dtype=np.float64,
               fsf_size=fsf_size, lsf_width=lsf_width, sampler="direct",
               **cfg_kw)
    jp = jsm.make_problem(
        JCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                        cdelt=1.25, dtype=np.float64),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=fsf_fwhm),
                        lsf=jins.GaussianLSF(fwhm=lsf_fwhm), pixel_scale=0.2),
        jsm.RunConfig(**cfg))
    leaves = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in leaves.items() if k != "config"},
        interop.config_from_mapping(dataclasses.asdict(jp.config)))
    own = tsm.make_problem(
        d3.Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                          cdelt=1.25, dtype=np.float64, device="cpu"),
        tins.Instrument(fsf=tins.GaussianFSF(fwhm=fsf_fwhm),
                        lsf=tins.GaussianLSF(fwhm=lsf_fwhm), pixel_scale=0.2),
        tsm.RunConfig(**cfg), device="cpu")
    return jp, tp, own, data, fsf, lsf


def _dense_K(L, Y, X, fsf, lsf):
    """Dense K [n, n] of the separable forward model (the port's
    ``convolve_cube`` applied to every unit voxel)."""
    n = L * Y * X
    eye = torch.eye(n, dtype=torch.float64).reshape(n, L, Y, X)
    cols = [d3.convolve_cube(e, torch.tensor(fsf), torch.tensor(lsf),
                             spatial="direct").reshape(-1) for e in eye]
    return torch.stack(cols, dim=1).numpy()


def _vec(rng, p):
    return rng.standard_normal((p.L, p.Y, p.X))


# ---------------------------------------------------------------------------
# make_problem, the operator
# ---------------------------------------------------------------------------

def test_make_problem_matches_jax(rng):
    """A direct problem keeps the exact weights and the full FSF, as the
    JAX package's (engine 'jnp'); quad is dropped and its λ-mean kept; the
    two 'auto' ridges resolve from the mean weight; burn-in is 0."""
    jp, tp, own, *_ = _pair(rng, prior_precision="auto")
    for name in ("fsf", "lsf", "data_pad", "w_pad", "quad_mean"):
        np.testing.assert_allclose(getattr(own, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    assert own.quad is None and own.fsf_spec is None and jp.quad is None
    np.testing.assert_array_equal(own.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(own.monitor_idx.numpy(),
                                  np.asarray(jp.monitor_idx))
    assert own.config.prior_precision == pytest.approx(
        jp.config.prior_precision, rel=1e-12)
    assert own.config.prior_precision == pytest.approx(4e-4, rel=1e-6)
    assert own.config.direct_precond_tau == pytest.approx(
        jp.config.direct_precond_tau, rel=1e-12)
    assert own.config.resolved_burn_in() == 0
    assert tsm.RunConfig(sampler="direct", burn_in=10).resolved_burn_in() \
        == 10
    assert tsm.RunConfig(max_iterations=100).resolved_burn_in() == 50
    # init_state reads quad_mean where quad is gone
    js = _jax()[1].init_state(jp)
    np.testing.assert_allclose(tsm.init_state(own).log_scale.numpy(),
                               np.asarray(js.log_scale), rtol=1e-12)


@pytest.mark.parametrize("spatial", ["auto", "direct"])
def test_operators_match_jax_and_are_adjoint(rng, spatial):
    """K, Kᵀ against the JAX package's on the same vectors (rel 1e-12),
    ⟨Ka, b⟩ = ⟨a, Kᵀb⟩, and both against the dense K."""
    jnp, _, jdr, *_ = _jax()
    jp, tp, _, _, fsf, lsf = _pair(rng, direct_spatial=spatial)
    a, b = _vec(rng, tp), _vec(rng, tp)
    Ka = td.apply_K(tp, torch.tensor(a)).numpy()
    KTb = td.apply_KT(tp, torch.tensor(b)).numpy()
    np.testing.assert_allclose(Ka, np.asarray(jdr.apply_K(jp, jnp.asarray(a))),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(
        KTb, np.asarray(jdr.apply_KT(jp, jnp.asarray(b))), rtol=1e-12,
        atol=1e-13)
    lhs, rhs = float((Ka * b).sum()), float((a * KTb).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
    K = _dense_K(tp.L, tp.Y, tp.X, fsf, lsf)
    np.testing.assert_allclose(Ka.ravel(), K @ a.ravel(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(KTb.ravel(), K.T @ b.ravel(), rtol=1e-10,
                               atol=1e-12)


def test_lsf_band_transpose_matches_matrix(rng):
    """Above L = 2048 the operator applies Mᵀ as a band loop; it is the
    matrix's transpose."""
    L, lw = 40, 5
    lsf = torch.tensor(rng.random((L, lw)))
    x = torch.tensor(rng.standard_normal((L, 3, 4)))
    M = torch.tensor(d3.convolve.lsf_matrix(lsf.numpy()))
    np.testing.assert_allclose(td._lsf_T(x, lsf).numpy(),
                               (M.T @ x.reshape(L, -1)).reshape(x.shape)
                               .numpy(), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_normal_operator_matches_jax_and_dense(rng, tau):
    """A = P(KᵀWK + τI)P against the JAX package's and the dense oracle."""
    jnp, _, jdr, *_ = _jax()
    jp, tp, _, _, fsf, lsf = _pair(rng, prior_precision=tau)
    v = _vec(rng, tp)
    got = td.make_normal_operator(tp)(torch.tensor(v)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdr.make_normal_operator(jp)(jnp.asarray(v))),
        rtol=1e-12, atol=1e-12)
    n = tp.L * tp.Y * tp.X
    K = _dense_K(tp.L, tp.Y, tp.X, fsf, lsf)
    A = K.T @ K / 0.25 + tau * np.eye(n)
    np.testing.assert_allclose(got.ravel(), A @ v.ravel(), rtol=1e-8,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# Preconditioners
# ---------------------------------------------------------------------------

PRECONDS = [("jacobi", False), ("banded", False), ("banded_radial", False),
            ("banded", True), ("banded_radial", True)]


@pytest.mark.parametrize("mode, scale", PRECONDS)
@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_preconditioner_matches_jax(rng, mode, scale, tau):
    """M⁻¹ r of every mode (with the diagonal scaling, with and without a
    ridge) against the JAX package's on the same r, rel 1e-10; the radial
    mode with fewer bins than frequencies, a masked spaxel."""
    jnp, _, jdr, *_ = _jax()
    mask = np.zeros((10, 12), bool)
    mask[2, 7] = True
    jp, tp, *_ = _pair(rng, L=12, Y=10, X=12, fsf_fwhm=0.4, fsf_size=5,
                       lsf_width=5, prior_precision=tau, direct_precond=mode,
                       direct_precond_scale=scale, direct_radial_bins=7,
                       mask=mask)
    r = _vec(rng, tp)
    got = td.make_preconditioner(tp)(torch.tensor(r)).numpy()
    want = np.asarray(jdr.make_preconditioner(jp)(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("Y, X, n_bins", [(6, 6, 256), (16, 16, 256),
                                          (10, 12, 7), (9, 14, 5),
                                          (30, 30, 256), (33, 20, 1)])
def test_radial_bins_match_jax_layout(Y, X, n_bins):
    """The bin of every frequency, the bin count and the counts equal the
    JAX package's ``_radial_layout``, exactly."""
    _, _, jdr, *_ = _jax()
    B, bins, counts = td.radial_bins(Y, X, n_bins)
    jB, _, jbins, jcounts, _, _ = jdr._radial_layout(Y, X, n_bins)
    assert B == jB
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(counts, jcounts)


def test_banded_auto_switches_to_radial(rng, monkeypatch):
    """Above the factor budget 'banded' resolves to 'banded_radial' (the
    budget monkeypatched as in the JAX package's test)."""
    _, tp, *_ = _pair(rng)
    assert td._resolve_precond_mode(tp) == "banded"
    monkeypatch.setattr(td, "BANDED_BYTES_BUDGET", 16)
    assert td._resolve_precond_mode(tp) == "banded_radial"
    M = td.make_preconditioner(tp)
    B = td.radial_bins(tp.Y, tp.X, td.N_RADIAL_BINS)[0]
    state = tsm.cached(tp, ("precond", "banded_radial", 0.0), None)
    assert state.mode == "banded_radial" and state.R.shape[0] == B
    assert torch.isfinite(M(torch.ones(tp.L, tp.Y, tp.X,
                                       dtype=torch.float64))).all()
    with pytest.raises(ValueError, match="direct_precond"):
        td._resolve_precond_mode(tp, "bogus")


def test_suggest_prior_precision(rng):
    """τ = 1e-4·w̄ over the free voxels, as the JAX package's; masked
    spaxels do not dilute it; 'auto' resolves to it in make_problem."""
    jp, tp, *_ = _pair(rng)
    _, _, jdr, *_ = _jax()
    assert td.suggest_prior_precision(tp) == pytest.approx(
        jdr.suggest_prior_precision(jp), rel=1e-12)
    assert td.suggest_prior_precision(tp) == pytest.approx(4e-4, rel=1e-6)
    assert td.suggest_prior_precision(tp, rel=1e-2) == pytest.approx(
        4e-2, rel=1e-6)
    with pytest.raises(ValueError, match="rel"):
        td.suggest_prior_precision(tp, rel=0.0)
    mask = np.zeros((6, 6), bool)
    mask[:3] = True
    _, _, own, *_ = _pair(rng, mask=mask, prior_precision="auto")
    assert own.config.prior_precision == pytest.approx(4e-4, rel=1e-6)
    assert d3.suggest_prior_precision is td.suggest_prior_precision


# ---------------------------------------------------------------------------
# PCG, the MAP, a draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode, tau", [("banded", 0.0), ("jacobi", 0.0),
                                       ("banded_radial", 0.3),
                                       ("banded", 0.3)])
def test_posterior_mean_matches_jax(rng, mode, tau):
    """The same PCG from the same start on the same operator: the port's
    iterate after the JAX package's iteration count agrees with its
    solution (rel 1e-8 of its scale; iteration counts within 1), and both
    solve the dense normal equations."""
    _, _, jdr, *_ = _jax()
    jp, tp, _, data, fsf, lsf = _pair(rng, prior_precision=tau,
                                      direct_precond=mode, direct_tol=1e-10,
                                      direct_maxiter=2000)
    want = jdr.posterior_mean(jp)
    got = td.posterior_mean(tp)
    assert got.rel_residual <= 1e-10
    assert abs(got.iterations - int(want.iterations)) <= 1
    x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x, rtol=0,
                               atol=1e-8 * np.abs(x).max())
    n = tp.L * tp.Y * tp.X
    K = _dense_K(tp.L, tp.Y, tp.X, fsf, lsf)
    mean = np.linalg.solve(K.T @ K / 0.25 + tau * np.eye(n),
                           K.T @ data.ravel() / 0.25)
    np.testing.assert_allclose(got.x.numpy().ravel(), mean, rtol=1e-6,
                               atol=1e-7)


def test_float32_posterior_mean_refines_to_the_float64_residual(
        monkeypatch):
    """A float32 MAP under heavy blur (8×8×12, f = 7, 'auto' τ): the
    float32 recurrence reaches tol = 1e-6 while b − A x in float64 has
    not, so at least one refinement round runs.  The returned residual is
    the float64 one of the returned x (rel 1e-6) and ≤ tol; the solution
    agrees with the JAX package's float64 MAP (tol 1e-10) to 2e-5 of its
    scale.  With no rounds allowed the solve is the plain PCG's, and its
    float64 residual is reported as such."""
    _, jsm, jdr, JCube, jins = _jax()
    data, *_ = _toy_data(np.random.default_rng(0), L=12, Y=8, X=8,
                         fsf_fwhm=0.9, lsf_fwhm=2.0, fsf_size=7,
                         lsf_width=5)
    data = data.astype(np.float32)
    var = np.full_like(data, 0.25)
    cfg = dict(fsf_size=7, lsf_width=5, sampler="direct",
               prior_precision="auto", direct_tol=1e-6, direct_maxiter=2000)
    p = tsm.make_problem(
        d3.Cube.from_data(data, variance=var, crval=4750.0, cdelt=1.25,
                          device="cpu"),
        tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.9),
                        lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
        tsm.RunConfig(**cfg), device="cpu")
    jp = jsm.make_problem(
        JCube.from_data(data.astype(np.float64), variance=var.astype(
            np.float64), crval=4750.0, cdelt=1.25, dtype=np.float64),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.9),
                        lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
        jsm.RunConfig(dtype=np.float64, **{**cfg, "direct_tol": 1e-10}))
    assert p.config.prior_precision == pytest.approx(
        jp.config.prior_precision, rel=1e-7)
    p64 = td._float64(p)
    b64 = td.apply_KT(p64, td._d_in(p64) * td._w_in(p64)) * td._free_mask(
        p64)
    A64 = td.make_normal_operator(p64)

    def rel64(x):
        return float((b64 - A64(x.double())).norm() / b64.norm())

    A, M = td.make_normal_operator(p), td.make_preconditioner(p)
    b = td.apply_KT(p, td._d_in(p) * td._w_in(p)) * td._free_mask(p)
    plain = td.pcg(A, M, b, 1e-6, 2000)
    assert plain.rel_residual <= 1e-6 < rel64(plain.x)
    res = td.posterior_mean(p)
    assert res.x.dtype == torch.float32
    assert res.iterations > plain.iterations
    assert res.rel_residual <= 1e-6
    assert res.rel_residual == pytest.approx(rel64(res.x), rel=1e-6)
    want = np.asarray(jdr.posterior_mean(jp).x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    monkeypatch.setattr(td, "MAX_REFINE", 0)
    once = td.posterior_mean(p)
    assert once.iterations == plain.iterations
    assert once.rel_residual == pytest.approx(rel64(plain.x), rel=1e-6)
    assert once.rel_residual > 1e-6


def test_pcg_stops_at_maxiter_and_at_zero_rhs(rng):
    """maxiter bounds the loop (rel reported, not converged); a zero
    right-hand side returns x = 0 after no iteration."""
    _, tp, *_ = _pair(rng)
    A, M = td.make_normal_operator(tp), td.make_preconditioner(tp)
    b = torch.tensor(_vec(rng, tp)) * td._free_mask(tp)
    res = td.pcg(A, M, b, 1e-14, 3)
    assert res.iterations == 3 and res.rel_residual > 1e-14
    zero = td.pcg(A, M, torch.zeros_like(b), 1e-6, 50)
    assert zero.iterations == 0 and float(zero.x.abs().max()) == 0.0


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_draw_matches_jax_composition(rng, tau):
    """One draw with injected z / z2 against the JAX package's composition
    of the same draw (``_one_draw``'s b = Kᵀ(Wd + √w z) + √τ z2, then
    ``pcg``), rel 1e-8; the state afterwards: resid = data − K·clean on
    the weighted voxels, χ² from scratch, counts raised by the free
    voxels, the accept trace the convergence flag."""
    jnp, jsm, jdr, *_ = _jax()
    jp, tp, *_ = _pair(rng, prior_precision=tau, direct_tol=1e-11,
                       direct_maxiter=1000)
    z, z2 = _vec(rng, tp), _vec(rng, tp)
    h = jp.f // 2
    d = jp.data_pad[:, h : h + jp.Y, h : h + jp.X]
    w = jdr._w_in(jp)
    free = jdr._free_mask(jp)
    b = jdr.apply_KT(jp, d * w + jnp.sqrt(w) * jnp.asarray(z)) * free
    if tau > 0:
        b = b + jnp.sqrt(tau) * jnp.asarray(z2) * free
    want = jdr.pcg(jdr.make_normal_operator(jp), jdr.make_preconditioner(jp),
                   b, 1e-11, 1000)
    state = tsm.init_state(tp)
    res = td.direct_run_sweeps(
        tp, state, 1, normals=(torch.tensor(z)[None],
                               torch.tensor(z2)[None] if tau > 0 else None))
    x = np.asarray(want.x)
    clean = res.state.clean.numpy()
    np.testing.assert_allclose(clean[:, : tp.Y, : tp.X], x, rtol=0,
                               atol=1e-8 * np.abs(x).max())
    assert np.all(clean[:, tp.Y:, :] == 0) and np.all(clean[:, :, tp.X:] == 0)
    st = res.state
    full = float(tsm.full_chi2(tp, st))
    assert float(st.chi2) == pytest.approx(full, rel=1e-6)
    conv = td.apply_K(tp, st.clean[:, : tp.Y, : tp.X])
    want_resid = tp.data_pad.clone()
    want_resid[:, h : h + tp.Y, h : h + tp.X] -= conv
    want_resid = torch.where(tp.w_pad > 0, want_resid, 0.0)
    np.testing.assert_allclose(st.resid.numpy(), want_resid.numpy(),
                               rtol=0, atol=1e-12)
    n_free = float(tp.valid.sum()) * tp.L
    assert float(st.n_accept) == float(st.n_propose) == n_free
    assert int(st.sweep) == 1 and float(st.n_kept) == 1.0
    assert res.accept_trace.tolist() == [1.0]
    np.testing.assert_array_equal(st.sum_clean.numpy(), clean)
    np.testing.assert_array_equal(st.log_scale.numpy(),
                                  state.log_scale.numpy())


def test_philox_normals_follow_the_stream_layout():
    """``cube_normals`` takes word λ & 3 of the block at (λ >> 2, sweep, 0,
    stream << 24 | y·X + x), as the port's other streams, with λ chunks
    that do not divide L; Box-Muller of the stream pair."""
    L, Y, X = 11, 3, 5
    key, sweep = 0x1234_5678_9abc, 7
    u1, u2 = (philox._slot_uniforms(key, sweep, torch.tensor([0]), Y * X, L,
                                    s)[0].T.reshape(L, Y, X)
              for s in (philox.STREAM_DRAW_U1, philox.STREAM_DRAW_U2))
    want = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        torch.tensor(2.0 * torch.pi, dtype=torch.float32) * u2)
    old = philox.NORMALS_CHUNK_L
    try:
        philox.NORMALS_CHUNK_L = 4
        got = philox.cube_normals(key, sweep, (philox.STREAM_DRAW_U1,
                                               philox.STREAM_DRAW_U2),
                                  L, Y, X)
    finally:
        philox.NORMALS_CHUNK_L = old
    assert torch.equal(got, want)
    whole = philox.cube_normals(key, sweep, (philox.STREAM_DRAW_U1,
                                             philox.STREAM_DRAW_U2), L, Y, X)
    assert torch.equal(whole, want)
    other = philox.cube_normals(key, sweep + 1, (philox.STREAM_DRAW_U1,
                                                 philox.STREAM_DRAW_U2),
                                L, Y, X)
    assert not torch.equal(other, want)
    assert len({philox.STREAM_DRAW_U1, philox.STREAM_DRAW_U2,
                philox.STREAM_PRIOR_U1, philox.STREAM_PRIOR_U2,
                philox.STREAM_BLOCK_U1, philox.STREAM_BLOCK_U2,
                philox.STREAM_PASS_ACCEPT}) == 7


# ---------------------------------------------------------------------------
# The run contract
# ---------------------------------------------------------------------------

def test_segmented_equals_unbroken_and_chain_alone_equals_batch(rng):
    """Philox keyed by the chain key and the absolute sweep: 2 + 3 draws
    equal 5 draws, bit for bit, and a chain of a batch equals the chain
    alone."""
    _, _, own, *_ = _pair(rng, n=5, direct_tol=1e-9, direct_maxiter=400)
    whole = tsm.run_sweeps(own, tsm.init_state(own), 5)
    a = tsm.run_sweeps(own, tsm.init_state(own), 2)
    b = tsm.run_sweeps(own, a.state, 3)
    for name in ("clean", "resid", "sum_clean", "sum_sq"):
        assert torch.equal(getattr(b.state, name),
                           getattr(whole.state, name)), name
    assert torch.equal(torch.cat([a.chi2_trace, b.chi2_trace]),
                       whole.chi2_trace)
    assert int(b.state.sweep) == 5
    mc = ch.run_chains(own, 3, n_sweeps=3)
    for c in (0, 2):
        alone = tsm.run_sweeps(
            own, ch.select_chains(ch.init_chain_states(own, 3), c), 3)
        assert torch.equal(mc.result.state.clean[c], alone.state.clean)
        assert torch.equal(mc.result.chi2_trace[c], alone.chi2_trace)
    assert not torch.equal(mc.result.state.clean[0], mc.result.state.clean[1])


def test_resume_equals_unbroken_run(rng, tmp_path):
    """A Run checkpointed after 2 draws and resumed for 2 more equals 4
    draws in one run, bit for bit."""
    data, *_ = _toy_data(rng)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                             crval=4750.0, cdelt=1.25, dtype=np.float64,
                             device="cpu")
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                           lsf=tins.GaussianLSF(fwhm=1.0), pixel_scale=0.2)
    kw = dict(max_iterations=4, sampler="direct", fsf_size=3, lsf_width=3,
              dtype=np.float64, device="cpu", seed=5)
    whole = d3.Run(cube, inst, **kw).run()
    path = str(tmp_path / "ck.npz")
    first = d3.Run(cube, inst, checkpoint_path=path, **kw)
    first.run(2)
    second = d3.Run(cube, inst, checkpoint_path=path, **kw).resume()
    second.run(2)
    assert second.sweeps_done == 4
    assert torch.equal(second.states.clean, whole.states.clean)
    np.testing.assert_array_equal(second.trace("chi2"),
                                  whole.trace("chi2")[:, 2:])


def test_masked_spaxels_frozen_and_ignored(rng):
    """A masked spaxel stays 0 in every draw and accumulator, and what its
    data holds changes nothing."""
    mask = np.zeros((6, 6), bool)
    mask[1, 4] = True

    def run_with(value):
        data, *_ = _toy_data(np.random.default_rng(0))
        data[:, 1, 4] = value
        cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                                 mask=mask, crval=4750.0, cdelt=1.25,
                                 dtype=np.float64, device="cpu")
        inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                               lsf=tins.GaussianLSF(fwhm=1.0),
                               pixel_scale=0.2)
        p = tsm.make_problem(cube, inst, tsm.RunConfig(
            max_iterations=4, seed=3, dtype=np.float64, fsf_size=3,
            lsf_width=3, sampler="direct", direct_tol=1e-8), device="cpu")
        return p, tsm.run_sweeps(p, tsm.init_state(p), 3)

    p1, r1 = run_with(0.0)
    assert not bool(p1.valid[1, 4])
    assert r1.accept_trace.tolist() == [1.0] * 3
    assert np.all(r1.state.clean.numpy()[:, 1, 4] == 0.0)
    assert np.all(r1.state.sum_clean.numpy()[:, 1, 4] == 0.0)
    _, r2 = run_with(1e6)
    assert torch.equal(r1.state.clean, r2.state.clean)
    assert float(r1.state.chi2) == float(r2.state.chi2)


def test_refusals(rng):
    """Positivity with direct, a ridge prior on an MCMC sampler, a negative
    τ, bad knobs, and a tiled engine for direct raise."""
    data, *_ = _toy_data(rng)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                             crval=4750.0, cdelt=1.25, device="cpu")
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                           lsf=tins.GaussianLSF(fwhm=1.0), pixel_scale=0.2)

    def make(**kw):
        return tsm.make_problem(cube, inst, tsm.RunConfig(
            fsf_size=3, lsf_width=3, **kw), device="cpu")

    with pytest.raises(ValueError, match="direct"):
        make(sampler="direct", positivity=True)
    for sampler in ("mh", "gibbs", "gibbs_block"):
        with pytest.raises(ValueError, match="prior_precision"):
            make(sampler=sampler, prior_precision=1.0)
        with pytest.raises(ValueError, match="prior_precision"):
            make(sampler=sampler, prior_precision="auto")
    for kw, what in ((dict(prior_precision=-1.0), "prior_precision"),
                     (dict(prior_precision="big"), "prior_precision"),
                     (dict(direct_radial_bins=0), "direct_radial_bins"),
                     (dict(direct_spatial="fast"), "direct_spatial"),
                     (dict(direct_precond_tau=-1.0), "direct_precond_tau"),
                     (dict(direct_precond_tau="x"), "direct_precond_tau"),
                     (dict(engine="torch_tiled"), "engine"),
                     (dict(tile=(1, 1)), "tile")):
        with pytest.raises(ValueError, match=what):
            make(sampler="direct", **kw)
    with pytest.raises(ValueError, match="sampler"):
        make(sampler="nuts")
    p = make(sampler="direct")
    assert p.config.engine == "torch" and p.config.tile is None


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_draw_moments_match_analytic_posterior(rng, tau):
    """Draws through ``Run(sampler='direct')`` against the dense float64
    posterior N(A⁻¹KᵀWd, A⁻¹): the mean's z-scores (mean |z| < 2, max <
    5.5), the median std ratio within 15%, every solve converged."""
    n = 200
    data, fsf, lsf = _toy_data(rng)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                             crval=4750.0, cdelt=1.25, dtype=np.float64,
                             device="cpu")
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                           lsf=tins.GaussianLSF(fwhm=1.0), pixel_scale=0.2)
    run = d3.Run(cube, inst, max_iterations=n, sampler="direct", fsf_size=3,
                 lsf_width=3, dtype=np.float64, device="cpu", seed=11,
                 prior_precision=tau, direct_tol=1e-8)
    run.run()
    nvox = data.size
    K = _dense_K(*data.shape, fsf, lsf)
    cov = np.linalg.inv(K.T @ K / 0.25 + tau * np.eye(nvox))
    mean = cov @ K.T @ data.ravel() / 0.25
    sig = np.sqrt(np.diag(cov))
    pm = run.deconvolved_cube().data.numpy().ravel()
    ps = np.sqrt(run.deconvolved_cube().variance.numpy().ravel())
    z = (pm - mean) / (sig / np.sqrt(n))
    assert np.abs(z).mean() < 2.0, np.abs(z).mean()
    assert np.abs(z).max() < 5.5, np.abs(z).max()
    assert abs(np.median(ps / sig) - 1.0) < 0.15
    assert run.trace("accept").min() == 1.0
    assert run.acceptance_rate == 1.0
    ess = ch.effective_sample_size(run.trace("flux"))
    assert ess > 0.5 * n, ess


def test_ridge_restores_convergence_under_heavy_blur(rng):
    """The case the ridge is for: under heavy blur the flat-prior solve
    stalls; a weak ridge, and the 'auto' one, converge."""
    kw = dict(Y=16, X=16, L=16, fsf_fwhm=0.9, fsf_size=9, lsf_fwhm=2.0,
              lsf_width=5, direct_tol=1e-6)
    _, _, flat, *_ = _pair(rng, direct_maxiter=250, **kw)
    _, _, ridge, *_ = _pair(rng, direct_maxiter=250, prior_precision=1e-2,
                            **kw)
    _, _, auto, *_ = _pair(rng, direct_maxiter=1000, prior_precision="auto",
                           **kw)
    assert td.posterior_mean(flat).rel_residual > 1e-3
    assert td.posterior_mean(ridge).rel_residual <= 1e-6
    assert td.posterior_mean(auto).rel_residual <= 1e-6


# ---------------------------------------------------------------------------
# Run: map_estimate, warnings, chains
# ---------------------------------------------------------------------------

def _run_pair(rng, sampler="mh", jax_engine="auto", **kw):
    """The JAX ``Run`` (on ``jax_engine``) and the port's ``Run`` on one
    toy cube (f = 3)."""
    import deconv3d_tpu as jd3

    _, _, _, JCube, jins = _jax()
    data, *_ = _toy_data(rng, noise=0.2)
    var = np.full_like(data, 0.04)
    args = dict(max_iterations=10, sampler=sampler, fsf_size=3, lsf_width=3,
                dtype=np.float64, **kw)
    jrun = jd3.Run(JCube.from_data(data, variance=var, crval=4750.0,
                                   cdelt=1.25, dtype=np.float64),
                   jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.25),
                                   lsf=jins.GaussianLSF(fwhm=1.0),
                                   pixel_scale=0.2), engine=jax_engine,
                   **args)
    trun = d3.Run(d3.Cube.from_data(data, variance=var, crval=4750.0,
                                    cdelt=1.25, dtype=np.float64,
                                    device="cpu"),
                  tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                                  lsf=tins.GaussianLSF(fwhm=1.0),
                                  pixel_scale=0.2), device="cpu", **args)
    return jrun, trun


@pytest.mark.parametrize("sampler, tau", [("mh", None), ("mh", 0.3),
                                          ("direct", "auto"),
                                          ("gibbs", "auto")])
def test_map_estimate_matches_jax(rng, sampler, tau):
    """``Run.map_estimate`` against the JAX package's on the same cube,
    with no ridge, a ridge override and 'auto': the resolved τ, the
    solution (rel 1e-7 of its scale), a converged solve, a ``Cube`` on
    the cube's wavelengths; no chain state is built.  An MCMC run keeps
    its own problem (bf16-valued weights, low-rank FSF; the JAX package's
    pallas engine) — both packages solve on that."""
    engine = "auto" if sampler == "direct" else "pallas"
    jrun, trun = _run_pair(rng, sampler, jax_engine=engine, direct_tol=1e-10)
    np.testing.assert_array_equal(trun.problem.w_pad.numpy(),
                                  np.asarray(jrun.problem.w_pad))
    jm = jrun.map_estimate(prior_precision=tau)
    tm = trun.map_estimate(prior_precision=tau)
    assert isinstance(tm, d3.Cube)
    assert trun._states is None
    assert trun.last_map_prior_precision == pytest.approx(
        jrun.last_map_prior_precision, rel=1e-10)
    want = np.asarray(jm.data)
    np.testing.assert_allclose(tm.data.numpy(), want, rtol=0,
                               atol=1e-7 * np.abs(want).max())
    assert trun.last_map_result.rel_residual <= 1e-10
    np.testing.assert_array_equal(tm.wavelengths(), trun.cube.wavelengths())


def test_map_estimate_refuses_positivity_and_warns(rng, caplog):
    """positivity has no Gaussian MAP; a solve cut by maxiter warns."""
    _, trun = _run_pair(rng, "mh", positivity=True)
    with pytest.raises(ValueError, match="positivity"):
        trun.map_estimate()
    _, trun = _run_pair(rng, "mh")
    with caplog.at_level(logging.WARNING, logger="deconv3d_tpu_torch"):
        trun.map_estimate(maxiter=2, tol=1e-12)
    assert "did not converge" in caplog.text
    assert trun.last_map_result.iterations == 2


def test_run_direct_end_to_end_and_warnings(rng, tmp_path, caplog):
    """``Run(sampler='direct')`` → run → diagnostics → save; burn-in 0, so
    every draw is kept; an unconverged segment warns with the ridge hint,
    and the under-mixing check does not run for iid draws."""
    data, *_ = _toy_data(rng, noise=0.2)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.04),
                             crval=4750.0, cdelt=1.25, dtype=np.float64,
                             device="cpu")
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                           lsf=tins.GaussianLSF(fwhm=1.0), pixel_scale=0.2)
    run = d3.Run(cube, inst, max_iterations=6, sampler="direct", fsf_size=3,
                 lsf_width=3, dtype=np.float64, device="cpu")
    run.run()
    diag = run.diagnostics()
    assert diag["sweeps"] == 6 and diag["acceptance_rate"] == 1.0
    assert float(run.states.n_kept.sum()) == 6.0
    m = run.deconvolved_cube().data.numpy()
    assert abs(m[4, 3, 3] - 4.0) < 1.0
    run.save(str(tmp_path / "direct"))
    for suffix in ("_clean.fits", "_std.fits", "_stats.json", "_traces.npz"):
        assert (tmp_path / f"direct{suffix}").is_file()

    stalled = d3.Run(cube, inst, max_iterations=120, sampler="direct",
                     fsf_size=3, lsf_width=3, dtype=np.float64,
                     device="cpu", direct_maxiter=1, segment_size=120)
    with caplog.at_level(logging.WARNING, logger="deconv3d_tpu_torch"):
        stalled.run()
    assert "did NOT reach direct_tol" in caplog.text
    assert "prior_precision=" in caplog.text
    assert "ESS" not in caplog.text


def test_blur_warning_names_the_point_estimates(caplog):
    """The small-field blur warning routes to map_estimate() and
    sampler='direct' as the JAX package's does."""
    cube = d3.Cube.from_data(np.zeros((4, 20, 20), np.float32),
                             variance=np.ones((4, 20, 20), np.float32),
                             crval=4750.0, cdelt=1.25, device="cpu")
    with caplog.at_level(logging.WARNING, logger="deconv3d_tpu_torch"):
        d3.Run(cube, d3.MUSE(), device="cpu")
    assert "Use map_estimate() or sampler='direct'" in caplog.text
    assert "not ported" not in caplog.text


def test_direct_chains_refused_beyond_free_memory(rng, monkeypatch):
    """n_chains > 1 with sampler='direct' raises where one draw's working
    set exceeds the card's free memory (the JAX package's full-field
    ValueError); one chain runs, and so do several where they fit."""
    _, _, own, *_ = _pair(rng, n=2, direct_tol=1e-8, direct_maxiter=400)
    assert ch.run_chains(own, 2, n_sweeps=1).result.state.clean.shape[0] == 2
    monkeypatch.setattr(ch, "device_free_bytes",
                        lambda device: td.draw_bytes(own) - 1)
    with pytest.raises(ValueError, match="iid"):
        ch.run_chains(own, 2, n_sweeps=1)
    assert ch.run_chains(own, 1, n_sweeps=1).result.state.clean.shape[0] == 1


# ---------------------------------------------------------------------------
# The banded solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L, lw, n_fac, n", [(1, 1, 1, 3), (12, 1, 2, 5),
                                             (16, 3, 3, 8), (40, 5, 4, 9),
                                             (64, 11, 5, 14)])
def test_plain_solve_matches_cholesky_solve(rng, L, lw, n_fac, n):
    """``solve_banded_reference`` (columns naming shared factors) against
    ``torch.cholesky_solve`` with the dense factor of each column's
    matrix, float64, rel 1e-10."""
    lsf = torch.tensor(rng.random((L, lw)) + 0.1)
    q = torch.tensor(rng.random((n_fac, L)) + 0.5)
    R = bd.cholesky_banded_reference(bd.precision_bands(lsf, q))
    fidx = torch.tensor(rng.integers(0, n_fac, n), dtype=torch.int32)
    b = torch.tensor(rng.standard_normal((L, n)))
    x = bd.solve_banded_reference(R, fidx, b)
    for j in range(n):
        U = torch.zeros((L, L), dtype=torch.float64)
        for k in range(lw):
            U += torch.diag(R[int(fidx[j]), : L - k, k], k)
        want = torch.cholesky_solve(b[:, j : j + 1], U, upper=True)[:, 0]
        np.testing.assert_allclose(x[:, j].numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))
    # the same as the per-system solves of ops/banded.py on R[fidx]
    Rj = R[fidx.long()]
    want = bd.solve_banded(Rj, bd.solve_transposed_banded(Rj, b.T)).T
    torch.testing.assert_close(x, want, rtol=1e-12, atol=1e-12)


def test_banded_solve_dispatch(rng):
    """CPU tensors take the plain loops (no launch counted, ``out`` filled
    in place); a tensor on no CUDA device, a wrong ``fidx`` or a wide band
    raise — no plain fallback off the CPU."""
    lsf = torch.tensor(rng.random((8, 3)), dtype=torch.float32)
    R = bd.cholesky_banded(bd.precision_bands(
        lsf, torch.tensor(rng.random((2, 8)) + 0.5, dtype=torch.float32)))
    fidx = torch.tensor([0, 1, 1], dtype=torch.int32)
    b = torch.tensor(rng.standard_normal((8, 3)), dtype=torch.float32)
    n0 = bd.banded_solve.launches
    x = bd.banded_solve(R, fidx, b)
    torch.testing.assert_close(x, bd.solve_banded_reference(R, fidx, b),
                               rtol=0, atol=0)
    y = b.clone()
    assert bd.banded_solve(R, fidx, y, out=y) is y
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert bd.banded_solve.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        bd.banded_solve(R.to("meta"), fidx.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="bandwidth"):
        bd.banded_solve(torch.zeros((2, 8, 12), device="meta"),
                        fidx.to("meta"), b.to("meta"))


#: the solve kernel against its plain version, float32, of the output's
#: scale: the banded draw's tolerance (two solves amplify rounding by the
#: system's condition)
SOLVE_TOL = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("L, lw, n_fac, n", [(300, 11, 40, 80),
                                             (57, 5, 3, 1000), (9, 1, 1, 7)])
def test_banded_solve_kernel_matches_plain_on_card(L, lw, n_fac, n):
    """``banded_solve_kernel`` against its plain version on the card,
    float32 (shared factors, columns out of factor order, in place too),
    one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the banded kernels have no CPU mode")
    rng = np.random.default_rng(4)
    lsf = d3.MUSE().lsf.bank(4750.0 + 1.25 * np.arange(L), cdelt=1.25,
                             width=lw)
    q = rng.random((n_fac, L)) + 0.5
    R = bd.cholesky_banded(bd.precision_bands(
        torch.tensor(lsf, dtype=torch.float32),
        torch.tensor(q, dtype=torch.float32)).cuda())
    fidx = torch.tensor(rng.integers(0, n_fac, n), dtype=torch.int32).cuda()
    b = torch.tensor(rng.standard_normal((L, n)), dtype=torch.float32).cuda()
    n0 = bd.banded_solve.launches
    x = bd.banded_solve(R, fidx, b)
    want = bd.solve_banded_reference(R, fidx, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, want, rtol=0,
                               atol=SOLVE_TOL * float(want.abs().max()))
    y = b.clone()
    bd.banded_solve(R, fidx, y, out=y)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert bd.banded_solve.launches - n0 == 2
