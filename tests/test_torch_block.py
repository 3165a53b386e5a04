"""``sampler='gibbs_block'``: whole-spectrum conditional draws per spaxel.

The JAX package has no Pallas kernel for it (its ``lax.scan`` banded
solves run on the jnp engine).  The reference is its ``make_problem``
Cholesky factors and a composition of its per-color pieces
(``_make_block_gibbs_step``: ``_chunked_lin``, ``_lsf_apply_T_lastaxis``,
``ops/banded.py::sample_conditional``, ``_lsf_apply_lastaxis``,
``_chunked_commit``, ``_color_update``) fed the same Box-Muller normals,
on one kernel-engine problem carried across with ``interop``.
Tolerances: factors rel 1e-10 (float64); one float32 sweep: residual and
clean atol 1e-4·max|·| (two banded solves of 16 rows in float32), χ²
rtol 1e-5, voxel counts equal.  Then the port's mirrors of
``tests/test_gibbs_block.py`` (invariant, analytic posterior, ESS against
single-site gibbs), chains alone == in a batch, segmentation, the float32
χ² drift over 400 sweeps, the engine rule and ``Run``; the card's test
is in ``test_torch_banded.py`` (it loads without JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deconv3d_tpu import Cube as JCube
from deconv3d_tpu import instruments as jins
from deconv3d_tpu import sampler as jsm
from deconv3d_tpu.ops import banded as jbanded
import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import philox
from deconv3d_tpu_torch.ops import sweep as sw


def _jax_cube(rng, dtype=np.float32):
    L, Y, X = 16, 6, 6
    truth = np.zeros((L, Y, X), dtype)
    truth[8, 3, 3] = 5.0
    data = (truth + 0.1 * rng.standard_normal((L, Y, X))).astype(dtype)
    mask = np.zeros((Y, X), bool)
    mask[1, 4] = True
    cube = JCube.from_data(data, variance=np.full_like(data, 0.01), mask=mask,
                           crval=4750.0, cdelt=1.25, dtype=dtype)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                           lsf=jins.GaussianLSF(fwhm=2.0))
    return cube, inst


def test_factors_match_jax_make_problem(rng):
    """``sampler.block_factors`` of the JAX problem's quad and LSF is its
    ``make_problem(sampler='gibbs_block')``'s ``chol`` (float64), and the
    port's own ``make_problem`` builds its factors the same way."""
    jax.config.update("jax_enable_x64", True)
    cube, inst = _jax_cube(rng, np.float64)
    jp = jsm.make_problem(cube, inst, jsm.RunConfig(
        sampler="gibbs_block", fsf_size=5, lsf_width=5, dtype=np.float64))
    want = np.asarray(jp.chol)
    assert want.shape == (jp.Yc, jp.Xc, jp.L, 5)
    got = sm.block_factors(torch.tensor(np.asarray(jp.lsf)),
                           torch.tensor(np.asarray(jp.quad))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    tcube = d3.Cube.from_data(np.asarray(cube.data), variance=np.asarray(
        cube.variance), mask=np.asarray(cube.mask), crval=4750.0, cdelt=1.25,
        dtype=np.float64)
    tp = sm.make_problem(tcube, ins.Instrument(
        fsf=ins.GaussianFSF(fwhm=0.5), lsf=ins.GaussianLSF(fwhm=2.0)),
        sm.RunConfig(sampler="gibbs_block", fsf_size=5, lsf_width=5,
                     dtype=np.float64))
    assert torch.equal(tp.chol, sm.block_factors(tp.lsf, tp.quad))
    assert tp.qvox is None and tp.quad_lo is not None
    back = interop.problem_from_numpy(interop.problem_to_numpy(tp), tp.config)
    assert torch.equal(back.chol, tp.chol)


def _jax_block_sweep(p, state, u, chol):
    """One sweep of ``_make_block_gibbs_step``'s math with the normals made
    from the injected pairs."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    lw = int(p.lsf.shape[1])
    bounds = jsm._slab_bounds(L, p.config)
    resid, clean = state.resid, state.clean
    lives, total = [], 0.0
    for c in range(f * f):
        cy, cx = c // f, c % f
        valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
        quad_c = jnp.moveaxis(jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
        lin = jnp.moveaxis(jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
        linT = jsm._lsf_apply_T_lastaxis(lin, p.lsf)
        R = chol.reshape(ny, f, nx, f, L, lw)[:, cy, :, cx]
        uc = jnp.asarray(u[c].reshape(ny, nx, 2, L))
        noise = jnp.sqrt(-2.0 * jnp.log(uc[..., 0, :])) * jnp.cos(
            jnp.float32(2.0 * np.pi) * uc[..., 1, :])
        jumps = jbanded.sample_conditional(R, linT, noise)
        jumps = jnp.where(valid_c[..., None], jumps, 0.0)
        g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
        total += float(np.asarray(
            jnp.sum(g * g * quad_c - 2.0 * g * lin), np.float64))
        resid = jsm._chunked_commit(p, resid, g, cy, cx, bounds)
        clean_c = jsm._color_slice(clean, cy, cx, ny, nx, f)
        clean = jsm._color_update(
            clean, clean_c + jnp.moveaxis(jumps, -1, 0), cy, cx, ny, nx, f)
        lives.append(np.asarray(valid_c, np.float64).reshape(-1) * L)
    y = jnp.float32(total) - state.chi2_comp
    chi2 = state.chi2 + y
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                chi2=float(chi2), live=np.stack(lives))


def test_block_step_matches_jax_composition(rng):
    jax.config.update("jax_enable_x64", False)
    try:
        cube, inst = _jax_cube(rng)
        kw = dict(max_iterations=2, burn_in=1, seed=1, fsf_size=5,
                  lsf_width=5)
        jp = jsm.make_problem(cube, inst, jsm.RunConfig(engine="pallas", **kw))
        js = jsm.init_state(jp)
        chol = jbanded.cholesky_banded(jbanded.precision_bands(
            jp.lsf, jnp.moveaxis(jp.quad, 0, -1)))
        tp = interop.problem_from_numpy(
            {f.name: None if getattr(jp, f.name) is None
             else np.asarray(getattr(jp, f.name))
             for f in dataclasses.fields(jp) if f.name != "config"},
            sm.RunConfig(sampler="gibbs_block", **kw))
        tp = dataclasses.replace(tp, chol=sm.block_factors(tp.lsf, tp.quad))
        ts = interop.state_from_numpy(
            {f.name: np.asarray(getattr(js, f.name))
             for f in dataclasses.fields(js)})
        u = np.clip(rng.random((1, tp.n_colors, tp.ny * tp.nx, 2, tp.L),
                               dtype=np.float32), 2.0**-24, 1 - 2.0**-24)
        want = _jax_block_sweep(jp, js, u[0], chol)
    finally:
        jax.config.update("jax_enable_x64", True)
    seg = sw.gibbs_block_segment_reference(tp, ts, 1, torch.as_tensor(u))
    got = seg.result.state
    np.testing.assert_array_equal(seg.accept[0].numpy(), want["live"])
    for name in ("resid", "clean"):
        w = want[name]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    assert torch.equal(seg.result.accept_trace, torch.ones(1))
    assert float(got.n_accept) == float(got.n_propose) == want["live"].sum()


def _toy(rng, dtype=np.float64, L=16, Y=6, X=6, noise=0.1):
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cube0 = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25, dtype=dtype)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=5, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=dtype)
    return cube, inst


def _cfg(**kw):
    base = dict(fsf_size=5, lsf_width=5, dtype=np.float64,
                sampler="gibbs_block")
    base.update(kw)
    return sm.RunConfig(**base)


def test_block_invariant_and_chi2(rng):
    """Mirror of tests/test_gibbs_block.py::test_block_invariant_and_chi2."""
    cube, inst = _toy(rng, noise=0.2)
    p = sm.make_problem(cube, inst, _cfg(max_iterations=40, burn_in=10,
                                         seed=6))
    res = sm.run_sweeps(p, sm.init_state(p), 40)
    st = res.state
    h = p.f // 2
    conv = cv.convolve_cube(st.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - st.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X] > 0
    assert float((model - conv).abs()[w].max()) < 1e-9
    np.testing.assert_allclose(float(st.chi2), float(sm.full_chi2(p, st)),
                               rtol=1e-6)
    assert bool((res.accept_trace == 1.0).all())
    assert float(st.n_accept) == 40 * p.n_valid * p.L


def test_block_matches_analytic_posterior(rng):
    """Mirror of tests/test_gibbs_block.py: with no PSF each spaxel's
    spectrum posterior is N(A⁻¹ Mᵀ w y, A⁻¹); sampled moments against the
    dense analytics."""
    L, Y, X, noise = 10, 2, 2, 0.5
    truth = np.zeros((L, Y, X))
    truth[5, 1, 1] = 4.0
    inst = ins.Instrument(fsf=ins.NoFSF(), lsf=ins.GaussianLSF(fwhm=2.0))
    lam = 4750.0 + 1.25 * np.arange(L)
    M = np.asarray(cv.lsf_matrix(inst.lsf.bank(lam, cdelt=1.25, width=5)))
    data = np.einsum("ml,lyx->myx", M, truth) \
        + noise * rng.standard_normal((L, Y, X))
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=np.float64)
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=4000, burn_in=500, seed=3, sampler="gibbs_block",
        lsf_width=5, dtype=np.float64))
    st = sm.run_sweeps(p, sm.init_state(p), 4000).state
    cov = np.linalg.inv(M.T @ M / noise**2)
    sig = np.sqrt(np.diag(cov))
    pm = sm.posterior_mean(p, st).numpy()
    ps = sm.posterior_std(p, st).numpy()
    for y in range(Y):
        for x in range(X):
            mean_true = cov @ (M.T @ data[:, y, x]) / noise**2
            z = (pm[:, y, x] - mean_true) / sig
            assert np.abs(z).mean() < 0.2, z
            np.testing.assert_allclose(ps[:, y, x], sig, rtol=0.15)


def test_block_ess_beats_single_site(rng):
    """Mirror of tests/test_gibbs_block.py: ESS per sweep ≥ 5× single-site
    gibbs on a high-SNR LSF-blurred toy."""
    L, Y, X, noise = 24, 2, 2, 0.02
    truth = np.zeros((L, Y, X))
    truth[L // 2] = 3.0
    inst = ins.Instrument(fsf=ins.NoFSF(), lsf=ins.GaussianLSF(fwhm=5.0))
    lam = 4750.0 + 1.25 * np.arange(L)
    M = np.asarray(cv.lsf_matrix(inst.lsf.bank(lam, cdelt=1.25, width=13)))
    data = np.einsum("ml,lyx->myx", M, truth) \
        + noise * rng.standard_normal((L, Y, X))
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=np.float64)
    n_sweeps, burn = 400, 50
    ess = {}
    for mode in ("gibbs", "gibbs_block"):
        p = sm.make_problem(cube, inst, sm.RunConfig(
            max_iterations=n_sweeps, burn_in=burn, seed=9, sampler=mode,
            lsf_width=13, dtype=np.float64, n_monitor=8))
        mon = sm.run_sweeps(p, sm.init_state(p), n_sweeps).monitor_trace
        mon = mon.numpy()[burn:]
        ess[mode] = float(np.median([
            ch.effective_sample_size(mon[None, :, k])
            for k in range(mon.shape[1])]))
    assert ess["gibbs_block"] / ess["gibbs"] >= 5.0, ess


def test_chain_alone_equals_in_a_batch(rng):
    cube, inst = _toy(rng, dtype=np.float32)
    p = sm.make_problem(cube, inst, _cfg(dtype=np.float32, seed=7))
    states = ch.init_chain_states(p, 3)
    batch = sm.run_sweeps(p, states, 3)
    for c in (0, 2):
        alone = sm.run_sweeps(p, ch.select_chains(states, c), 3)
        got = ch.select_chains(batch, c)
        for name in ("clean", "resid", "chi2", "sum_clean"):
            assert torch.equal(getattr(got.state, name),
                               getattr(alone.state, name)), (c, name)
    assert not torch.equal(batch.state.clean[0], batch.state.clean[1])


def test_segmented_equals_single_run(rng):
    """The draws (Philox streams 7 and 8) are keyed by the absolute sweep:
    2×3 sweeps == 6 sweeps bit for bit."""
    cube, inst = _toy(rng)
    p = sm.make_problem(cube, inst, _cfg(max_iterations=6, burn_in=2,
                                         seed=11))
    full = sm.run_sweeps(p, sm.init_state(p), 6)
    part = sm.run_sweeps(p, sm.init_state(p), 3)
    part2 = sm.run_sweeps(p, part.state, 3)
    for name in ("clean", "resid", "sum_clean", "sum_sq", "chi2", "n_accept"):
        assert torch.equal(getattr(full.state, name),
                           getattr(part2.state, name)), name
    rec = sw.gibbs_block_segment_reference(p, sm.init_state(p), 1,
                                           record_uniforms=True)
    want = philox.block_sweep_uniforms(p.config.seed, 0, p.n_colors,
                                       p.ny * p.nx, p.L).double()
    assert torch.equal(rec.uniforms[0], want)
    gibbs = philox.gibbs_sweep_uniforms(p.config.seed, 0, p.n_colors,
                                        p.ny * p.nx, p.L).double()
    assert not torch.equal(want, gibbs)


def test_float32_running_chi2_does_not_drift():
    """float32 gibbs_block, 400 sweeps of a 40×12×12 toy: the running χ²
    stays within 4e-6 of the from-scratch one, as exact Gibbs does
    (``tests/test_torch_gibbs.py``): an exact conditional draw whose Δχ²
    has a fixed error in quad drifts linearly, so the block sweep sums the
    quad_lo part too."""
    cube, inst = _toy(np.random.default_rng(0), np.float32, L=40, Y=12, X=12)
    p = sm.make_problem(cube, inst, _cfg(dtype=np.float32, max_iterations=400,
                                         burn_in=200, seed=5))
    st = sm.run_sweeps(p, sm.init_state(p), 400).state
    full = float(sm.full_chi2(p, st))
    assert abs(float(st.chi2) - full) / full <= 4e-6


@pytest.mark.parametrize("engine, tile", [("torch_tiled", None),
                                          ("auto", (1, 1)),
                                          ("torch", (1, 1))])
def test_tiled_engines_refuse_gibbs_block(rng, engine, tile):
    cube, inst = _toy(rng, dtype=np.float32)
    with pytest.raises(ValueError, match="gibbs_block"):
        sm.make_problem(cube, inst, _cfg(dtype=np.float32, engine=engine,
                                         tile=tile))


def test_auto_keeps_gibbs_block_whole_on_a_big_field():
    """Where auto takes the tiled kernel for mh / gibbs on a card, gibbs
    keeps the whole-cube order."""
    cfg = _cfg(dtype=np.float32)
    for sampler, want in (("gibbs", "cuda_tiled"), ("gibbs_block", "cuda")):
        engine, tile = sm.resolve_engine(
            dataclasses.replace(cfg, sampler=sampler), "cuda", 17, 4, 4,
            3681, budget=2**26)
        assert engine == want and (tile is None) == (want == "cuda")


def test_run_gibbs_block_on_cpu(rng, tmp_path):
    cube, inst = _toy(rng, dtype=np.float32)
    run = d3.Run(cube, inst, sampler="gibbs_block", max_iterations=12,
                 burn_in=4, fsf_size=5, lsf_width=5, n_chains=2, seed=3,
                 device="cpu")
    run.run()
    d = run.diagnostics()
    assert d["acceptance_rate"] == 1.0 and d["engine"] == "torch"
    assert np.isfinite(d["rhat_chi2"])
    assert run.rhat_cube().shape == cube.shape
    run.save(str(tmp_path / "blk"))
    assert (tmp_path / "blk_stats.json").exists()
