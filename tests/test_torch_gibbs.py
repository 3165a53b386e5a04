"""The port's exact-Gibbs sweep against the JAX package, same draws.

The TPU kernel's gibbs branch (``deconv3d_tpu/ops/pallas_sweep.py``) cannot
run here — Pallas interpret mode has no PRNG on the CPU — so the reference
is the JAX package's own jnp gibbs step (``sampler._make_gibbs_step``) with
its noise replaced by the injected Box-Muller pairs: ``_chunked_lin``
(recomputed from the residual at every λ-phase), ``_lsf_apply_T_lastaxis``,
``_color_slice(qvox)``, ``_lsf_apply_lastaxis``, ``_chunked_commit`` and
``_color_update``, color-major with the phases inner, plus ``_assemble``'s
per-sweep Kahan χ² and keep rule.  The port updates ``lin`` incrementally
between phases instead (``lin ← lin − g·quad``, as the kernel does), which
is exact only because same-color patches are disjoint: this test holds it
to the recomputation.  Tolerances: residual and clean cube atol 1e-5·max|·|,
χ² rtol 1e-5 (float32 sums in another order), voxel counts equal.
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
from deconv3d_tpu_torch import Cube as TCube
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import philox
from deconv3d_tpu_torch.ops import sweep as sw

N_SWEEPS = 3
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _inputs(rng, L=16, Y=6, X=6):
    truth = np.zeros((L, Y, X), np.float32)
    truth[8, 3, 3] = 5.0
    data = truth + 0.1 * rng.standard_normal((L, Y, X)).astype(np.float32)
    mask = np.zeros((Y, X), bool)
    mask[1, 4] = True
    return data, np.full_like(data, 0.01), mask


_CFG = dict(max_iterations=N_SWEEPS, burn_in=1, seed=1, fsf_size=5,
            lsf_width=5, sampler="gibbs")


def _jax_problem(inputs):
    data, var, mask = inputs
    cube = JCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                           cdelt=1.25)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                           lsf=jins.GaussianLSF(fwhm=2.0))
    return jsm.make_problem(cube, inst, jsm.RunConfig(engine="pallas", **_CFG))


def _to_port(jp, js):
    leaves = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in leaves.items() if k != "config"},
        tsm.RunConfig(**_CFG),
    )
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    )
    return tp, ts


def _jax_gibbs_segment(p, state, n_sweeps, u):
    """``_make_gibbs_step``'s math, color-major with the λ-phases inner,
    with the normals made from the injected (u1, u2)."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    lw = int(p.lsf.shape[1])
    cfg = p.config
    bounds = jsm._slab_bounds(L, cfg)
    resid, clean = state.resid, state.clean
    chi2, chi2c = state.chi2, state.chi2_comp
    sum_clean, sum_sq, n_kept = state.sum_clean, state.sum_sq, state.n_kept
    burn = cfg.resolved_burn_in()
    lives, dchis, chi2_trace = [], [], []
    for s in range(n_sweeps):
        dchi_sweep = []
        for c in range(f * f):
            cy, cx = c // f, c % f
            valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
            quad_c = jnp.moveaxis(
                jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
            qv = jnp.moveaxis(jsm._color_slice(p.qvox, cy, cx, ny, nx, f), 0, -1)
            uc = jnp.asarray(u[s, c].reshape(ny, nx, 2, L))
            normal = jnp.sqrt(-2.0 * jnp.log(uc[..., 0, :])) * jnp.cos(
                jnp.float32(2.0 * np.pi) * uc[..., 1, :])
            qv_safe = jnp.maximum(qv, 1e-30)
            live_c = np.zeros((ny, nx), np.float64)
            dchi_c = np.zeros((ny, nx), np.float64)
            for clam in range(lw):
                lin = jnp.moveaxis(
                    jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
                linT = jsm._lsf_apply_T_lastaxis(lin, p.lsf)
                lam_sel = (jnp.arange(L) % lw == clam).astype(jnp.float32)
                live = lam_sel * valid_c[..., None] * (qv > 0)
                jumps = live * (linT / qv_safe
                                + normal * jax.lax.rsqrt(qv_safe))
                g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
                dchi = jnp.sum(g * g * quad_c - 2.0 * g * lin, axis=-1)
                resid = jsm._chunked_commit(p, resid, g, cy, cx, bounds)
                clean_c = jsm._color_slice(clean, cy, cx, ny, nx, f)
                clean = jsm._color_update(
                    clean, clean_c + jnp.moveaxis(jumps, -1, 0), cy, cx, ny,
                    nx, f)
                live_c += np.asarray(jnp.sum(live, axis=-1))
                dchi_c += np.asarray(dchi, np.float64)
            lives.append(live_c.reshape(-1))
            dchis.append(dchi_c.reshape(-1))
            dchi_sweep.append(dchi_c.sum())
        # _assemble: per-sweep Kahan update and keep rule
        d = jnp.float32(np.sum(dchi_sweep))
        y = d - chi2c
        t = chi2 + y
        chi2c = (t - chi2) - y
        chi2 = t
        if s >= burn:
            sum_clean = sum_clean + clean
            sum_sq = sum_sq + clean * clean
            n_kept = n_kept + 1.0
        chi2_trace.append(float(chi2))
    shape = (n_sweeps, f * f, ny * nx)
    return dict(
        resid=np.asarray(resid), clean=np.asarray(clean), chi2=float(chi2),
        sum_clean=np.asarray(sum_clean), sum_sq=np.asarray(sum_sq),
        n_kept=float(n_kept), live=np.stack(lives).reshape(shape),
        dchi=np.stack(dchis).reshape(shape), chi2_trace=np.asarray(chi2_trace),
    )


def _uniforms(rng, p, n_sweeps, chains=()):
    u = rng.random((n_sweeps, *chains, p.n_colors, p.ny * p.nx, 2, p.L),
                   dtype=np.float32)
    return np.clip(u, 2.0**-24, 1.0 - 2.0**-24)


@pytest.fixture
def pair(rng):
    jp = _jax_problem(_inputs(rng))
    js = jsm.init_state(jp)
    tp, ts = _to_port(jp, js)
    return jp, js, tp, ts, _uniforms(rng, tp, N_SWEEPS)


def test_qvox_matches_kernel_engine(rng):
    data, var, mask = _inputs(rng)
    jp = _jax_problem((data, var, mask))
    tp = tsm.make_problem(
        TCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                        cdelt=1.25),
        tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                        lsf=tins.GaussianLSF(fwhm=2.0)),
        tsm.RunConfig(**_CFG),
    )
    assert tp.qvox.shape == (tp.L, tp.Yc, tp.Xc)
    want = np.asarray(jp.qvox)
    assert (want > 0).sum() > 0
    np.testing.assert_allclose(tp.qvox.numpy(), want, rtol=1e-6, atol=0)
    mh = tsm.make_problem(
        TCube.from_data(data, variance=var, crval=4750.0, cdelt=1.25),
        tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                        lsf=tins.GaussianLSF(fwhm=2.0)),
        tsm.RunConfig(fsf_size=5, lsf_width=5),
    )
    assert mh.qvox is None


def test_interop_carries_qvox(pair):
    jp, _, tp, _, _ = pair
    np.testing.assert_array_equal(tp.qvox.numpy(), np.asarray(jp.qvox))
    back = interop.problem_from_numpy(interop.problem_to_numpy(tp), tp.config)
    assert torch.equal(back.qvox, tp.qvox)


def test_segment_matches_jax_gibbs_step(pair):
    jp, js, tp, ts, u = pair
    want = _jax_gibbs_segment(jp, js, N_SWEEPS, u)
    seg = sw.gibbs_segment_reference(tp, ts, N_SWEEPS, torch.as_tensor(u))
    got = seg.result.state
    assert want["live"].sum() > 0, "no voxel drawn; test is vacuous"
    np.testing.assert_array_equal(seg.accept.numpy(), want["live"])
    np.testing.assert_allclose(seg.dchi.numpy(), want["dchi"], rtol=1e-4,
                               atol=1e-4 * np.abs(want["dchi"]).max())
    for name in ("resid", "clean", "sum_clean", "sum_sq"):
        w = want[name]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    np.testing.assert_allclose(seg.result.chi2_trace.numpy(),
                               want["chi2_trace"], rtol=1e-5)
    assert float(got.n_kept) == want["n_kept"] == 2.0
    # acceptance 1: every drawn voxel is a proposal and an accept
    assert float(got.n_accept) == float(got.n_propose) == want["live"].sum()
    assert torch.equal(seg.result.accept_trace,
                       torch.ones(N_SWEEPS, dtype=torch.float32))
    # the log-scales are MH's; gibbs leaves them as they were
    assert torch.equal(got.log_scale, ts.log_scale)


def test_wrapper_takes_plain_version_on_cpu(pair):
    _, _, tp, ts, u = pair
    before = sw.gibbs_segment.launches
    a = sw.gibbs_segment(tp, ts, 2, torch.as_tensor(u[:2]))
    b = sw.gibbs_segment_reference(tp, ts, 2, torch.as_tensor(u[:2]))
    assert sw.gibbs_segment.launches == before, "no kernel may launch on the CPU"
    assert torch.equal(a.result.state.resid, b.result.state.resid)
    assert torch.equal(a.dchi, b.dchi)


def test_uniforms_shape_is_checked(pair):
    _, _, tp, ts, u = pair
    with pytest.raises(ValueError, match="uniforms must be"):
        sw.gibbs_segment_reference(tp, ts, 2, torch.as_tensor(u[:2, ..., :-1]))
    with pytest.raises(ValueError, match="qvox"):
        sw.gibbs_segment_reference(dataclasses.replace(tp, qvox=None), ts, 1)


# ---------------------------------------------------------------------------
# Philox streams 2 and 3
# ---------------------------------------------------------------------------

def _philox_scalar(counter, key):
    """Philox4x32-10 on Python ints, written out apart from ops/philox.py."""
    c = list(counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & M32, p1 & M32,
             ((p0 >> 32) ^ c[3] ^ k1) & M32, p0 & M32]
    return c


@pytest.mark.parametrize("stream", [philox.STREAM_NORMAL_U1,
                                    philox.STREAM_NORMAL_U2])
def test_gibbs_streams_known_answers(stream):
    key, sweep, n_colors, nij, L = (9 << 32) | 0xDEADBEEF, 41, 3, 5, 13
    u = philox.gibbs_sweep_uniforms(key, sweep, n_colors, nij, L)
    assert u.shape == (n_colors, nij, 2, L) and u.dtype == torch.float32
    k = philox.key_words(key)
    for c, ij, lam in ((0, 0, 0), (2, 4, 12), (1, 3, 6), (2, 0, 5)):
        words = _philox_scalar((lam >> 2, sweep, c, (stream << 24) | ij), k)
        bits = words[lam & 3]
        assert float(u[c, ij, stream - 2, lam]) == (2 * (bits >> 9) + 1) * 2.0**-24


def test_gibbs_streams_differ_from_mh_and_each_other():
    key, sweep, n_colors, nij, L = 5, 3, 2, 3, 10
    g = philox.gibbs_sweep_uniforms(key, sweep, n_colors, nij, L)
    mh = philox.sweep_uniforms(key, sweep, n_colors, nij, L)
    assert not torch.equal(g[:, :, 0], g[:, :, 1])
    assert not torch.equal(g[:, :, 0], mh[..., :L])
    assert bool((g > 0).all() & (g < 1).all())
    # log u1 is finite: the normal is finite everywhere
    normal = torch.sqrt(-2.0 * torch.log(g[:, :, 0])) * torch.cos(
        2.0 * np.pi * g[:, :, 1])
    assert bool(torch.isfinite(normal).all())


# ---------------------------------------------------------------------------
# The gibbs sampler end to end on the plain engine (float64)
# ---------------------------------------------------------------------------

def _toy(rng, dtype=np.float64, L=16, Y=6, X=6):
    noise = 0.1
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cube0 = TCube.from_data(truth, crval=4750.0, cdelt=1.25, dtype=dtype)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=5, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    cube = TCube.from_data(data, variance=np.full_like(data, noise**2),
                           crval=4750.0, cdelt=1.25, dtype=dtype)
    return cube, inst


def _gibbs_cfg(**kw):
    base = dict(fsf_size=5, lsf_width=5, dtype=np.float64, sampler="gibbs")
    base.update(kw)
    return tsm.RunConfig(**base)


def test_invariant_and_unit_acceptance(rng):
    """Mirror of test_sampler.py::TestGibbsSampler::
    test_invariant_and_unit_acceptance on the port's plain engine."""
    cube, inst = _toy(rng)
    p = tsm.make_problem(cube, inst, _gibbs_cfg(max_iterations=30, burn_in=10,
                                                seed=2))
    res = tsm.run_sweeps(p, tsm.init_state(p), 30)
    st = res.state
    assert float(st.n_accept) == float(st.n_propose) > 0
    h = p.f // 2
    conv = cv.convolve_cube(st.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - st.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X].numpy()
    np.testing.assert_allclose(model.numpy()[w > 0], conv.numpy()[w > 0],
                               atol=1e-9)
    np.testing.assert_allclose(float(st.chi2), float(tsm.full_chi2(p, st)),
                               rtol=1e-5)
    assert bool((res.accept_trace == 1).all())


def test_float32_running_chi2_does_not_drift():
    """float32 exact Gibbs, 400 sweeps of a 40×12×12 toy: the running χ²
    stays within 4e-6 of the from-scratch χ² (it stays below 2e-6 over
    2000 sweeps).

    A fixed error in quad (a float32 conv of the FSF reconstruction, or
    the float32 rounding of quad itself, the same at every spaxel of
    uniform weight) biases every draw's Δχ² the same way, and the running
    χ² drifts linearly: 1e-5 within these 400 sweeps with quad_lo left
    out, 6e-5 with the float32 conv."""
    cube, inst = _toy(np.random.default_rng(0), np.float32, L=40, Y=12, X=12)
    p = tsm.make_problem(cube, inst, _gibbs_cfg(
        dtype=np.float32, max_iterations=400, burn_in=200, seed=5))
    st = tsm.run_sweeps(p, tsm.init_state(p), 400).state
    full = float(tsm.full_chi2(p, st))
    assert abs(float(st.chi2) - full) / full <= 4e-6


def test_segmented_equals_single_run(rng):
    """The draws are keyed by the absolute sweep: 2×4 sweeps == 8 sweeps
    bit for bit."""
    cube, inst = _toy(rng)
    p = tsm.make_problem(cube, inst, _gibbs_cfg(max_iterations=8, burn_in=3,
                                                seed=11))
    full = tsm.run_sweeps(p, tsm.init_state(p), 8)
    part = tsm.run_sweeps(p, tsm.init_state(p), 4)
    part2 = tsm.run_sweeps(p, part.state, 4)
    for name in ("clean", "resid", "sum_clean", "sum_sq", "chi2", "n_accept"):
        assert torch.equal(getattr(full.state, name),
                           getattr(part2.state, name)), name
    assert torch.equal(full.chi2_trace,
                       torch.cat([part.chi2_trace, part2.chi2_trace]))
    one = sw.gibbs_segment_reference(p, tsm.init_state(p), 2,
                                     record_uniforms=True)
    later = dataclasses.replace(tsm.init_state(p), sweep=torch.tensor(1))
    two = sw.gibbs_segment_reference(p, later, 1, record_uniforms=True)
    assert torch.equal(one.uniforms[1], two.uniforms[0])
    assert not torch.equal(one.uniforms[0], one.uniforms[1])


def test_run_gibbs_round_trip(rng, tmp_path):
    cube, inst = _toy(rng, dtype=np.float32)
    import deconv3d_tpu_torch as d3

    run = d3.Run(cube, inst, sampler="gibbs", max_iterations=12, burn_in=6,
                 fsf_size=5, lsf_width=5, seed=3, device="cpu")
    run.run()
    assert run.acceptance_rate == 1.0
    diag = run.diagnostics()
    assert diag["sweeps"] == 12 and diag["acceptance_rate"] == 1.0
    run.save(str(tmp_path / "g"))
    clean = TCube.from_fits(str(tmp_path / "g_clean.fits"))
    assert clean.shape == cube.shape and bool(torch.isfinite(clean.data).all())
