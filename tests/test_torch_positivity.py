"""``positivity=True``: the port's plain sweeps against the JAX package.

The JAX package runs positivity on its jnp engine only; the reference here
is composed from its per-color functions, as ``tests/test_torch_sweep.py``
and ``tests/test_torch_gibbs.py`` compose the unconstrained sweeps, with
its positivity lines (``deconv3d_tpu/sampler.py:952-959``, the reflected
MH proposal; ``:1069-1086``, the truncated-normal voxel draw through
``ops/truncnorm.py::transform_uniforms``) fed the injected uniforms.  Both
sides start from one problem (a JAX kernel-engine problem carried across
with ``interop``) and a clean cube that starts at the data, negative
voxels included.  Tolerances: residual and clean atol 1e-5·max|·|, χ² rtol
1e-5, accept decisions and voxel counts equal.  Then the port's mirrors of
the JAX package's positivity toys (``tests/test_sampler.py:137,335,376``),
the slab and tiled forms of the gibbs phases, the refusals and ``Run``.
The kernels' card test is ``test_torch_resident.py::
test_positivity_kernels_match_on_card`` (that file loads without JAX).
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
from deconv3d_tpu.ops.truncnorm import transform_uniforms as jax_transform
import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.ops import tiled

N_SWEEPS = 2


@pytest.fixture(autouse=True)
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _pair(rng, sampler):
    L, Y, X = 16, 6, 6
    truth = np.zeros((L, Y, X), np.float32)
    truth[8, 3, 3] = 5.0
    data = truth + 0.1 * rng.standard_normal((L, Y, X)).astype(np.float32)
    mask = np.zeros((Y, X), bool)
    mask[1, 4] = True
    cube = JCube.from_data(data, variance=np.full_like(data, 0.01), mask=mask,
                           crval=4750.0, cdelt=1.25)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                           lsf=jins.GaussianLSF(fwhm=2.0))
    kw = dict(max_iterations=N_SWEEPS, burn_in=1, seed=1, fsf_size=5,
              lsf_width=5, sampler=sampler, initial="data")
    # the JAX package would route positivity to its jnp engine: build its
    # kernel-engine problem without it and compose the positivity lines
    jp = jsm.make_problem(cube, inst, jsm.RunConfig(engine="pallas", **kw))
    js = jsm.init_state(jp, cube)
    tp = interop.problem_from_numpy(
        {f.name: None if getattr(jp, f.name) is None
         else np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(jp) if f.name != "config"},
        sm.RunConfig(positivity=True, **kw))
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)})
    assert float(ts.clean.min()) < 0, "the start must hold negative voxels"
    return jp, js, tp, ts


def _kahan(chi2, chi2c, d):
    y = jnp.float32(d) - chi2c
    t = chi2 + y
    return t, (t - chi2) - y


def _jax_mh(p, state, u):
    """One MH sweep of the JAX package's pieces with its reflected proposal."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    bounds = jsm._slab_bounds(L, p.config)
    resid, clean, ls = state.resid, state.clean, state.log_scale
    adapt = float(jsm.adapt_schedule(jnp.arange(1, dtype=jnp.int32),
                                     p.config)[0])
    accepts, dchis, total = [], [], 0.0
    for c in range(f * f):
        cy, cx = c // f, c % f
        valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
        vm = valid_c.astype(jnp.float32)
        ls_c = jsm._color_slice(ls, cy, cx, ny, nx, f)
        uc = jnp.asarray(u[c].reshape(ny, nx, L + 1))
        draw = jnp.clip(jnp.tan(jnp.float32(np.pi) * (uc[..., :L] - 0.5)),
                        -1e3, 1e3)
        jumps = jnp.exp(ls_c)[..., None] * draw * vm[..., None]
        cur = jnp.moveaxis(jsm._color_slice(clean, cy, cx, ny, nx, f), 0, -1)
        jumps = jnp.abs(cur + jumps) - cur                      # :952-959
        g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
        quad_c = jnp.moveaxis(jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
        lin = jnp.moveaxis(jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
        dchi = jnp.sum(g * g * quad_c - 2.0 * g * lin, axis=-1)
        accf = jnp.where((jnp.log(uc[..., L]) < -0.5 * dchi) & valid_c, 1.0, 0.0)
        resid = jsm._chunked_commit(p, resid, g * accf[..., None], cy, cx,
                                    bounds)
        clean = jsm._color_update(
            clean, jnp.moveaxis(cur + jumps * accf[..., None], -1, 0),
            cy, cx, ny, nx, f)
        ls = jsm._color_update(ls, ls_c + adapt * (accf - 0.234) * vm,
                               cy, cx, ny, nx, f)
        accepts.append(np.asarray(accf).reshape(-1))
        dchis.append(np.asarray(dchi).reshape(-1))
        total += float(np.asarray(dchi * accf, np.float64).sum())
    chi2, _ = _kahan(state.chi2, state.chi2_comp, total)
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                chi2=float(chi2), accept=np.stack(accepts),
                dchi=np.stack(dchis))


def _jax_gibbs(p, state, u):
    """One exact-Gibbs sweep of the JAX package's pieces, each λ-phase's
    voxels from its truncated normal (:1069-1086) on the injected pairs."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    lw = int(p.lsf.shape[1])
    bounds = jsm._slab_bounds(L, p.config)
    resid, clean = state.resid, state.clean
    lives, total = [], 0.0
    for c in range(f * f):
        cy, cx = c // f, c % f
        valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
        quad_c = jnp.moveaxis(jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
        qv = jnp.moveaxis(jsm._color_slice(p.qvox, cy, cx, ny, nx, f), 0, -1)
        uc = jnp.asarray(u[c].reshape(ny, nx, 2, L))
        qv_safe = jnp.maximum(qv, 1e-30)
        live_c = np.zeros((ny, nx))
        for clam in range(lw):
            lin = jnp.moveaxis(jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
            linT = jsm._lsf_apply_T_lastaxis(lin, p.lsf)
            live = ((jnp.arange(L) % lw == clam).astype(jnp.float32)
                    * valid_c[..., None] * (qv > 0))
            cur = jnp.moveaxis(jsm._color_slice(clean, cy, cx, ny, nx, f), 0, -1)
            sig = jax.lax.rsqrt(qv_safe)
            mu = cur + linT / qv_safe
            z = jax_transform(-mu / sig, uc[..., 0, :], uc[..., 1, :])
            jumps = live * (mu + sig * z - cur)
            g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
            total += float(np.asarray(
                jnp.sum(g * g * quad_c - 2.0 * g * lin), np.float64))
            resid = jsm._chunked_commit(p, resid, g, cy, cx, bounds)
            clean = jsm._color_update(
                clean, jnp.moveaxis(cur + jumps, -1, 0), cy, cx, ny, nx, f)
            live_c += np.asarray(jnp.sum(live, axis=-1))
        lives.append(live_c.reshape(-1))
    chi2, _ = _kahan(state.chi2, state.chi2_comp, total)
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                chi2=float(chi2), live=np.stack(lives))


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def test_mh_step_matches_jax_reflection(rng):
    jp, js, tp, ts = _pair(rng, "mh")
    u = np.clip(rng.random((1, jp.n_colors, jp.ny * jp.nx, jp.L + 1),
                           dtype=np.float32), 2.0**-24, 1.0 - 2.0**-24)
    u, seg = sw.untie_uniforms(tp, ts, 1, torch.as_tensor(u))
    want = _jax_mh(jp, js, u.numpy()[0])
    got = seg.result.state
    assert 0 < want["accept"].sum() < want["accept"].size
    np.testing.assert_array_equal(seg.accept[0].numpy(), want["accept"])
    np.testing.assert_allclose(seg.dchi[0].numpy(), want["dchi"], rtol=1e-4,
                               atol=1e-4 * np.abs(want["dchi"]).max())
    _close(got.resid.numpy(), want["resid"], "resid")
    _close(got.clean.numpy(), want["clean"], "clean")
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    # an accepted spaxel's spectrum is in the orthant, a rejected one as it was
    acc = seg.accept[0].reshape(tp.f, tp.f, tp.ny, tp.nx).permute(2, 0, 3, 1)
    acc = acc.reshape(tp.Yc, tp.Xc).bool()
    assert float(got.clean[:, acc].min()) >= 0.0
    assert torch.equal(got.clean[:, ~acc], ts.clean[:, ~acc])


def test_gibbs_step_matches_jax_truncated_draws(rng):
    jp, js, tp, ts = _pair(rng, "gibbs")
    u = np.clip(rng.random((1, jp.n_colors, jp.ny * jp.nx, 2, jp.L),
                           dtype=np.float32), 2.0**-24, 1.0 - 2.0**-24)
    want = _jax_gibbs(jp, js, u[0])
    seg = sw.gibbs_segment_reference(tp, ts, 1, torch.as_tensor(u))
    got = seg.result.state
    assert want["live"].sum() > 0
    np.testing.assert_array_equal(seg.accept[0].numpy(), want["live"])
    _close(got.resid.numpy(), want["resid"], "resid")
    _close(got.clean.numpy(), want["clean"], "clean")
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    live = tp.valid[None] & (tp.qvox > 0)
    assert float(got.clean[live].min()) >= 0.0
    assert torch.equal(got.clean[~live], ts.clean[~live])


def _toy(rng, noise=0.1, dtype=np.float64):
    """Synthetic emission-line cube + instrument (as tests/test_sampler.py)."""
    L, Y, X = 16, 6, 6
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


def test_positivity_constraint(rng):
    """Mirror of tests/test_sampler.py:137: reflective MH keeps the clean
    cube in the positive orthant and still accepts."""
    cube, inst = _toy(rng, noise=0.2)
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=60, burn_in=20, seed=4, dtype=np.float64, fsf_size=5,
        lsf_width=5, positivity=True))
    res = sm.run_sweeps(p, sm.init_state(p), 60)
    assert float(res.state.n_accept) > 0
    assert float(res.state.clean.min()) >= 0.0


def test_gibbs_positivity_truncated_normal_moments(rng):
    """Mirror of tests/test_sampler.py:335: with no PSF every voxel's
    posterior is its own normal truncated at 0; the sampled moments match
    the analytic ones, strongly truncated voxels included."""
    from scipy.stats import norm

    L, Y, X, var = 6, 2, 2, 1.0
    data = rng.normal(0.0, 1.0, (L, Y, X))
    data[0, 0, 0], data[1, 0, 0], data[2, 0, 0] = -2.0, 0.3, 3.0
    cube = d3.Cube.from_data(data, variance=np.full_like(data, var),
                             crval=4750.0, cdelt=1.25, dtype=np.float64)
    inst = ins.Instrument(fsf=ins.NoPointSpreadFunction(),
                          lsf=ins.NoLineSpreadFunction())
    # two chains of 3000 sweeps: the 5500 kept draws of the JAX test's one
    # chain of 6000 (every sweep an independent draw here), in half the time
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=3000, burn_in=250, seed=2, sampler="gibbs",
        positivity=True, dtype=np.float64))
    st = sm.run_sweeps(p, ch.init_chain_states(p, 2), 3000).state
    n_kept = float(st.n_kept.sum())
    assert n_kept == 5500
    pm = (st.sum_clean.sum(dim=0) / n_kept)[:, :Y, :X].numpy()
    ps = np.sqrt(np.maximum(
        (st.sum_sq.sum(dim=0) / n_kept)[:, :Y, :X].numpy() - pm**2, 0.0))
    alpha = -data
    lam = norm.pdf(alpha) / norm.sf(alpha)
    mean_true = data + lam
    var_true = 1.0 + alpha * lam - lam**2
    np.testing.assert_allclose(pm, mean_true,
                               atol=4 * np.sqrt(var_true.max() / 5500))
    np.testing.assert_allclose(ps, np.sqrt(var_true), rtol=0.12)
    assert float(st.clean[..., :Y, :X].min()) >= 0.0 and pm.min() >= 0.0


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_gibbs_positivity_invariant(rng, dtype, tol):
    """Mirror of tests/test_sampler.py:376: data − resid == conv(clean)
    under truncated draws, running χ² == from scratch (float64 1e-6 as
    there; float32, the kernels' type, 1e-5), the orthant kept."""
    cube, inst = _toy(rng, noise=0.2, dtype=dtype)
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=40, burn_in=10, seed=6, sampler="gibbs",
        positivity=True, fsf_size=5, lsf_width=5, dtype=dtype))
    st = sm.run_sweeps(p, sm.init_state(p), 40).state
    h = p.f // 2
    conv = cv.convolve_cube(st.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - st.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X] > 0
    err = float((model - conv).abs()[w].max())
    assert err < tol * max(1.0, float(conv.abs().max())), err
    assert float(st.clean[:, : p.Y, : p.X].min()) >= 0.0
    np.testing.assert_allclose(float(st.chi2), float(sm.full_chi2(p, st)),
                               rtol=1e-6 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("dtype, rel", [(np.float64, 1e-6),
                                        (np.float32, 1e-4)])
def test_truncated_jump_matches_jax_draw(rng, dtype, rel):
    """``truncated_jump`` (α = −σ·(cur·qs + linT), c' = σ·d from the
    excess d = z − α) against the JAX package's voxel line (μ = cur +
    linT/qs, c' = μ + σ·z, ``deconv3d_tpu/sampler.py:1069-1086``) on the
    same uniforms, α from −5 to 1e3: |Δc'| ≤ rel·σ·max(1, |z|), the
    transform's own tolerance in units of σ; and cur + jump ≥ 0 exactly."""
    jax.config.update("jax_enable_x64", dtype == np.float64)
    n = 4000
    qs = (10.0 ** rng.uniform(-2, 2, n)).astype(dtype)
    sig = 1.0 / np.sqrt(qs)
    alpha = np.concatenate([np.linspace(-5.0, 2.5, n // 2),
                            np.geomspace(2.5, 1e3, n // 2)])
    cur = np.abs(rng.standard_normal(n)) * sig
    # linT for that α: μ = −σα, linT = (μ − cur)·qs
    linT = ((-sig * alpha - cur) * qs).astype(dtype)
    cur = cur.astype(dtype)
    u1, u2 = (np.clip(rng.random(n), 2.0**-24, 1 - 2.0**-24).astype(dtype)
              for _ in range(2))
    got = sw.truncated_jump(*map(torch.as_tensor, (linT, qs, cur, u1, u2)))
    j = dict(zip(("linT", "qs", "cur", "u1", "u2"),
                 map(jnp.asarray, (linT, qs, cur, u1, u2))))
    jsig = jax.lax.rsqrt(j["qs"])
    mu = j["cur"] + j["linT"] / j["qs"]
    z = jax_transform(-mu / jsig, j["u1"], j["u2"])
    want = np.asarray(mu + jsig * z, np.float64)
    new = cur.astype(np.float64) + got.double().numpy()
    scale = sig * np.maximum(1.0, np.abs(np.asarray(z, np.float64)))
    err = np.abs(new - np.maximum(want, 0.0)) / scale
    assert err.max() <= rel, (err.max(), alpha[err.argmax()])
    assert float((torch.as_tensor(cur) + got).min()) >= 0.0
    assert (alpha > 2.0).sum() > n // 3


def test_slab_phases_equal_full_loop_with_positivity(rng):
    """The kernels' slab-by-slab phase (b) (``slab_phases_reference``) is
    the full-spectrum loop bit for bit with truncated draws too."""
    L, lw = 57, 5
    gen = torch.Generator().manual_seed(3)
    lin0, q = torch.randn(3, L, generator=gen), torch.rand(3, L, generator=gen)
    qv = torch.rand(3, L, generator=gen) + 0.1
    qv[0, 7] = 0.0
    clean0 = torch.randn(3, L, generator=gen).abs()
    uni = torch.rand(3, 2, L, generator=gen).clamp(2.0**-24, 1 - 2.0**-24)
    live = (qv > 0).float()
    lsf = torch.rand(L, lw, generator=gen)
    full = sw.gibbs_phases(lin0, q, qv, uni, live, lsf, clean0=clean0)
    assert float((clean0 + full[1]).min()) >= 0.0
    for lam_b in (1, 8, 20, L):
        slab = sw.slab_phases_reference(lin0, q, qv, uni, live, lsf, lam_b,
                                        clean0=clean0)
        assert all(torch.equal(a, b) for a, b in zip(full, slab)), lam_b


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_tiled_scan_with_positivity(rng, sampler):
    """The tiled scan takes positivity from the config: one tile is the
    whole-cube sweep bit for bit, the wavefront the raster, and (1, 1)
    tiles keep the orthant."""
    cube, inst = _toy(rng, dtype=np.float32)
    big = d3.Cube.from_data(np.tile(cube.data.numpy(), (1, 2, 2)),
                            variance=np.full((16, 12, 12), 0.01, np.float32),
                            crval=4750.0, cdelt=1.25)
    p = sm.make_problem(big, inst, sm.RunConfig(
        fsf_size=5, lsf_width=5, sampler=sampler, positivity=True, seed=3,
        initial="data"))
    s0 = sm.init_state(p, big)
    whole = (sw.mh_segment_reference if sampler == "mh"
             else sw.gibbs_segment_reference)(p, s0, N_SWEEPS)
    one = tiled.tiled_segment_reference(p, s0, N_SWEEPS, tile=(p.ny, p.nx))
    for name in ("resid", "clean", "chi2"):
        assert torch.equal(getattr(one.result.state, name),
                           getattr(whole.result.state, name)), name
    wave = tiled.tiled_segment_reference(p, s0, N_SWEEPS, tile=(1, 1))
    rast = tiled.tiled_segment_reference(p, s0, N_SWEEPS, tile=(1, 1),
                                         schedule="raster")
    assert torch.equal(wave.result.state.clean, rast.result.state.clean)
    moved = wave.result.state.clean != s0.clean
    assert bool(moved.any())
    assert float(wave.result.state.clean[moved].min()) >= 0.0


@pytest.mark.parametrize("kw, match", [
    (dict(sampler="gibbs_block", positivity=True), "gibbs_block"),
    (dict(sampler="direct", positivity=True), "direct"),
    (dict(coarse_every=8, positivity=True), "coarse_every"),
    (dict(sampler="gibbs_block", positivity=True, coarse_every=8),
     "gibbs_block"),
])
def test_positivity_refusals(rng, kw, match):
    """The JAX package's ValueErrors, in its order and before any
    NotImplementedError of a knob not ported yet."""
    cube, inst = _toy(rng, dtype=np.float32)
    with pytest.raises(ValueError, match=match):
        sm.make_problem(cube, inst, sm.RunConfig(fsf_size=5, lsf_width=5,
                                                 **kw))


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_run_with_positivity_on_cpu(rng, tmp_path, sampler):
    cube, inst = _toy(rng, dtype=np.float32)
    run = d3.Run(cube, inst, max_iterations=16, burn_in=4, fsf_size=5,
                 lsf_width=5, sampler=sampler, positivity=True, device="cpu")
    run.run()
    d = run.diagnostics()
    assert d["acceptance_rate"] > 0
    assert float(run.states.clean.min()) >= 0.0
    run.save(str(tmp_path / "out"))
    assert (tmp_path / "out_clean.fits").exists()
