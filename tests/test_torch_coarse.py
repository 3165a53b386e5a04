"""The port's coarse pattern passes (``deconv3d_tpu_torch/ops/coarse.py``
and ``sampler.coarse_interleave``) against the JAX package.

The JAX passes are plain jnp, so they run here as they are: both sides
start from one problem (the JAX package's ``make_problem(engine='pallas')``
carried across with ``interop``) and one state, and the port's pass is
handed the JAX pass's own draws, regenerated from its key splits
(``deconv3d_tpu/ops/coarse.py:385-389, 486-511``).  Tolerances: resid and
clean rel 1e-9 of their scale in float64, 1e-5 in float32 (convolutions
and sums in another order); χ² is a float32 Kahan accumulator in both
packages, held to rel 1e-6; accept and proposal counts equal.

Then what only the port has: Philox draws keyed by the absolute sweep
(segmented == monolithic, a chain alone == in a batch), chunked == whole,
masked spaxels frozen, χ² consistency and the residual invariant after
passes on every engine of the CPU, and the positivity refusal.
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

from deconv3d_tpu import Cube as JCube
from deconv3d_tpu import instruments as jins
from deconv3d_tpu import sampler as jsm
from deconv3d_tpu.ops import coarse as jco
import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import coarse as co
from deconv3d_tpu_torch.ops.sweep import _lsf_band

jax.config.update("jax_enable_x64", True)

_CFG = dict(max_iterations=10, seed=1, fsf_size=5, lsf_width=5)


def _cube_data(rng, L, Y, X, noise=0.1, plane_masked=None):
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    data = truth + noise * rng.standard_normal((L, Y, X))
    var = np.full_like(data, noise**2)
    if plane_masked is not None:
        var[plane_masked] = np.inf
    mask = np.zeros((Y, X), bool)
    mask[0, Y - 1] = True
    return data, var, mask


def _pair(rng, dtype=np.float64, L=16, Y=10, X=10, **kw):
    """(JAX problem, port problem, JAX state, port state) of one cube:
    f = 5, a masked spaxel, a blurred Gaussian instrument."""
    data, var, mask = _cube_data(rng, L, Y, X, **kw)
    cube = JCube.from_data(data.astype(dtype), variance=var.astype(dtype),
                           mask=mask, crval=4750.0, cdelt=1.25, dtype=dtype)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=1.0),
                           lsf=jins.GaussianLSF(fwhm=2.0))
    jp = jsm.make_problem(cube, inst, jsm.RunConfig(
        engine="pallas", dtype=dtype, **_CFG))
    js = jsm.init_state(jp)
    leaves = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in leaves.items() if k != "config"},
        tsm.RunConfig(dtype=dtype, **_CFG))
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)},
        dtype=torch.float64 if dtype == np.float64 else torch.float32)
    return jp, tp, js, ts


def _jax_draws(jp, constants, key, dtype):
    """The draws ``deconv3d_tpu.ops.coarse.coarse_pass(…, key)`` makes,
    in the port's injected layout (``ops.coarse.pass_draws``)."""
    out = []
    for entry in constants:
        key, sub = jax.random.split(key)
        if entry[0] == "global_batch":
            normals = []
            for _ in range(entry[1].shape[0]):
                sub, s2 = jax.random.split(sub)
                normals.append(np.asarray(
                    jax.random.normal(s2, (jp.L,), dtype=dtype)))
            out.append(torch.tensor(np.stack(normals)))
        else:
            normals, uniforms = [], []
            for _ in co.COLORS:
                sub, k1, k2 = jax.random.split(sub, 3)
                normals.append(np.asarray(jax.random.normal(
                    k1, (jp.L, jp.ny, jp.nx), dtype=dtype)))
                uniforms.append(np.asarray(jax.random.uniform(
                    k2, (jp.ny, jp.nx), dtype=dtype, minval=1e-37)))
            out.append((torch.tensor(np.stack(normals)),
                        torch.tensor(np.stack(uniforms))))
    return out


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# Operators (the oracles of tests/test_coarse.py:27-71 and the field
# response), each held against the JAX function too
# ---------------------------------------------------------------------------

def test_pattern_response_oracle(rng):
    L, f = 5, 5
    fsf = rng.standard_normal((L, f, f))
    pat = rng.standard_normal((f, f))
    R = co.pattern_response(torch.tensor(fsf), pat).numpy()
    for l in range(L):
        np.testing.assert_allclose(
            R[l], scipy.signal.convolve2d(pat, fsf[l]), atol=1e-12)
    np.testing.assert_allclose(
        R, np.asarray(jco.pattern_response(jnp.asarray(fsf), pat)),
        rtol=0, atol=1e-13)


def test_quad_and_lin_strided_oracle(rng):
    L, ny, nx, f = 4, 3, 2, 5
    B, K = f, 2 * f - 1
    Hp, Wp = ny * f + f - 1, nx * f + f - 1
    w = rng.random((L, Hp, Wp))
    fsf = rng.standard_normal((L, f, f))
    R = co.pattern_response(torch.tensor(fsf), rng.standard_normal((f, f)))
    got = co._depthwise_strided(torch.tensor(w), R * R, B).numpy()
    Rn = R.numpy()
    for I in range(ny):
        for J in range(nx):
            want = np.sum(Rn**2 * w[:, I * B : I * B + K, J * B : J * B + K],
                          axis=(1, 2))
            np.testing.assert_allclose(got[:, I, J], want, rtol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(jco._depthwise_strided(jnp.asarray(w),
                                               jnp.asarray(Rn**2), B)),
        rtol=1e-12)


def test_expand_anchors_oracle(rng):
    L, ny, nx, f = 4, 3, 2, 5
    B, K = f, 2 * f - 1
    Hp, Wp = ny * f + f - 1, nx * f + f - 1
    fsf = rng.standard_normal((L, f, f))
    R = co.pattern_response(torch.tensor(fsf), rng.standard_normal((f, f)))
    g = rng.standard_normal((L, ny, nx))
    got = co._expand_anchors(torch.tensor(g), R, B, Hp, Wp).numpy()
    want = np.zeros((L, Hp, Wp))
    for I in range(ny):
        for J in range(nx):
            want[:, I * B : I * B + K, J * B : J * B + K] += (
                g[:, I : I + 1, J : J + 1] * R.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        got, np.asarray(jco._expand_anchors(jnp.asarray(g),
                                            jnp.asarray(R.numpy()), B, Hp,
                                            Wp)), rtol=1e-10, atol=1e-12)


def test_soft_patterns_orthonormal_and_as_jax():
    lam = 4750.0 + 1.25 * np.arange(8)
    fsf = tins.GaussianFSF(fwhm=1.2).bank(lam, size=5, pixel_scale=0.2)
    pats = co.soft_patterns(fsf, k=4)
    G = pats.reshape(4, -1) @ pats.reshape(4, -1).T
    np.testing.assert_allclose(G, np.eye(4), atol=1e-10)
    np.testing.assert_allclose(pats, jco.soft_patterns(fsf, k=4), atol=1e-12)


def test_field_response_oracle(rng):
    """R_d == Σ_{y,x} d[y,x]·shift(F): the padded-grid placement is the
    sampler's patch layout."""
    L, f, ny, nx = 3, 5, 2, 2
    fsf = rng.standard_normal((L, f, f))
    d = rng.standard_normal((ny * f, nx * f))
    got = co.pattern_field_response(torch.tensor(d), torch.tensor(fsf))
    want = np.zeros((L, ny * f + f - 1, nx * f + f - 1))
    for y in range(ny * f):
        for x in range(nx * f):
            want[:, y : y + f, x : x + f] += d[y, x] * fsf
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# Constants and passes against the JAX package
# ---------------------------------------------------------------------------

def test_global_constants_match_jax(rng):
    """Direction fields, QR, the cross table C and the banded factors of
    the kept patterns (float64)."""
    jp, tp, _, _ = _pair(rng)
    (jname, jd, jQR, jchols, jC), = jco.global_constants(jp)
    (tname, td, tQR, tchols, tC), = co.global_constants(tp)
    assert jname == tname == "global_batch" and td.shape[0] == co.N_SOFT
    _close(td, jd, 1e-12, "d_stack")
    _close(tQR, jQR, 1e-12, "QR")
    _close(tC, jC, 1e-12, "C")
    _close(tchols, jnp.stack(jchols), 1e-10, "chols")


def test_global_constants_drop_patterns_of_an_empty_plane(rng):
    """A λ plane with no weight makes every response norm vanish there:
    each conditional is improper, every pattern is dropped, as in JAX."""
    jp, tp, _, _ = _pair(rng, plane_masked=5)
    assert jco.global_constants(jp) == [] and co.global_constants(tp) == []


@pytest.mark.parametrize("dtype, rel", [(np.float64, 1e-9),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("mode", co.MODES)
def test_pass_matches_jax(rng, mode, dtype, rel):
    """One pass of ``mode`` from one state, the port given the JAX pass's
    draws: resid and clean to ``rel`` of their scale, χ² rel 1e-6, the
    accept and proposal counts equal."""
    jp, tp, js, ts = _pair(rng, dtype=dtype)
    jc = jco.coarse_constants(jp, mode)
    tc = co.coarse_constants(tp, mode)
    assert len(jc) == len(tc) > 0
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(jp, jc, key, dtype)
    got = co.coarse_pass(tp, ts, tc, draws=draws)
    want = jco.coarse_pass(jp, js, jc, key)      # donates js's buffers
    _close(got.resid, want.resid, rel, "resid")
    _close(got.clean, want.clean, rel, "clean")
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-6)
    assert float(got.n_accept) == float(want.n_accept) > 0
    assert float(got.n_propose) == float(want.n_propose)
    # the input state is not written
    assert torch.equal(ts.resid, interop.state_from_numpy(
        {f.name: np.asarray(getattr(jsm.init_state(jp), f.name))
         for f in dataclasses.fields(ts)}, dtype=ts.resid.dtype).resid)


def test_global_pass_chunked_equals_whole(rng):
    """The λ-chunked pass (the full field's) is bit-identical to the whole
    one: L = 300, two chunks of 128 and a remainder."""
    data, var, mask = _cube_data(rng, 300, 10, 10, noise=0.2)
    cube = d3.Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                             cdelt=1.25)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=1.0),
                           lsf=tins.GaussianLSF(fwhm=2.0))
    p = tsm.make_problem(cube, inst, tsm.RunConfig(**_CFG))
    st = tsm.init_state(p)
    (_, d_stack, QR, chols, C), = co.global_constants(p)
    noise = torch.tensor(rng.standard_normal((d_stack.shape[0], p.L)),
                         dtype=torch.float32)
    a = co._global_pass_batch(p, st, d_stack, QR, chols, C, noise, p.L)
    b = co._global_pass_batch(p, st, d_stack, QR, chols, C, noise, 128)
    for name in ("resid", "clean", "chi2", "n_accept"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_global_cross_update_is_exact(rng):
    """C[i,j,λ] = Σ_uv R_i·R_j·w, and the [L]-vector conditioning LR_j ←
    LR_j − g_i·C[i,j] tracks the committed residual: LR recomputed from
    the pass's output equals LR_start − Σ_i g_i·C[i,·] (float64)."""
    _, p, _, st = _pair(rng, L=40)
    (_, d_stack, QR, chols, C), = co.global_constants(p)
    R_all = co.batched_field_response(d_stack, p.fsf).numpy()
    w = p.w_pad.numpy()
    C_want = np.einsum("iluv,jluv->ijl", R_all, R_all * w[None])
    _close(C, C_want, 1e-10, "C")
    LR0 = np.einsum("kluv,luv->kl", R_all, st.resid.numpy() * w)
    noise = torch.tensor(rng.standard_normal((d_stack.shape[0], p.L)))
    st2 = co._global_pass_batch(p, st, d_stack, QR, chols, C, noise, p.L)
    LR1 = np.einsum("kluv,luv->kl", R_all, st2.resid.numpy() * w)
    dn = d_stack.numpy()
    dclean = (st2.clean - st.clean).numpy()
    delta = np.linalg.solve(np.einsum("kyx,jyx->kj", dn, dn),
                            np.einsum("kyx,lyx->kl", dn, dclean))
    g = _lsf_band(torch.tensor(delta), p.lsf).numpy()
    want = LR0 - np.einsum("il,ijl->jl", g, C.numpy())
    np.testing.assert_allclose(LR1, want, rtol=2e-7,
                               atol=1e-6 * np.abs(LR0).max())


# ---------------------------------------------------------------------------
# Passes inside runs (the port's Philox draws)
# ---------------------------------------------------------------------------

def _toy(rng, L=16, Y=10, X=10, dtype=np.float64, mask=None):
    data, var, _ = _cube_data(rng, L, Y, X, noise=0.2)
    cube = d3.Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                             cdelt=1.25, dtype=dtype)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=1.2),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    return cube, inst


def _invariant(p, st, atol_rel):
    h = p.f // 2
    conv = cv.convolve_cube(st.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - st.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X].numpy()
    scale = float(p.data_pad.abs().max())
    np.testing.assert_allclose(model.numpy()[w > 0], conv.numpy()[w > 0],
                               rtol=0, atol=atol_rel * scale)


@pytest.mark.parametrize("mode, engine, dtype, rel", [
    ("global", "torch", np.float64, 1e-9),
    ("soft", "torch", np.float64, 1e-9),
    ("mixed", "torch", np.float64, 1e-9),
    ("global", "torch_tiled", np.float32, 1e-5),
])
def test_invariant_and_chi2_after_passes(rng, mode, engine, dtype, rel):
    """data − resid == conv(clean) and running χ² == full_chi2 after a run
    that interleaves passes every 2 sweeps; the passes add proposals (the
    global pass k·L accepted ones each, acceptance 1)."""
    cube, inst = _toy(rng, dtype=dtype)
    kw = dict(tile=(1, 1)) if engine == "torch_tiled" else {}
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        max_iterations=12, burn_in=4, seed=3, dtype=dtype, fsf_size=5,
        lsf_width=5, coarse_every=2, coarse_mode=mode, engine=engine, **kw))
    res = tsm.run_sweeps(p, tsm.init_state(p), 12)
    st = res.state
    assert float(st.n_propose) > 12 * p.n_valid
    _invariant(p, st, rel)
    np.testing.assert_allclose(float(st.chi2), float(tsm.full_chi2(p, st)),
                               rtol=3e-6)
    if mode == "global":
        one = co.coarse_pass(p, st, tsm.coarse_constants_of(p))
        d_acc = float(one.n_accept - st.n_accept)
        assert d_acc == float(one.n_propose - st.n_propose) == co.N_SOFT * p.L


def test_segmented_equals_monolithic_with_passes(rng, monkeypatch):
    """Passes after absolute sweeps 8 and 16 whatever the segmentation
    (5 + 6 + 7 == 18), with the χ² rebaseline inside (every 4): bit-equal
    states and traces."""
    cube, inst = _toy(rng, L=12)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        max_iterations=18, burn_in=6, seed=5, dtype=np.float64, fsf_size=5,
        lsf_width=5, coarse_every=8, chi2_rebaseline_every=4))
    at = []
    apply = tsm.apply_coarse_pass
    monkeypatch.setattr(tsm, "apply_coarse_pass", lambda pr, s, c: (
        at.append(int(s.sweep)), apply(pr, s, c))[1])
    mono = tsm.run_sweeps(p, tsm.init_state(p), 18)
    assert at == [8, 16]
    parts, st = [], tsm.init_state(p)
    for n in (5, 6, 7):
        r = tsm.run_sweeps(p, st, n)
        parts.append(r)
        st = r.state
    assert at == [8, 16, 8, 16]
    for name in ("clean", "resid", "sum_clean", "log_scale", "chi2",
                 "n_accept", "n_propose"):
        assert torch.equal(getattr(mono.state, name), getattr(st, name)), name
    assert torch.equal(mono.chi2_trace,
                       torch.cat([r.chi2_trace for r in parts]))


def test_masked_spaxels_stay_frozen_under_global_passes(rng):
    mask = np.zeros((10, 10), bool)
    mask[0:3, 0:3] = True
    cube, inst = _toy(rng, mask=mask)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        max_iterations=6, burn_in=2, seed=3, dtype=np.float64, fsf_size=5,
        lsf_width=5, coarse_every=1, coarse_mode="global"))
    st = tsm.run_sweeps(p, tsm.init_state(p), 6).state
    assert float(st.clean[:, 0:3, 0:3].abs().max()) == 0.0
    assert float(st.clean[:, 5:, 5:].abs().max()) > 0.0


@pytest.mark.parametrize("mode", ["global", "soft"])
def test_chain_alone_equals_chain_in_a_batch(rng, mode):
    """``run_chains`` applies the passes chain by chain under each chain's
    key: chain 1 of a batch of 2 is bit-equal to the same chain alone, and
    the two chains differ."""
    cube, inst = _toy(rng, L=12)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        max_iterations=8, burn_in=2, seed=3, dtype=np.float64, fsf_size=5,
        lsf_width=5, coarse_every=2, coarse_mode=mode))
    mc = ch.run_chains(p, 2, n_sweeps=8)
    alone = tsm.run_sweeps(p, tsm.init_state(p, key=ch.chain_key(3, 1)), 8)
    batch = ch.select_chains(mc.result.state, 1)
    for name in ("clean", "resid", "chi2", "n_accept", "n_propose"):
        assert torch.equal(getattr(batch, name),
                           getattr(alone.state, name)), name
    assert torch.equal(mc.result.chi2_trace[1], alone.chi2_trace)
    assert float(mc.result.state.n_propose[0]) > 8 * p.n_valid
    assert not torch.equal(mc.result.state.clean[0], mc.result.state.clean[1])
    for c in range(2):
        _invariant(p, ch.select_chains(mc.result.state, c), 1e-9)


def test_pass_draws_follow_key_and_sweep(rng):
    """The Philox draws of a pass depend on the chain key and the absolute
    sweep only: equal for equal (key, sweep), different otherwise."""
    cube, inst = _toy(rng, L=8)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        dtype=np.float64, fsf_size=5, lsf_width=5, coarse_mode="mixed"))
    consts = co.coarse_constants(p, "mixed")
    st = tsm.init_state(p)
    a = co.pass_draws(p, st, consts)
    assert torch.equal(a[0][0], co.pass_draws(p, tsm.init_state(p),
                                              consts)[0][0])
    later = dataclasses.replace(st, sweep=st.sweep + 8)
    other = tsm.init_state(p, key=99)
    for moved in (later, other):
        b = co.pass_draws(p, moved, consts)
        assert not torch.equal(a[0][0], b[0][0])
        assert not torch.equal(a[-1][1], b[-1][1])
    normals = torch.cat([a[0][0].reshape(-1), a[-1][0].reshape(-1)])
    assert abs(float(normals.mean())) < 0.2 and \
        abs(float(normals.std()) - 1.0) < 0.2


def test_positivity_and_bad_modes_rejected(rng):
    cube, inst = _toy(rng, L=8)
    with pytest.raises(ValueError, match="coarse"):
        tsm.make_problem(cube, inst, tsm.RunConfig(
            coarse_every=2, positivity=True, fsf_size=5, lsf_width=5))
    with pytest.raises(ValueError, match="coarse_mode"):
        tsm.make_problem(cube, inst, tsm.RunConfig(
            coarse_every=2, coarse_mode="checker", fsf_size=5, lsf_width=5))
    for mode in co.MODES:
        p = tsm.make_problem(cube, inst, tsm.RunConfig(
            coarse_every=8, coarse_mode=mode, fsf_size=5, lsf_width=5))
        assert p.config.coarse_every == 8 and p.config.coarse_mode == mode
