"""The port's tiled scan (``ops/tiled.py``) against the JAX package.

The TPU kernel (``deconv3d_tpu/ops/pallas_tiled.py``) cannot run here —
Pallas interpret mode has no PRNG on the CPU — so the reference is the
JAX package's own per-color functions applied in the tiled kernel's order:
tiles in raster order, all f² colors inside each tile, each (tile, color)
step restricted to the tile's spaxels (``_color_slice``, ``_chunked_lin``,
``_lsf_apply_lastaxis``, ``_chunked_commit``, ``_color_update`` as
``tests/test_torch_sweep.py`` composes them; the gibbs step as
``tests/test_torch_gibbs.py`` composes ``_make_gibbs_step``).  Both sides
start from the identical problem and state and consume the same injected
uniforms.  Tolerances as ``tests/test_torch_sweep.py``: residual and clean
atol 1e-5·max|·|, χ² rtol 1e-5, decisions and voxel counts equal.

Geometry: L=16, 12×12, f=3 (4×4 spaxel blocks), a masked spaxel, tiles of
(1, 2) blocks — 8 tiles, not square.
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
from deconv3d_tpu.ops import pallas_tiled as pt
import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.ops import tiled as tl

N_SWEEPS = 3
TILE = (1, 2)
_CFG = dict(max_iterations=N_SWEEPS, burn_in=1, seed=1, fsf_size=3,
            lsf_width=5)


@pytest.fixture(autouse=True)
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _inputs(rng, L=16, Y=12, X=12):
    truth = np.zeros((L, Y, X), np.float32)
    truth[8, 6, 6] = 5.0
    truth[4, 2, 9] = 3.0
    data = truth + 0.1 * rng.standard_normal((L, Y, X)).astype(np.float32)
    mask = np.zeros((Y, X), bool)
    mask[4, 7] = True
    return data, np.full_like(data, 0.01), mask


def _jax_problem(inputs, sampler="mh", **kw):
    data, var, mask = inputs
    cube = JCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                           cdelt=1.25)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                           lsf=jins.GaussianLSF(fwhm=2.0))
    cfg = dict(engine="pallas", sampler=sampler, **_CFG)
    cfg.update(kw)
    return jsm.make_problem(cube, inst, jsm.RunConfig(**cfg))


def _to_port(jp, js, **cfg):
    leaves = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in leaves.items() if k != "config"},
        tsm.RunConfig(sampler=jp.config.sampler, **_CFG, **cfg),
    )
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    )
    return tp, ts


def _tile_mask(p, by0, bx0):
    """[ny, nx] 1.0 on the spaxel blocks of the tile at (by0, bx0)."""
    m = np.zeros((p.ny, p.nx), np.float32)
    m[by0 : by0 + TILE[0], bx0 : bx0 + TILE[1]] = 1.0
    return jnp.asarray(m)


def _origins(p):
    return [(by0, bx0) for by0 in range(0, p.ny, TILE[0])
            for bx0 in range(0, p.nx, TILE[1])]


def _kahan(chi2, chi2c, d):
    y = jnp.float32(d) - chi2c
    t = chi2 + y
    return t, (t - chi2) - y


def _jax_tiled_mh(p, state, n_sweeps, u):
    """The tiled MH scan from the JAX package's per-color functions."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    cfg = p.config
    bounds = jsm._slab_bounds(L, cfg)
    resid, clean, ls = state.resid, state.clean, state.log_scale
    chi2, chi2c = state.chi2, state.chi2_comp
    sum_clean, n_kept = state.sum_clean, state.n_kept
    adapt = jsm.adapt_schedule(jnp.arange(n_sweeps, dtype=jnp.int32), cfg)
    burn = cfg.resolved_burn_in()
    shape = (n_sweeps, f * f, ny, nx)
    accept, dchis = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for s in range(n_sweeps):
        committed = 0.0
        for by0, bx0 in _origins(p):
            tm = _tile_mask(p, by0, bx0)
            for c in range(f * f):
                cy, cx = c // f, c % f
                valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
                vm = valid_c.astype(jnp.float32)
                ls_c = jsm._color_slice(ls, cy, cx, ny, nx, f)
                uc = jnp.asarray(u[s, c].reshape(ny, nx, L + 1))
                draw = jnp.clip(
                    jnp.tan(jnp.float32(np.pi) * (uc[..., :L] - 0.5)),
                    -1e3, 1e3)
                jumps = jnp.exp(ls_c)[..., None] * draw * vm[..., None]
                g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
                quad_c = jnp.moveaxis(
                    jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
                lin = jnp.moveaxis(
                    jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
                dchi = jnp.sum(g * g * quad_c - 2.0 * g * lin, axis=-1)
                # only the tile's spaxels take this step
                accf = jnp.where((jnp.log(uc[..., L]) < -0.5 * dchi)
                                 & valid_c, 1.0, 0.0) * tm
                resid = jsm._chunked_commit(p, resid, g * accf[..., None],
                                            cy, cx, bounds)
                clean_c = jsm._color_slice(clean, cy, cx, ny, nx, f)
                clean = jsm._color_update(
                    clean, clean_c + jnp.moveaxis(jumps * accf[..., None],
                                                  -1, 0), cy, cx, ny, nx, f)
                ls = jsm._color_update(
                    ls, ls_c + adapt[s] * (accf - cfg.target_acceptance)
                    * vm * tm, cy, cx, ny, nx, f)
                on = np.asarray(tm) > 0
                accept[s, c][on] = np.asarray(accf)[on]
                dchis[s, c][on] = np.asarray(dchi)[on]
                committed += float(np.asarray(dchi * accf, np.float64).sum())
        chi2, chi2c = _kahan(chi2, chi2c, committed)
        if s >= burn:
            sum_clean = sum_clean + clean
            n_kept = n_kept + 1.0
    flat = (n_sweeps, f * f, ny * nx)
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                log_scale=np.asarray(ls), chi2=float(chi2),
                sum_clean=np.asarray(sum_clean), n_kept=float(n_kept),
                accept=accept.reshape(flat), dchi=dchis.reshape(flat))


def _jax_tiled_gibbs(p, state, n_sweeps, u):
    """The tiled exact-Gibbs scan from ``_make_gibbs_step``'s pieces."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    lw = int(p.lsf.shape[1])
    bounds = jsm._slab_bounds(L, p.config)
    resid, clean = state.resid, state.clean
    chi2, chi2c = state.chi2, state.chi2_comp
    shape = (n_sweeps, f * f, ny, nx)
    lives, dchis = np.zeros(shape), np.zeros(shape)
    for s in range(n_sweeps):
        committed = 0.0
        for by0, bx0 in _origins(p):
            tm = _tile_mask(p, by0, bx0)
            on = np.asarray(tm) > 0
            for c in range(f * f):
                cy, cx = c // f, c % f
                valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
                quad_c = jnp.moveaxis(
                    jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
                qv = jnp.moveaxis(
                    jsm._color_slice(p.qvox, cy, cx, ny, nx, f), 0, -1)
                uc = jnp.asarray(u[s, c].reshape(ny, nx, 2, L))
                normal = jnp.sqrt(-2.0 * jnp.log(uc[..., 0, :])) * jnp.cos(
                    jnp.float32(2.0 * np.pi) * uc[..., 1, :])
                qv_safe = jnp.maximum(qv, 1e-30)
                for clam in range(lw):
                    lin = jnp.moveaxis(
                        jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
                    linT = jsm._lsf_apply_T_lastaxis(lin, p.lsf)
                    lam_sel = (jnp.arange(L) % lw == clam).astype(jnp.float32)
                    live = (lam_sel * valid_c[..., None] * (qv > 0)
                            * tm[..., None])
                    jumps = live * (linT / qv_safe
                                    + normal * jax.lax.rsqrt(qv_safe))
                    g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
                    dchi = jnp.sum(g * g * quad_c - 2.0 * g * lin, axis=-1)
                    resid = jsm._chunked_commit(p, resid, g, cy, cx, bounds)
                    clean_c = jsm._color_slice(clean, cy, cx, ny, nx, f)
                    clean = jsm._color_update(
                        clean, clean_c + jnp.moveaxis(jumps, -1, 0), cy, cx,
                        ny, nx, f)
                    lives[s, c][on] += np.asarray(jnp.sum(live, axis=-1))[on]
                    dchis[s, c][on] += np.asarray(dchi, np.float64)[on]
                committed += dchis[s, c][on].sum()
        chi2, chi2c = _kahan(chi2, chi2c, committed)
    flat = (n_sweeps, f * f, ny * nx)
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                chi2=float(chi2), live=lives.reshape(flat),
                dchi=dchis.reshape(flat))


def _uniforms(rng, p, n_sweeps, sampler, chains=()):
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = rng.random((n_sweeps, *chains, p.n_colors, p.ny * p.nx, *per),
                   dtype=np.float32)
    return torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24))


def _assert_close(got, want, names):
    for name in names:
        w = want[name]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (a) interop of a JAX tiled problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_interop_takes_a_jax_tiled_problem(rng, sampler):
    inputs = _inputs(rng)
    jt = _jax_problem(inputs, sampler, engine="pallas_tiled", tile=TILE)
    assert jt.quad is None and jt.quad_tiled is not None
    assert jt.w_pad.dtype == jnp.bfloat16
    tp, _ = _to_port(jt, jsm.init_state(jt), tile=TILE)
    Lp = pt._pad_lanes_of(jt.L)
    for name in ("quad", "qvox") if sampler == "gibbs" else ("quad",):
        want = pt.untiled_quad_layout(getattr(jt, f"{name}_tiled"), jt.ny,
                                      jt.nx, jt.f, *TILE, jt.L, Lp)
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(want), err_msg=name)
    # the same values as the whole-cube kernel engine's problem
    jw = _jax_problem(inputs, sampler)
    np.testing.assert_array_equal(tp.quad.numpy(), np.asarray(jw.quad))
    np.testing.assert_array_equal(tp.w_pad.numpy(), np.asarray(jw.w_pad))
    assert tp.w_pad.dtype == torch.float32
    with pytest.raises(ValueError, match="config.tile"):
        _to_port(jt, jsm.init_state(jt))


def test_untiled_layout_inverts_the_jax_relayout(rng):
    ny, nx, f, L = 4, 6, 5, 7
    for tile in ((1, 1), (2, 3), (4, 2), (1, 6)):
        quad = rng.standard_normal((L, ny * f, nx * f)).astype(np.float32)
        qt = pt.tiled_quad_layout(jnp.asarray(quad), ny, nx, f, *tile, L, 128)
        np.testing.assert_array_equal(
            interop.untiled_layout(np.asarray(qt), ny, nx, f, tile, L), quad)


# ---------------------------------------------------------------------------
# (b), (c) the plain tiled scan against the JAX composition
# ---------------------------------------------------------------------------

def test_mh_matches_jax_tiled_composition(rng):
    jp = _jax_problem(_inputs(rng))
    js = jsm.init_state(jp)
    tp, ts = _to_port(jp, js)
    assert (jp.ny, jp.nx) == (4, 4)
    u, seg = sw.untie_uniforms(
        tp, ts, N_SWEEPS, _uniforms(rng, tp, N_SWEEPS, "mh"),
        reference=lambda *a: tl.tiled_segment_reference(*a, tile=TILE))
    want = _jax_tiled_mh(jp, js, N_SWEEPS, u.numpy())
    got = seg.result.state
    assert 0 < want["accept"].sum() < want["accept"].size, "vacuous"
    np.testing.assert_array_equal(seg.accept.numpy(), want["accept"])
    np.testing.assert_allclose(seg.dchi.numpy(), want["dchi"], rtol=1e-4,
                               atol=1e-4)
    _assert_close(got, want, ("resid", "clean", "sum_clean"))
    np.testing.assert_allclose(got.log_scale.numpy(), want["log_scale"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    assert float(got.n_kept) == want["n_kept"] == 2.0
    # the scan order matters: the whole-cube scan takes other decisions
    whole = sw.mh_segment_reference(tp, ts, N_SWEEPS, u)
    assert not torch.equal(whole.result.state.resid, got.resid)


def test_gibbs_matches_jax_tiled_composition(rng):
    jp = _jax_problem(_inputs(rng), "gibbs")
    js = jsm.init_state(jp)
    tp, ts = _to_port(jp, js)
    u = _uniforms(rng, tp, N_SWEEPS, "gibbs")
    want = _jax_tiled_gibbs(jp, js, N_SWEEPS, u.numpy())
    seg = tl.tiled_segment_reference(tp, ts, N_SWEEPS, u, tile=TILE)
    got = seg.result.state
    assert want["live"].sum() > 0, "no voxel drawn; test is vacuous"
    np.testing.assert_array_equal(seg.accept.numpy(), want["live"])
    np.testing.assert_allclose(seg.dchi.numpy(), want["dchi"], rtol=1e-4,
                               atol=1e-4 * np.abs(want["dchi"]).max())
    _assert_close(got, want, ("resid", "clean"))
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    assert float(got.n_accept) == float(got.n_propose) == want["live"].sum()


# ---------------------------------------------------------------------------
# (d), (e) one tile is the whole-cube scan; segmentation and batching
# ---------------------------------------------------------------------------

_FIELDS = ("clean", "resid", "log_scale", "sum_clean", "sum_sq", "chi2",
           "n_accept", "n_propose")


def _port_problem(sampler, dtype=np.float32, **kw):
    """The port's problem on the fixed inputs of seed 0."""
    data, var, mask = _inputs(np.random.default_rng(0))
    cube = d3.Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                             cdelt=1.25, dtype=dtype)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                           lsf=tins.GaussianLSF(fwhm=2.0))
    cfg = dict(_CFG, sampler=sampler, dtype=dtype, max_iterations=8)
    cfg.update(kw)
    return tsm.make_problem(cube, inst, tsm.RunConfig(**cfg))


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_one_tile_is_the_whole_cube_scan(rng, sampler):
    p = _port_problem(sampler, engine="torch_tiled", tile=(4, 4))
    assert p.config.engine == "torch_tiled" and p.config.tile == (4, 4)
    pw = _port_problem(sampler)
    assert pw.config.engine == "torch" and pw.config.tile is None
    s = tsm.init_state(p)
    whole = (sw.mh_segment_reference if sampler == "mh"
             else sw.gibbs_segment_reference)
    a = tl.tiled_segment_reference(p, s, 3, record_uniforms=True)
    b = whole(pw, s, 3, record_uniforms=True)
    for name in _FIELDS:
        assert torch.equal(getattr(a.result.state, name),
                           getattr(b.result.state, name)), name
    assert torch.equal(a.accept, b.accept) and torch.equal(a.dchi, b.dchi)
    assert torch.equal(a.uniforms, b.uniforms)
    assert torch.equal(a.result.chi2_trace, b.result.chi2_trace)
    # several tiles draw the same numbers, visited in another order
    c = tl.tiled_segment_reference(p, s, 3, record_uniforms=True, tile=TILE)
    assert torch.equal(c.uniforms, b.uniforms)
    assert not torch.equal(c.result.state.resid, b.result.state.resid)


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_segmented_equals_single_run(rng, sampler):
    p = _port_problem(sampler, engine="torch_tiled", tile=TILE)
    full = tsm.run_sweeps(p, tsm.init_state(p), 5)
    part = tsm.run_sweeps(p, tsm.init_state(p), 2)
    part2 = tsm.run_sweeps(p, part.state, 3)
    for name in _FIELDS:
        assert torch.equal(getattr(full.state, name),
                           getattr(part2.state, name)), name
    assert torch.equal(full.chi2_trace,
                       torch.cat([part.chi2_trace, part2.chi2_trace]))


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_batched_chains_equal_chains_alone(rng, sampler):
    """The same draws alone or in a batch: the same decisions and voxel
    counts; the plain version's float sums may round by batch (the kernel
    is held bit-equal on the card), so 1e-6 of scale, as
    ``tests/test_torch_chains.py``."""
    p = _port_problem(sampler, engine="torch_tiled", tile=TILE)
    states = ch.init_chain_states(p, 3)
    batch = tl.tiled_segment(p, states, 3)
    for c in range(3):
        alone = tl.tiled_segment(p, ch.select_chains(states, c), 3)
        assert torch.equal(batch.accept[:, c], alone.accept), c
        mine = ch.select_chains(batch.result.state, c)
        for name in ("clean", "resid", "log_scale", "sum_clean", "chi2"):
            want = getattr(alone.result.state, name)
            scale = max(float(want.abs().max()), 1e-30)
            assert float((getattr(mine, name) - want).abs().max()) <= (
                1e-6 * scale), (c, name)
        for name in ("n_accept", "n_propose", "sweep", "key"):
            assert torch.equal(getattr(mine, name),
                               getattr(alone.result.state, name)), name
    assert not torch.equal(batch.dchi[:, 0], batch.dchi[:, 1])


def test_wrapper_takes_plain_version_on_cpu(rng):
    p = _port_problem("mh", engine="torch_tiled", tile=TILE)
    s = tsm.init_state(p)
    before = (tl.tiled_mh.launches, tl.tiled_gibbs.launches)
    a = tl.tiled_segment(p, s, 2)
    b = tl.tiled_segment_reference(p, s, 2)
    assert (tl.tiled_mh.launches, tl.tiled_gibbs.launches) == before
    assert torch.equal(a.result.state.resid, b.result.state.resid)
    with pytest.raises(ValueError, match="does not divide"):
        tl.tiled_segment_reference(p, s, 1, tile=(3, 1))
    meta = dataclasses.replace(p, data_pad=p.data_pad.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tl.tiled_segment(meta, s, 1)


# ---------------------------------------------------------------------------
# (f) the planner and the auto engine rule
# ---------------------------------------------------------------------------

MUSE_FIELD = dict(f=17, ny=18, nx=18, L=3681)      # 300×300×3681, f=17


def test_full_muse_field_has_a_plan_under_the_l2_budget():
    budget = tl.WINDOW_BUDGET_BYTES
    assert budget == 2**30                    # measured on the card
    plan = tl.plan_tiles(**MUSE_FIELD, budget=budget)
    assert plan == (9, 9)
    # the H100's L2, the budget before the measurement, plans (1, 2)
    assert tl.plan_tiles(**MUSE_FIELD, budget=50 * 2**20) == (1, 2)
    ny_t, nx_t = plan
    assert 18 % ny_t == 0 and 18 % nx_t == 0
    assert tl.window_bytes(17, ny_t, nx_t, 3681) <= budget
    # the guide's sizes: a (1, 1) window at float32 weights, 33·33·3681·8 B
    assert tl.window_bytes(17, 1, 1, 3681) == 33 * 33 * 3681 * 8
    assert tl.window_bytes(17, 1, 1, 3681, w_bytes=2) == 33 * 33 * 3681 * 6
    assert tl.plan_tiles(**MUSE_FIELD, budget=1024) is None


def test_planner_prefers_spaxels_then_least_window_volume():
    f, L = 3, 10
    # (1, 4), (4, 1) and (2, 2) hold 4 spaxels each; (2, 2) has the least
    # window volume (8·8 against 5·14 per tile); nothing of 8 fits
    budget = tl.window_bytes(f, 1, 4, L)
    assert tl.window_bytes(f, 2, 4, L) > budget
    assert tl.plan_tiles(f, 4, 4, L, budget) == (2, 2)
    # a field of 1 × 4 blocks: only (1, 4) holds 4
    assert tl.plan_tiles(f, 1, 4, L, budget) == (1, 4)
    # smaller budgets step down to fewer spaxels per step
    assert tl.plan_tiles(f, 4, 4, L, tl.window_bytes(f, 1, 2, L)) == (1, 2)
    assert tl.plan_tiles(f, 4, 4, L, tl.window_bytes(f, 1, 1, L)) == (1, 1)


def test_tile_sweep_covers_the_plan_and_makes_a_seeded_field():
    """``python -m deconv3d_tpu_torch.tile_sweep``'s tiles include the
    full field's plan and one tile; its field is seeded and holds the two
    lines (made on the CPU here, on the card in the smoke)."""
    from deconv3d_tpu_torch import tile_sweep as ts

    tiles = ts.default_tiles(18, 18)
    assert tiles == [(1, 1), (1, 2), (2, 2), (3, 3), (6, 6), (9, 9), (18, 18)]
    assert tl.plan_tiles(**MUSE_FIELD, budget=tl.WINDOW_BUDGET_BYTES) in tiles
    assert (1, 2) in tiles
    assert ts.default_tiles(2, 4) == [(1, 1), (1, 2), (2, 2)]
    a = ts.field_cube(L=12, Y=30, X=30, device="cpu")
    b = ts.field_cube(L=12, Y=30, X=30, device="cpu")
    assert a.shape == (12, 30, 30) and torch.equal(a.data, b.data)
    assert float(a.data[6, 15, 15]) > 40 and float(a.data[4, 8, 20]) > 20


@pytest.mark.parametrize("geometry, budget, want", [
    (dict(f=17, ny=2, nx=2, L=600), None, ("cuda", None)),          # bench
    (dict(f=17, ny=4, nx=4, L=3681), None, ("cuda", None)),         # 60×60
    (dict(f=17, ny=8, nx=8, L=3681), None, ("cuda", None)),         # 120×120
    (MUSE_FIELD, None, ("cuda_tiled", (9, 9))),
    (MUSE_FIELD, 50 * 2**20, ("cuda_tiled", (1, 2))),
    (MUSE_FIELD, 40 * 2**20, ("cuda_tiled", (1, 1))),
    (MUSE_FIELD, 10**12, ("cuda", None)),                  # fits the budget
    (MUSE_FIELD, 1024, ("cuda", None)),                    # no tile fits
])
def test_auto_engine_rule_on_a_card(geometry, budget, want):
    budget = tl.WINDOW_BUDGET_BYTES if budget is None else budget
    got = tsm.resolve_engine(tsm.RunConfig(), torch.device("cuda"),
                             budget=budget, **geometry)
    assert got == want


def test_engine_resolution_rules():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    budget = tl.WINDOW_BUDGET_BYTES
    # the CPU stays on the whole-cube scan unless a tile or engine says so
    assert tsm.resolve_engine(tsm.RunConfig(), cpu, budget=budget,
                              **MUSE_FIELD) == ("torch", None)
    assert tsm.resolve_engine(tsm.RunConfig(tile=(2, 3)), cpu, budget=budget,
                              **MUSE_FIELD) == ("torch_tiled", (2, 3))
    assert tsm.resolve_engine(tsm.RunConfig(engine="torch_tiled"), cpu,
                              budget=budget, **MUSE_FIELD) == (
                                  "torch_tiled", (9, 9))
    assert tsm.resolve_engine(tsm.RunConfig(tile=(1, 2)), cuda, budget=budget,
                              f=17, ny=2, nx=2, L=600) == ("cuda_tiled", (1, 2))
    with pytest.raises(ValueError, match="needs a tiled engine"):
        tsm.resolve_engine(tsm.RunConfig(engine="cuda", tile=(1, 1)), cuda,
                           budget=budget, **MUSE_FIELD)
    with pytest.raises(ValueError, match="does not divide"):
        tsm.resolve_engine(tsm.RunConfig(tile=(4, 1)), cuda, budget=budget,
                           **MUSE_FIELD)
    with pytest.raises(ValueError, match="no tile"):
        tsm.resolve_engine(tsm.RunConfig(engine="cuda_tiled"), cuda,
                           budget=1024, **MUSE_FIELD)
    with pytest.raises(RuntimeError, match="cannot run on cpu"):
        tsm.resolve_engine(tsm.RunConfig(engine="cuda_tiled"), cpu,
                           budget=budget, **MUSE_FIELD)
    with pytest.raises(ValueError, match="engine must be"):
        tsm._check_config(tsm.RunConfig(engine="pallas_tiled"))


# ---------------------------------------------------------------------------
# (g) the χ² rebaseline
# ---------------------------------------------------------------------------

def test_rebaseline_auto_rule(rng, monkeypatch):
    big, small = tsm.REBASELINE_AUTO_BYTES + 1, tsm.REBASELINE_AUTO_BYTES
    assert tsm.auto_rebaseline_every("gibbs", big) == 8
    assert tsm.auto_rebaseline_every("gibbs", small) == 0
    assert tsm.auto_rebaseline_every("mh", big) == 0
    assert tsm.auto_rebaseline_every("mh", small) == 0
    # off for small problems on every engine ...
    for kw in ({}, dict(engine="torch_tiled", tile=TILE)):
        for sampler in ("mh", "gibbs"):
            p = _port_problem(sampler, **kw)
            assert p.config.chi2_rebaseline_every == 0
    # ... and make_problem applies the rule to the clean cube's bytes
    monkeypatch.setattr(tsm, "REBASELINE_AUTO_BYTES", 1024)
    p = _port_problem("gibbs", engine="torch_tiled", tile=TILE)
    assert p.config.chi2_rebaseline_every == 8
    assert _port_problem("gibbs").config.chi2_rebaseline_every == 8
    assert _port_problem("mh").config.chi2_rebaseline_every == 0
    p = _port_problem("gibbs", chi2_rebaseline_every=3)
    assert p.config.chi2_rebaseline_every == 3
    with pytest.raises(ValueError, match=">= 0"):
        _port_problem("gibbs", chi2_rebaseline_every=-1)


def _rebaseline_problem(every, sampler="gibbs"):
    return _port_problem(sampler, dtype=np.float64, engine="torch_tiled",
                         tile=TILE, chi2_rebaseline_every=every,
                         max_iterations=100, burn_in=4, seed=2)


def test_rebaseline_kills_injected_drift(rng):
    for every, survives in ((4, False), (0, True)):
        p = _rebaseline_problem(every)
        r = tsm.run_sweeps(p, tsm.init_state(p), 2)
        poisoned = dataclasses.replace(r.state, chi2=r.state.chi2 + 1e3)
        r2 = tsm.run_sweeps(p, poisoned, 4)               # crosses sweep 4
        gap = abs(float(r2.state.chi2) - float(tsm.full_chi2(p, r2.state)))
        if survives:
            assert gap > 100
        else:
            assert gap / float(tsm.full_chi2(p, r2.state)) < 1e-5


def test_rebaseline_preserves_chain(rng):
    pa = _rebaseline_problem(3)
    pb = _rebaseline_problem(0)
    ra = tsm.run_sweeps(pa, tsm.init_state(pa), 10)
    rb = tsm.run_sweeps(pb, tsm.init_state(pb), 10)
    for name in ("clean", "resid", "key", "log_scale", "sum_clean", "sum_sq",
                 "n_accept", "n_propose", "sweep"):
        assert torch.equal(getattr(ra.state, name),
                           getattr(rb.state, name)), name
    np.testing.assert_allclose(ra.chi2_trace.numpy(), rb.chi2_trace.numpy(),
                               rtol=5e-6)
    assert ra.chi2_trace.shape == (10,)


def test_rebaseline_segmentation_invariant_and_per_chain(rng):
    p = _rebaseline_problem(4)
    a = tsm.run_sweeps(p, tsm.init_state(p), 10)
    s = tsm.init_state(p)
    for k in (3, 1, 4, 2):
        s = tsm.run_sweeps(p, s, k).state
    assert torch.equal(a.state.clean, s.clean)
    assert torch.equal(a.state.chi2, s.chi2)
    # a chain-stacked state: every chain is reset at the same boundary
    states = ch.init_chain_states(p, 2)
    states = dataclasses.replace(states, chi2=states.chi2 + 1e3)
    r = tsm.run_sweeps(p, states, 4)
    assert r.chi2_trace.shape == (2, 4)
    for c in range(2):
        one = ch.select_chains(r.state, c)
        assert float(one.chi2) == float(tsm.full_chi2(p, one))
        assert float(one.chi2_comp) == 0.0


# ---------------------------------------------------------------------------
# (h) Run on the plain tiled engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_run_tiled_round_trip(rng, tmp_path, sampler):
    data, var, mask = _inputs(rng)
    cube = d3.Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                             cdelt=1.25)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                           lsf=tins.GaussianLSF(fwhm=2.0))
    run = d3.Run(cube, inst, sampler=sampler, max_iterations=8, burn_in=4,
                 fsf_size=3, lsf_width=5, seed=3, n_chains=2,
                 engine="torch_tiled", tile=TILE, chi2_rebaseline_every=4,
                 device="cpu")
    assert run.config.engine == "torch_tiled" and run.config.tile == TILE
    run.run()
    diag = run.diagnostics()
    assert diag["engine"] == "torch_tiled" and diag["sweeps"] == 8
    assert np.isfinite(diag["rhat_chi2"])
    if sampler == "gibbs":
        assert diag["acceptance_rate"] == 1.0
    for c in range(2):
        one = ch.select_chains(run.states, c)
        np.testing.assert_allclose(float(one.chi2),
                                   float(tsm.full_chi2(run.problem, one)),
                                   rtol=1e-5)
    run.save(str(tmp_path / "t"))
    clean = d3.Cube.from_fits(str(tmp_path / "t_clean.fits"))
    assert clean.shape == cube.shape and bool(torch.isfinite(clean.data).all())
