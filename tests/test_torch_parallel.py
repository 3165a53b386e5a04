"""The port's meshes (``deconv3d_tpu_torch/parallel/``) against the JAX
package's ``parallel/`` and against the single-device engines.

One process drives every slot of a ``parallel.Mesh``; here the slots are
the CPU (torch has one CPU device), D = 2 and 4, beside the JAX package's 8
virtual CPU devices (``tests/conftest.py``).  JAX is imported inside the
tests, so the file also loads on the card without it (``pytest
--noconftest -m gpu``).

  * layouts and collectives: ``overlap_shard`` / ``overlap_unshard``,
    ``halo_exchange`` exactly, ``convolve_cube_sharded`` and
    ``sharded_chi2`` (rel 1e-12 in float64, 1e-6 in float32) against the
    JAX functions; ``_band_rows`` equal to JAX's;
  * ``run_sweeps_sharded`` (the plain color step with the per-color halo
    push) with injected uniforms equal to the single-device plain sweep bit
    for bit at D = 2 and 4, every sampler and positivity, and with coarse
    passes on the Philox draws;
  * the band sweeps of ``kernel_sharded`` with ``interior='torch'`` (the
    band kernels' plain version): one MH segment against a band-major
    composition of the JAX package's per-color functions, and the twins of
    ``tests/test_kernel_sharded.py``;
  * ``Run(spatial_mesh=...)``, ``Run(mesh=...)``, ``chains.run_chains``
    with a mesh, and ``Run`` without a card;
  * the layering: no module of ``ops/`` imports ``parallel/``;
  * two ``gpu`` tests: the band launch against a launch on a cut buffer,
    and two shards on one card against their plain version.
"""

import ast
import dataclasses
import logging
import pathlib

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import philox
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.ops import tiled as tl
from deconv3d_tpu_torch.parallel import Mesh, make_mesh, mesh as pm
from deconv3d_tpu_torch.parallel import kernel_sharded as ks
from deconv3d_tpu_torch.parallel import sharded as sh
from deconv3d_tpu_torch.parallel import sweep_sharded as ss

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Toy sizes: torch's intra-op threads cost more than they give, and
    under a parallel test run they contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, axis="sp"):
    return Mesh([CPU] * n, (axis,))


def _jax_mesh(n, axis="sp"):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.asarray(jax.devices()[:n]), (axis,))


def _cube(rng, ny_mult=4, nx_cells=2, f=5, L=16, dtype=np.float64,
          noise=0.2):
    """A field of ny_mult × nx_cells spaxel blocks of f: two sources and
    noise (``tests/test_sweep_sharded.py``'s geometry)."""
    Y, X = ny_mult * f, nx_cells * f
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 2, 2] = 3.0
    data = (truth + noise * rng.standard_normal(truth.shape)).astype(dtype)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=dtype)
    return cube, inst


def _problem(rng, dtype=np.float64, ny_mult=4, nx_cells=2, **cfg):
    cube, inst = _cube(rng, ny_mult=ny_mult, nx_cells=nx_cells, dtype=dtype)
    kw = dict(max_iterations=30, burn_in=10, seed=4, fsf_size=5, lsf_width=5,
              dtype=dtype)
    kw.update(cfg)
    return sm.make_problem(cube, inst, sm.RunConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# Layouts and collectives against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4])
def test_overlap_layout_matches_jax(rng, ndev):
    from deconv3d_tpu.parallel import sweep_sharded as jss

    f = 5
    resid = rng.standard_normal((3, f - 1 + 8 * f, 11))
    want = np.asarray(jss.overlap_shard(resid, f, ndev))
    got = ss.overlap_shard(torch.as_tensor(resid), f, ndev)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ss.overlap_unshard(got, f, ndev).numpy(),
        np.asarray(jss.overlap_unshard(want, f, ndev)))
    np.testing.assert_array_equal(ss.overlap_unshard(got, f, ndev).numpy(),
                                  resid)


@pytest.mark.parametrize("ndev", [2, 4])
def test_halo_exchange_matches_jax(rng, ndev):
    import functools

    import jax
    from jax.sharding import PartitionSpec as P
    from deconv3d_tpu.parallel import sharded as jsh

    x = rng.standard_normal((4 * ndev, 6))

    @functools.partial(jax.shard_map, mesh=_jax_mesh(ndev),
                       in_specs=P("sp", None), out_specs=(P("sp", None),) * 2)
    def run(xl):
        return jsh.halo_exchange(xl, 2, axis_name="sp", edge_axis=0)

    want_prev, want_next = (np.asarray(a) for a in run(x))
    prev, nxt = sh.halo_exchange(
        pm.split(torch.as_tensor(x), [CPU] * ndev), 2, edge_axis=0)
    np.testing.assert_array_equal(torch.cat(prev).numpy(), want_prev)
    np.testing.assert_array_equal(torch.cat(nxt).numpy(), want_next)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_convolve_and_chi2_sharded_match_jax(rng, ndev, dtype, rel):
    import jax
    import jax.numpy as jnp
    from deconv3d_tpu.parallel import sharded as jsh

    L, Y, X, f = 16, 8, 6, 5
    clean = rng.standard_normal((L, Y, X)).astype(dtype)
    fsf = rng.random((L, f, f)).astype(dtype)
    fsf /= fsf.sum(axis=(1, 2), keepdims=True)
    lsf = rng.random((L, 5)).astype(dtype)
    lsf /= lsf.sum(axis=1, keepdims=True)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        want = np.array(jsh.convolve_cube_sharded(
            jnp.asarray(clean), jnp.asarray(fsf), jnp.asarray(lsf),
            _jax_mesh(ndev)))
        data, weights = (rng.standard_normal((L, Y, X)).astype(dtype),
                         rng.random((L, Y, X)).astype(dtype))
        want_chi2 = float(jsh.sharded_chi2(
            jnp.asarray(data), jnp.asarray(want), jnp.asarray(weights),
            _jax_mesh(ndev)))
    finally:
        jax.config.update("jax_enable_x64", prev)
    devices = [CPU] * ndev
    got = torch.cat(sh.convolve_cube_sharded(
        pm.split(torch.as_tensor(clean), devices), torch.as_tensor(fsf),
        torch.as_tensor(lsf))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())
    # the whole-cube convolution of the port says the same
    whole = cv.convolve_cube(torch.as_tensor(clean), torch.as_tensor(fsf),
                             torch.as_tensor(lsf)).numpy()
    np.testing.assert_allclose(got, whole, rtol=0,
                               atol=rel * np.abs(whole).max())
    chi2 = float(sh.sharded_chi2(*(pm.split(torch.as_tensor(a), devices)
                                   for a in (data, want, weights))))
    assert abs(chi2 - want_chi2) <= 1e-6 * abs(want_chi2)
    exact = float(np.sum((data.astype(np.float64) - want) ** 2 * weights))
    assert abs(chi2 - exact) <= 1e-6 * exact


def test_collectives_move_slot_tensors():
    parts = [torch.full((2,), float(i)) for i in range(3)]
    assert [float(t[0]) for t in pm.ppermute(parts, 1)] == [0.0, 0.0, 1.0]
    assert [float(t[0]) for t in pm.ppermute(parts, -1)] == [1.0, 2.0, 0.0]
    assert all(float(t[0]) == 3.0 for t in pm.psum(parts))
    x = torch.arange(24.0).reshape(4, 6)
    rows = pm.all_to_all(pm.split(x, [CPU] * 2, dim=0), 1, 0)
    assert torch.equal(torch.cat(rows, dim=1), x)
    back = pm.all_to_all(rows, 0, 1)
    assert torch.equal(torch.cat(back, dim=0), x)
    with pytest.raises(ValueError, match="divisible"):
        pm.split(x, [CPU] * 3)
    with pytest.raises(ValueError, match="mesh has no 'zz' axis"):
        _mesh(2).rows("zz")


def test_shard_chains_splits_the_chain_axis(rng):
    p = _problem(rng)
    states = ch.init_chain_states(p, 4)
    parts = pm.shard_chains(states, Mesh([CPU] * 2, ("chains",)))
    assert len(parts) == 2
    for i, part in enumerate(parts):
        assert part.clean.shape[0] == 2
        assert torch.equal(part.key, states.key[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="divisible"):
        pm.shard_chains(ch.init_chain_states(p, 3),
                        Mesh([CPU] * 2, ("chains",)))


def test_make_mesh_raises_without_enough_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(1, "sp")


@pytest.mark.parametrize("nyl", [2, 3, 5])
def test_band_rows_match_jax(nyl):
    from deconv3d_tpu.parallel import kernel_sharded as jks

    assert ks._band_rows(nyl, 17) == jks._band_rows(nyl, 17)


# ---------------------------------------------------------------------------
# The plain sharded sweep: the single-device sweep bit for bit
# ---------------------------------------------------------------------------

STATE_FIELDS = ("clean", "resid", "log_scale", "chi2", "chi2_comp",
                "n_accept", "n_propose", "sum_clean", "sum_sq", "sweep")


def _assert_bit_equal(got, want):
    for name in STATE_FIELDS:
        assert torch.equal(getattr(got.state, name),
                           getattr(want.state, name)), name
    for name in ("chi2_trace", "accept_trace", "monitor_trace"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # the flux trace adds the shards' float32 partial sums: another order
    # of the same sum, within its rounding bound
    scale = float(want.state.clean.abs().sum())
    torch.testing.assert_close(got.flux_trace, want.flux_trace, rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("sampler,kw", [
    ("mh", {}), ("gibbs", {}), ("gibbs_block", {}),
    ("mh", {"positivity": True}), ("gibbs", {"positivity": True}),
])
def test_sharded_sweep_matches_single_device(rng, ndev, sampler, kw):
    p = _problem(rng, sampler=sampler, **kw)
    s0 = sm.init_state(p)
    n = 3
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = rng.random((n, p.n_colors, p.ny * p.nx, *per))
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24))
    ref = sw._run_segment(p, s0, n, u, False, mode=sampler).result
    got = ss.run_sweeps_sharded(p, s0, n, _mesh(ndev), uniforms=u)
    assert float(got.state.n_accept) > 0, "vacuous"
    _assert_bit_equal(got, ref)


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_sweep_with_coarse_matches_single_device(rng, ndev):
    """Philox draws and coarse passes at absolute sweeps 3 and 6: the
    sharded run is ``sampler.run_sweeps`` bit for bit."""
    p = _problem(rng, coarse_every=3, coarse_mode="global")
    s0 = sm.init_state(p)
    ref = sm.run_sweeps(p, s0, 7)
    got = ss.run_sweeps_sharded(p, s0, 7, _mesh(ndev))
    _assert_bit_equal(got, ref)
    plain = dataclasses.replace(p, config=dataclasses.replace(
        p.config, coarse_every=None))
    fine = ss.run_sweeps_sharded(plain, s0, 7, _mesh(ndev))
    assert float(got.state.n_propose) > float(fine.state.n_propose)


def test_sharded_sweep_rejections(rng):
    p = _problem(rng, ny_mult=3)
    with pytest.raises(ValueError, match="divisible"):
        ss.run_sweeps_sharded(p, sm.init_state(p), 2, _mesh(2))
    with pytest.raises(ValueError, match="1-D mesh"):
        ss.run_sweeps_sharded(p, sm.init_state(p), 2,
                              Mesh([[CPU] * 3] * 2, ("ch", "sp")))


def test_sharded_invariant_across_edges(rng):
    """data − resid == conv(clean), the rows written by the halo pushes
    included (float64)."""
    p = _problem(rng)
    st = ss.run_sweeps_sharded(p, sm.init_state(p), 20, _mesh(4)).state
    assert _invariant_err(p, st) < 1e-9
    assert float(st.n_accept) > 20


# ---------------------------------------------------------------------------
# The band sweeps (interior='torch'): the JAX composition and the twins of
# tests/test_kernel_sharded.py
# ---------------------------------------------------------------------------

def _invariant_err(p, st):
    h = p.f // 2
    conv = cv.convolve_cube(st.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = p.data_pad[:, h:h + p.Y, h:h + p.X] - st.resid[:, h:h + p.Y,
                                                           h:h + p.X]
    w = p.w_pad[:, h:h + p.Y, h:h + p.X] > 0
    return float((model - conv)[w].abs().max() / conv.abs().max())


def _band_problem(rng, **cfg):
    """Float32, 8 × 4 spaxel blocks (f = 5): D = 2 gives every shard a top,
    an interior and a bottom band."""
    return _problem(rng, dtype=np.float32, ny_mult=8, nx_cells=4, **cfg)


def _band_order(ny, ndev):
    """(first block row, rows) of every band in the sweep's order: the
    interiors, the tops, the bottoms, each over the shards in order (the
    toy's bands are one tile each)."""
    nyl = ny // ndev
    bands = {name: (rows0 // 5, nyb) for name, rows0, nyb, _
             in ks._band_rows(nyl, 5)}
    order = [bands[n] for n in ("interior", "top", "bottom") if n in bands]
    return [(d * nyl + b0, nyb) for b0, nyb in order for d in range(ndev)]


def test_band_order_mh_matches_jax_composition(rng):
    """Two MH sweeps of two shards' bands with injected (untied) uniforms
    against the JAX package's per-color functions applied band by band to
    the whole field in the same order — ``tests/test_torch_tiled.py``'s
    composition, each band one tile.  Tolerances as there."""
    import jax
    import jax.numpy as jnp

    from deconv3d_tpu import Cube as JCube
    from deconv3d_tpu import instruments as jins
    from deconv3d_tpu import sampler as jsm
    from deconv3d_tpu_torch import interop

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        cube, _ = _cube(rng, ny_mult=8, nx_cells=4, dtype=np.float32)
        data = cube.data.numpy()
        cfg = dict(max_iterations=2, burn_in=1, seed=1, fsf_size=5,
                   lsf_width=5)
        jp = jsm.make_problem(
            JCube.from_data(data, variance=cube.variance.numpy(),
                            crval=4750.0, cdelt=1.25),
            jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                            lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
            jsm.RunConfig(engine="pallas", **cfg))
        js = jsm.init_state(jp)
        tp = interop.problem_from_numpy(
            {f.name: None if getattr(jp, f.name) is None
             else np.asarray(getattr(jp, f.name))
             for f in dataclasses.fields(jp) if f.name != "config"},
            sm.RunConfig(**cfg))
        ts = interop.state_from_numpy(
            {f.name: np.asarray(getattr(js, f.name))
             for f in dataclasses.fields(js)})
        n, ndev = 2, 2
        devices = [CPU] * ndev
        u = rng.random((n, tp.n_colors, tp.ny * tp.nx, tp.L + 1),
                       dtype=np.float32)
        u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24))
        u, seg = sw.untie_uniforms(
            tp, ts, n, u, reference=lambda p_, s_, k_, u_: ks.segment(
                p_, s_, k_, devices, "torch", u_))
        want = _jax_band_mh(jp, js, n, u.numpy(), _band_order(jp.ny, ndev))
    finally:
        jax.config.update("jax_enable_x64", prev)
    got = seg.result.state
    assert 0 < want["accept"].sum() < want["accept"].size, "vacuous"
    np.testing.assert_array_equal(seg.accept.numpy(), want["accept"])
    for name in ("resid", "clean"):
        w = want[name]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(got.log_scale.numpy(), want["log_scale"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)


def _jax_band_mh(p, state, n_sweeps, u, bands):
    """The band-order MH scan from the JAX package's per-color functions:
    per sweep the ``bands`` (first block row, rows) in order, all f² colors
    in each, every step restricted to the band's spaxels."""
    import jax.numpy as jnp

    from deconv3d_tpu import sampler as jsm

    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    cfg = p.config
    bounds = jsm._slab_bounds(L, cfg)
    resid, clean, ls = state.resid, state.clean, state.log_scale
    chi2, chi2c = state.chi2, state.chi2_comp
    adapt = jsm.adapt_schedule(jnp.arange(n_sweeps, dtype=jnp.int32), cfg)
    shape = (n_sweeps, f * f, ny, nx)
    accept = np.zeros(shape, np.float32)
    for s in range(n_sweeps):
        committed = 0.0
        for by0, nyb in bands:
            m = np.zeros((ny, nx), np.float32)
            m[by0:by0 + nyb] = 1.0
            tm = jnp.asarray(m)
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
                on = m > 0
                accept[s, c][on] = np.asarray(accf)[on]
                committed += float(np.asarray(dchi * accf, np.float64).sum())
        y = jnp.float32(committed) - chi2c
        t = chi2 + y
        chi2c, chi2 = (t - chi2) - y, t
    return dict(resid=np.asarray(resid), clean=np.asarray(clean),
                log_scale=np.asarray(ls), chi2=float(chi2),
                accept=accept.reshape(n_sweeps, f * f, ny * nx))


@pytest.mark.parametrize("sampler,ndev", [("mh", 1), ("mh", 2), ("mh", 4),
                                          ("gibbs", 2)])
def test_invariant_and_chi2_across_shard_edges(rng, sampler, ndev):
    p = _band_problem(rng, sampler=sampler)
    s0 = sm.init_state(p)
    n = 12 if sampler == "mh" else 3
    st = ks.run_sweeps_kernel_sharded(p, s0, n, _mesh(ndev)).state
    assert float(st.n_accept) > n
    assert _invariant_err(p, st) < 3e-5
    chi_r, chi_f = float(st.chi2), float(sm.full_chi2(p, st))
    assert abs(chi_r - chi_f) / max(chi_f, 1.0) < 2e-5
    moved = (st.clean != s0.clean).any(dim=0).any(dim=1)
    BYl = (p.ny // ndev) * p.f
    assert moved[: p.f].any(), "edge rows never updated"
    if p.ny // ndev > 2:
        assert moved[p.f: BYl - p.f].any(), "interior rows never updated"


def test_segmentation_is_bit_exact(rng):
    p = _band_problem(rng)
    s0 = sm.init_state(p)
    mono = ks.run_sweeps_kernel_sharded(p, s0, 6, _mesh(2))
    part = ks.run_sweeps_kernel_sharded(p, s0, 4, _mesh(2))
    part2 = ks.run_sweeps_kernel_sharded(p, part.state, 2, _mesh(2))
    for name in ("clean", "resid", "log_scale", "chi2"):
        assert torch.equal(getattr(mono.state, name),
                           getattr(part2.state, name)), name
    assert torch.equal(mono.chi2_trace, torch.cat([part.chi2_trace,
                                                   part2.chi2_trace]))


def test_adaptive_scales_update_everywhere(rng):
    p = _band_problem(rng)
    s0 = sm.init_state(p)
    res = ks.run_sweeps_kernel_sharded(p, s0, 6, _mesh(2))
    moved = res.state.log_scale != s0.log_scale
    assert bool((moved | ~p.valid).all())


def _mesh2d(names=("ch", "sp")):
    return Mesh([[CPU] * 2] * 2, names)


def test_chains_compose_with_spatial_sharding(rng):
    """2 chains × 2 shards: each chain bit-equal to itself alone on a
    1 × 2 mesh; the chains differ; the diagnostics run."""
    p = _band_problem(rng)
    states = ch.init_chain_states(p, 2)
    mc = ks.run_chains_kernel_sharded(p, 2, 4, _mesh2d(), states=states)
    for i in range(2):
        ref = ks.run_sweeps_kernel_sharded(p, ch.select_chains(states, i), 4,
                                           _mesh(2))
        for name in ("clean", "resid", "chi2"):
            assert torch.equal(getattr(mc.result.state, name)[i],
                               getattr(ref.state, name)), name
        assert torch.equal(mc.result.chi2_trace[i], ref.chi2_trace)
    assert not torch.equal(mc.result.state.clean[0], mc.result.state.clean[1])
    assert np.isfinite(mc.diagnostics()["rhat_chi2"])


def test_run_chains_routes_spatial_axis(rng):
    p = _band_problem(rng)
    states = ch.init_chain_states(p, 2)
    mesh = _mesh2d(("chains", "sp"))
    via = ch.run_chains(p, 2, 3, mesh=mesh, states=states, spatial_axis="sp")
    direct = ks.run_chains_kernel_sharded(p, 2, 3, mesh, states=states,
                                          chain_axis="chains")
    assert torch.equal(via.result.state.clean, direct.result.state.clean)
    with pytest.raises(ValueError, match="2-D mesh"):
        ch.run_chains(p, 2, 2, states=states, spatial_axis="sp")


def test_chains_compose_rejections(rng):
    p = _band_problem(rng)
    with pytest.raises(ValueError, match="one chain per"):
        ks.run_chains_kernel_sharded(p, 4, 2, _mesh2d())
    with pytest.raises(ValueError, match="no 'zz' axis"):
        ks.run_chains_kernel_sharded(p, 2, 2, _mesh2d(), chain_axis="zz")


def test_coarse_composes_with_kernel_sharded(rng):
    """coarse_every=3 through the band path == band segments interleaved
    by hand with the coarse pass at the same absolute sweeps (bit-exact),
    a segmentation too, and the invariant holds."""
    pc = _band_problem(rng, coarse_every=3, coarse_mode="global")
    s0 = sm.init_state(pc)
    res = ks.run_sweeps_kernel_sharded(pc, s0, 6, _mesh(2))
    consts = sm.coarse_constants_of(pc)
    cur = s0
    for _ in range(2):
        cur = ks.segment(pc, cur, 3, [CPU] * 2, "torch").result.state
        cur = sm.apply_coarse_pass(pc, cur, consts)
    for name in ("clean", "resid", "chi2"):
        assert torch.equal(getattr(res.state, name), getattr(cur, name)), name
    part = ks.run_sweeps_kernel_sharded(pc, s0, 4, _mesh(2))
    part2 = ks.run_sweeps_kernel_sharded(pc, part.state, 2, _mesh(2))
    assert torch.equal(res.state.clean, part2.state.clean)
    assert torch.equal(res.state.resid, part2.state.resid)
    assert _invariant_err(pc, res.state) < 3e-5
    chi_f = float(sm.full_chi2(pc, res.state))
    assert abs(float(res.state.chi2) - chi_f) / chi_f < 2e-5


def test_coarse_composes_chains_times_spatial(rng):
    pc = _band_problem(rng, coarse_every=3, coarse_mode="global")
    states = ch.init_chain_states(pc, 2)
    mc = ks.run_chains_kernel_sharded(pc, 2, 4, _mesh2d(), states=states)
    for i in range(2):
        ref = ks.run_sweeps_kernel_sharded(pc, ch.select_chains(states, i),
                                           4, _mesh(2))
        assert torch.equal(mc.result.state.clean[i], ref.state.clean)
        assert torch.equal(mc.result.state.resid[i], ref.state.resid)


def test_rejects_wrong_configs(rng):
    p = _band_problem(rng)
    s0 = sm.init_state(p)
    with pytest.raises(ValueError, match="divisible"):
        ks.run_sweeps_kernel_sharded(p, s0, 2, _mesh(3))
    with pytest.raises(ValueError, match="block-rows per shard"):
        ks.run_sweeps_kernel_sharded(p, s0, 2, _mesh(8))
    with pytest.raises(ValueError, match="'cuda' or 'torch'"):
        ks.run_sweeps_kernel_sharded(p, s0, 2, _mesh(2), interior="jnp")
    with pytest.raises(ValueError, match="CUDA device"):
        ks.run_sweeps_kernel_sharded(p, s0, 2, _mesh(2), interior="cuda")
    for kw, match in (({"sampler": "gibbs_block"}, "mh"),
                      ({"positivity": True}, "positivity")):
        q = dataclasses.replace(p, config=dataclasses.replace(p.config,
                                                              **kw))
        with pytest.raises(ValueError, match=match):
            ks.run_sweeps_kernel_sharded(q, s0, 2, _mesh(2))


# ---------------------------------------------------------------------------
# Run, chains, no card
# ---------------------------------------------------------------------------

def _run_inputs(rng):
    f, L = 5, 16
    truth = rng.standard_normal((L, 4 * f, 2 * f)).astype(np.float32)
    cube = d3.Cube.from_data(truth, variance=np.ones_like(truth),
                             crval=4750.0, cdelt=1.25)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0))
    return cube, inst, dict(max_iterations=4, burn_in=1, fsf_size=f,
                            lsf_width=5, device="cpu")


@pytest.mark.parametrize("spatial", ["int", "mesh"])
def test_run_facade_spatial_mesh(rng, spatial):
    """``Run(spatial_mesh=4 | Mesh)`` on a plain-step sampler (MH with
    positivity) matches the unsharded Run sweep for sweep, bit for bit."""
    cube, inst, kw = _run_inputs(rng)
    kw.update(positivity=True, max_iterations=6)
    ref = d3.Run(cube, inst, **kw).run()
    shd = d3.Run(cube, inst, spatial_mesh=4 if spatial == "int"
                 else _mesh(4), **kw)
    assert not shd._spatial_kernel
    shd.run()
    assert torch.equal(shd.states.clean, ref.states.clean)
    np.testing.assert_array_equal(shd.trace("chi2"), ref.trace("chi2"))
    assert shd.sweeps_done == 6


def test_run_facade_spatial_mesh_engine_resolution(rng, caplog):
    """mh / gibbs route to the band sweeps; gibbs_block and positivity to
    the plain color step, which warns that a named engine is ignored."""
    cube, inst, kw = _run_inputs(rng)
    for smp in ("mh", "gibbs"):
        r = d3.Run(cube, inst, spatial_mesh=2, sampler=smp, **kw)
        assert r._spatial_kernel and r.problem.fsf_spec is not None, smp
    for smp, extra in (("gibbs_block", {}), ("mh", {"positivity": True})):
        with caplog.at_level(logging.WARNING, logger="deconv3d_tpu_torch"):
            caplog.clear()
            r = d3.Run(cube, inst, spatial_mesh=2, sampler=smp,
                       engine="torch", **kw, **extra)
        assert not r._spatial_kernel and r.problem.quad is not None, smp
        assert any("engine='torch' is ignored" in rec.getMessage()
                   for rec in caplog.records), smp


def test_run_facade_spatial_mesh_kernel_rate_end_to_end(rng, tmp_path):
    cube, inst, kw = _run_inputs(rng)
    r = d3.Run(cube, inst, spatial_mesh=_mesh(2), **kw)
    assert r._spatial_kernel
    r.run()
    d = r.diagnostics()
    assert d["sweeps"] == 4 and np.isfinite(d["chi2"])
    assert float(r.states.n_accept.sum()) > 0
    r.save(str(tmp_path / "sp"))
    assert (tmp_path / "sp_clean.fits").is_file()
    assert (tmp_path / "sp_stats.json").is_file()


def test_run_facade_chains_times_spatial(rng, tmp_path):
    cube, inst, kw = _run_inputs(rng)
    r = d3.Run(cube, inst, spatial_mesh=_mesh2d(("chains", "sp")),
               n_chains=2, **kw)
    assert r._spatial_chains
    r.run()
    assert r.sweeps_done == 4 and np.isfinite(r.chi2)
    assert r.states.clean.shape[0] == 2
    assert float(r.states.n_accept.sum()) > 0
    assert "rhat_chi2" in r.diagnostics()
    r.save(str(tmp_path / "cs"))
    with pytest.raises(ValueError, match="composition"):
        d3.Run(cube, inst, spatial_mesh=_mesh2d(), n_chains=3, **kw)


def test_run_facade_spatial_mesh_rejects_multichain(rng):
    cube, inst, kw = _run_inputs(rng)
    with pytest.raises(ValueError, match="n_chains"):
        d3.Run(cube, inst, spatial_mesh=2, n_chains=4, **kw)


def test_run_mesh_splits_chains(rng, tmp_path):
    """``Run(mesh=...)`` splits the chains over the mesh's slots and is the
    unsplit run bit for bit; ``run_chains`` refuses a chain count the mesh
    does not divide."""
    cube, inst, kw = _run_inputs(rng)
    kw.update(max_iterations=8)
    mesh = Mesh([CPU] * 2, ("chains",))
    r = d3.Run(cube, inst, n_chains=2, mesh=mesh, **kw)
    r.run()
    ref = d3.Run(cube, inst, n_chains=2, **kw).run()
    assert torch.equal(r.states.clean, ref.states.clean)
    np.testing.assert_array_equal(r.trace("monitor"), ref.trace("monitor"))
    assert np.isfinite(r.diagnostics()["rhat_chi2"])
    r.save(str(tmp_path / "m"))
    with pytest.raises(ValueError, match="multiple"):
        ch.run_chains(r.problem, 3, 1, mesh=mesh)


def test_run_without_a_card_raises_unless_told_cpu(rng, monkeypatch):
    """``Run`` runs on the card by default: without one it raises, naming
    ``device='cpu'``, and never falls back to the CPU by itself."""
    cube, inst, kw = _run_inputs(rng)
    kw.pop("device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d3.Run(cube, inst, **kw)
    r = d3.Run(cube, inst, device="cpu", **kw)
    assert r.problem.device.type == "cpu"
    r.run(1)


def test_ops_modules_import_nothing_of_parallel():
    """The kernel layer knows nothing of the layer above it: no module of
    ``deconv3d_tpu_torch/ops/`` imports ``deconv3d_tpu_torch.parallel``,
    absolutely or relatively, at its top or inside a function."""
    ops_dir = pathlib.Path(sw.__file__).parent
    modules = sorted(ops_dir.glob("*.py"))
    assert len(modules) > 5
    found = []
    for path in modules:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # a relative import resolved from deconv3d_tpu_torch.ops
                pkg = (["deconv3d_tpu_torch", "ops"][:3 - node.level]
                       if node.level else [])
                mod = ".".join(pkg + [node.module] if node.module else pkg)
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            found += [(path.name, node.lineno, n) for n in names
                      if n == "deconv3d_tpu_torch.parallel"
                      or n.startswith("deconv3d_tpu_torch.parallel.")]
    assert not found, found


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_band_launch_equals_cut_buffer_launch_on_card(sampler):
    """The band arguments of ``csrc/tiled_sweep.cu``: a launch on block
    rows [by0, by0 + nyb) of the whole buffer equals a launch on a buffer
    cut to the band's window whose row 0 is the field's block row by0, bit
    for bit (top, interior, bottom; C = 1 and 2), and the cut launch draws
    ``ops/philox.py``'s numbers at the field's rows.  Full size:
    chip_smoke.py phase ``sharded_band_launch``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernel has no CPU mode")
    p = _problem(np.random.default_rng(3), dtype=np.float32, ny_mult=4,
                 nx_cells=3, sampler=sampler)
    p = p.to("cuda")
    f, nx = p.f, p.nx
    for C in (1, 2):
        states = ch.init_chain_states(p, C)
        for by0, nyb in ((0, 1), (1, 2), (3, 1)):
            whole = tl.band_segment(p, states, 1, (by0, nyb))
            cut = tl.band_segment(ss.cut_problem(p, by0, nyb),
                                  ss.cut_state(states, f, by0, nyb, p.device),
                                  1, (0, nyb), gy0=by0,
                                  record_uniforms=True)
            y0, rows = by0 * f, nyb * f
            w, c = whole.result.state, cut.result.state
            assert torch.equal(w.resid[..., y0:y0 + rows + f - 1, :], c.resid)
            assert torch.equal(w.clean[..., y0:y0 + rows, :], c.clean)
            assert torch.equal(whole.accept[..., by0 * nx:(by0 + nyb) * nx],
                               cut.accept)
            draws = (philox.sweep_uniforms if sampler == "mh"
                     else philox.gibbs_sweep_uniforms)
            want = torch.stack([draws(key, 0, p.n_colors, nyb * nx, p.L,
                                      device="cuda", row0=by0 * nx)
                                for key in sw._chain_keys(states.key)])
            assert torch.equal(cut.uniforms[0], want)
            assert bool((w.clean[..., y0:y0 + rows, :]
                         != states.clean[..., y0:y0 + rows, :]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_two_shards_on_one_card_match_plain(sampler):
    """``Mesh([cuda:0] * 2)``: the band launches (``interior='cuda'``)
    against the plain band scans on the same injected uniforms — MH
    decisions equal, resid within 1e-4 of its scale, χ² rtol 1e-5 — and χ²
    consistency ≤ 1e-5.  Full size: chip_smoke.py phase
    ``sharded_shards_vs_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernel has no CPU mode")
    p = _band_problem(np.random.default_rng(5), sampler=sampler).to("cuda")
    s0 = sm.init_state(p)
    dev = torch.device("cuda", 0)
    devices = [dev, dev]
    n = 2
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(6).random(
        (n, p.n_colors, p.ny * p.nx, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    reference = lambda p_, s_, k_, u_: ks.segment(  # noqa: E731
        p_, s_, k_, devices, "torch", u_)
    if sampler == "mh":
        u, plain = sw.untie_uniforms(p, s0, n, u, reference=reference)
    else:
        plain = reference(p, s0, n, u)
    counter = tl.band_mh if sampler == "mh" else tl.band_gibbs
    n0 = counter.launches
    kern = ks.segment(p, s0, n, devices, "cuda", u)
    assert counter.launches - n0 == 3 * 2 * n
    assert torch.equal(plain.accept, kern.accept)
    ref = plain.result.state.resid
    torch.testing.assert_close(kern.result.state.resid, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)
    st = kern.result.state
    chi_f = float(sm.full_chi2(p, st))
    assert abs(float(st.chi2) - chi_f) / chi_f <= 1e-5
