"""The sharded direct sampler and MAP (``parallel/direct_sharded.py``).

Twins of ``tests/test_direct_sharded.py`` on meshes of CPU slots
(``Mesh(["cpu"] * D)``), float64 at small sizes: the sharded K, Kᵀ and A
against the unsharded port operator and the JAX package's, for even and
uneven row cuts and shards thinner than the FSF's reach, in both spatial
modes; the sharded M⁻¹ in every preconditioner mode against the unsharded
one (the JAX package's CPU tests could hold only Jacobi sharded); draws
and the MAP at the JAX tests' bounds; segmentation; the refusals; the
``Run`` routes; the ragged all-to-all.  JAX is imported inside the tests,
so the file also loads on the card without it; one ``gpu`` test (two
shards on one card) decides inside its body.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import banded as bd
from deconv3d_tpu_torch.ops import direct as td
from deconv3d_tpu_torch.parallel import Mesh, mesh as pm
from deconv3d_tpu_torch.parallel import direct_sharded as ds

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


def _cube_data(rng, L, Y, X, f, noise=0.2):
    """``tests/test_direct_sharded.py::_problem``'s field: two sources
    through the instrument plus noise (FSF fwhm 0.25 px keeps A well
    conditioned, so the draws are solver-tight)."""
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, min(10, Y - 1), min(4, X - 1)] = 3.0
    lam = 4750.0 + 1.25 * np.arange(L)
    fsf = tins.GaussianFSF(fwhm=0.25).bank(lam, size=f, pixel_scale=0.2)
    lsf = tins.GaussianLSF(fwhm=1.5).bank(lam, cdelt=1.25, width=5)
    conv = d3.convolve_cube(torch.tensor(truth), torch.tensor(fsf),
                            torch.tensor(lsf)).numpy()
    return conv + noise * rng.standard_normal(conv.shape)


def _inst():
    return tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.25),
                           lsf=tins.GaussianLSF(fwhm=1.5), pixel_scale=0.2)


def _config(f, **kw):
    cfg = dict(max_iterations=30, burn_in=0, seed=4, fsf_size=f,
               lsf_width=5, sampler="direct", dtype=np.float64,
               direct_tol=1e-9, direct_maxiter=400)
    cfg.update(kw)
    return cfg


def _problem(rng, f=9, L=12, Y=24, X=10, dtype=np.float64, **kw):
    """The port's own direct problem of the toy field."""
    data = _cube_data(rng, L, Y, X, f)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.04),
                             crval=4750.0, cdelt=1.25, dtype=dtype,
                             device="cpu")
    return tsm.make_problem(cube, _inst(), tsm.RunConfig(
        **_config(f, dtype=dtype, **kw)), device="cpu")


def _pair(rng, f=9, L=12, Y=24, X=10, **kw):
    """(JAX problem, the same problem carried to the port)."""
    import jax

    from deconv3d_tpu import Cube as JCube
    from deconv3d_tpu import instruments as jins
    from deconv3d_tpu import sampler as jsm

    jax.config.update("jax_enable_x64", True)
    data = _cube_data(rng, L, Y, X, f)
    jp = jsm.make_problem(
        JCube.from_data(data, variance=np.full_like(data, 0.04),
                        crval=4750.0, cdelt=1.25, dtype=np.float64),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.25),
                        lsf=jins.GaussianLSF(fwhm=1.5), pixel_scale=0.2),
        jsm.RunConfig(**_config(f, **kw)))
    leaves = {g.name: getattr(jp, g.name) for g in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in leaves.items() if k != "config"},
        interop.config_from_mapping(dataclasses.asdict(jp.config)))
    return jp, tp


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (i) the operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D, Y, spatial", [
    (1, 24, "fft"), (2, 24, "fft"), (3, 24, "fft"), (8, 24, "fft"),
    (8, 63, "fft"),       # uneven: 8 blocks of 8 and one of 7 rows
    (4, 12, "fft"),       # 3 rows a shard, fewer than f // 2 = 4
    (2, 24, "direct"), (3, 25, "direct"), (4, 12, "direct"),
])
def test_operator_matches_unsharded_and_jax(rng, D, Y, spatial):
    """K, Kᵀ and A = P(KᵀWK + τI)P on the row blocks against the
    unsharded port operator and ``deconv3d_tpu.ops.direct``'s, rel
    1e-12 (float64)."""
    from deconv3d_tpu.ops import direct as jdr

    jp, tp = _pair(rng, Y=Y, direct_spatial=spatial, prior_precision=0.3)
    mesh = _mesh(D)
    sh = ds.shards(tp, mesh)
    assert [b - a for a, b in sh.rows] == [
        len(t) for t in torch.tensor_split(torch.arange(Y), D)]
    c = rng.standard_normal((tp.L, tp.Y, tp.X))
    parts = sh.cut(torch.tensor(c))
    K = sh.gather(sh.K(tp, parts), CPU)
    KT = sh.gather(sh.KT(tp, parts), CPU)
    A = sh.gather(ds.make_normal_operator(tp, mesh)(parts), CPU)
    for got, port, jax_fn in (
            (K, td.apply_K(tp, torch.tensor(c)), jdr.apply_K),
            (KT, td.apply_KT(tp, torch.tensor(c)), jdr.apply_KT),
            (A, td.make_normal_operator(tp)(torch.tensor(c)),
             lambda pp, x: jdr.make_normal_operator(pp)(x))):
        assert _rel(got, port) <= 1e-12
        assert _rel(got, jax_fn(jp, c)) <= 1e-12


# ---------------------------------------------------------------------------
# (ii) the preconditioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["banded", "banded_radial", "jacobi"])
@pytest.mark.parametrize("scale", [False, True])
def test_preconditioner_matches_unsharded(rng, mode, scale):
    """M⁻¹ on the row blocks (rfft over X, ragged all-to-all, FFT over Y,
    the slot's solve, back) against the unsharded ``make_preconditioner``,
    rel 1e-12, on 3 uneven blocks (9, 8, 8 rows; kx columns 2, 2, 2) and
    8 blocks of 8 / 7 rows whose kx columns (6) leave two slots none."""
    for D, Y in ((3, 25), (8, 63)):
        p = _problem(rng, Y=Y, direct_precond_scale=scale,
                     direct_radial_bins=8, prior_precision=0.3)
        mesh = _mesh(D)
        sh = ds.shards(p, mesh)
        r = torch.tensor(rng.standard_normal((p.L, p.Y, p.X)))
        got = sh.gather(ds.make_preconditioner(p, mesh, mode=mode)(
            sh.cut(r)), CPU)
        want = td.make_preconditioner(p, mode=mode)(r)
        assert _rel(got, want) <= 1e-12, (mode, scale, D)
    if mode == "banded_radial":
        assert not torch.allclose(
            want, td.make_preconditioner(p, mode="banded")(r))


def test_preconditioner_solves_once_per_slot(rng, monkeypatch):
    """One ``banded_solve`` call per slot and application, on the slot's
    kx columns with their factor indices."""
    p = _problem(rng, Y=25)
    mesh = _mesh(3)
    calls, real = [], bd.banded_solve

    def spy(R, fidx, b, out=None):
        calls.append((tuple(b.shape), fidx.clone()))
        return real(R, fidx, b, out=out)

    monkeypatch.setattr(bd, "banded_solve", spy)
    M = ds.make_preconditioner(p, mesh)
    sh = ds.shards(p, mesh)
    M(sh.cut(torch.tensor(rng.standard_normal((p.L, p.Y, p.X)))))
    Xr = p.X // 2 + 1
    assert [s for s, _ in calls] == [(p.L, p.Y * (b - a) * 2)
                                     for a, b in sh.cols]
    whole = td._column_factors(p, np.arange(p.Y * Xr)).view(p.Y, Xr, 2)
    for (_, fidx), (a, b) in zip(calls, sh.cols):
        assert torch.equal(fidx, whole[:, a:b].reshape(-1))


# ---------------------------------------------------------------------------
# (iii)-(v) draws, segmentation, the MAP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("injected", [False, True])
def test_draws_match_unsharded_at_solver_tolerance(rng, injected):
    """Sharded draws against unsharded port draws with the same normals
    (Philox rows, or injected z and z2 cut by rows): every solve
    converged, clean within 1e-5 of scale, χ² within 1e-5 relative — the
    JAX tests' bounds — and the state's contract."""
    p = _problem(rng, Y=25, prior_precision=0.3)
    normals = None
    if injected:
        normals = tuple(torch.tensor(rng.standard_normal((3, p.L, p.Y, p.X)))
                        for _ in range(2))
    ref = td.direct_run_sweeps(p, tsm.init_state(p), 3, normals=normals)
    got = ds.run_direct_sweeps_sharded(p, tsm.init_state(p), 3, _mesh(3),
                                       normals=normals)
    assert ref.accept_trace.tolist() == got.accept_trace.tolist() == [1.0] * 3
    scale = float(ref.state.clean.abs().max())
    assert float((got.state.clean - ref.state.clean).abs().max()) \
        < 1e-5 * scale
    chi2 = float(ref.state.chi2)
    assert abs(float(got.state.chi2) - chi2) <= 1e-5 * chi2
    np.testing.assert_allclose(got.chi2_trace.numpy(),
                               ref.chi2_trace.numpy(), rtol=1e-5)
    st = got.state
    assert st.clean.shape == ref.state.clean.shape
    assert st.resid.shape == ref.state.resid.shape
    h = p.f // 2
    want_resid = p.data_pad.clone()
    want_resid[:, h: h + p.Y, h: h + p.X] -= td.apply_K(
        p, st.clean[:, : p.Y, : p.X])
    want_resid = torch.where(p.w_pad > 0, want_resid, 0.0)
    np.testing.assert_allclose(st.resid.numpy(), want_resid.numpy(),
                               rtol=0, atol=1e-12)
    assert float(st.chi2) == pytest.approx(float(tsm.full_chi2(p, st)),
                                           rel=1e-6)
    assert float(st.n_accept) == float(ref.state.n_accept)
    assert int(st.sweep) == 3 and float(st.n_kept) == 3.0
    np.testing.assert_allclose(got.flux_trace.numpy(),
                               ref.flux_trace.numpy(), rtol=1e-6)


def test_segmentation_matches_one_shot(rng):
    """2 + 1 sharded draws == 3 sharded draws (the Philox key and the
    absolute sweep thread through the whole state)."""
    p = _problem(rng)
    mesh = _mesh(2)
    a = ds.run_direct_sweeps_sharded(p, tsm.init_state(p), 2, mesh)
    a = ds.run_direct_sweeps_sharded(p, a.state, 1, mesh)
    b = ds.run_direct_sweeps_sharded(p, tsm.init_state(p), 3, mesh)
    np.testing.assert_allclose(a.state.clean.numpy(), b.state.clean.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert int(a.state.sweep) == int(b.state.sweep) == 3


def test_chain_batch_shards_each_chain(rng):
    """A chain-stacked state (``Run``'s layout): each chain draws alone."""
    from deconv3d_tpu_torch import chains as ch

    p = _problem(rng, Y=16, L=8)
    states = ch.init_chain_states(p, 2)
    got = ds.run_direct_sweeps_sharded(p, states, 1, _mesh(2))
    for c in range(2):
        one = ds.run_direct_sweeps_sharded(p, ch.select_chains(states, c), 1,
                                           _mesh(2))
        assert torch.equal(got.state.clean[c], one.state.clean)


def test_posterior_mean_sharded_matches_jax(rng):
    """``posterior_mean_sharded`` on 3 uneven blocks against the JAX
    package's ``posterior_mean`` at tol 1e-10: within 1e-6 of scale."""
    from deconv3d_tpu.ops import direct as jdr

    jp, tp = _pair(rng, Y=25)
    want = jdr.posterior_mean(jp, tol=1e-10, maxiter=600)
    got = ds.posterior_mean_sharded(tp, _mesh(3), tol=1e-10, maxiter=600)
    assert float(want.rel_residual) <= 1e-10
    assert got.rel_residual <= 1e-10
    x = np.asarray(want.x)
    assert tuple(got.x.shape) == x.shape
    assert float(np.abs(got.x.numpy() - x).max()) < 1e-6 * np.abs(x).max()


def test_float32_map_refines_on_the_slots():
    """A float32 MAP under heavy blur (8×8×12, f = 7, 'auto' τ; the case of
    ``test_torch_direct.py``'s refinement test) on 3 uneven blocks: the
    float32 recurrence stops at tol = 1e-6 short of the float64 residual,
    so the refinement runs on the slots' float64 copies; the returned
    residual is the float64 one (rel 1e-6), ≤ tol, and x agrees with the
    unsharded MAP to 2e-5 of its scale."""
    rng = np.random.default_rng(0)
    truth = np.zeros((12, 8, 8))
    truth[6, 4, 4] = 4.0
    lam = 4750.0 + 1.25 * np.arange(12)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.9),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    conv = d3.convolve_cube(
        torch.tensor(truth),
        torch.tensor(inst.fsf.bank(lam, size=7, pixel_scale=0.2)),
        torch.tensor(inst.lsf.bank(lam, cdelt=1.25, width=5))).numpy()
    data = (conv + 0.5 * rng.standard_normal(conv.shape)).astype(np.float32)
    p = tsm.make_problem(
        d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                          crval=4750.0, cdelt=1.25, device="cpu"),
        inst, tsm.RunConfig(fsf_size=7, lsf_width=5, sampler="direct",
                            prior_precision="auto", direct_tol=1e-6,
                            direct_maxiter=2000), device="cpu")
    mesh = _mesh(3)
    sh = ds.shards(p, mesh)
    plain = td.pcg(ds.make_normal_operator(p, mesh),
                   ds.make_preconditioner(p, mesh), sh.mean_rhs(p), 1e-6,
                   2000, ds.SHARDED)
    p64 = td._float64(p)
    b64 = td.apply_KT(p64, td._d_in(p64) * td._w_in(p64)) * td._free_mask(
        p64)
    A64 = td.make_normal_operator(p64)

    def rel64(x):
        return float((b64 - A64(x.double())).norm() / b64.norm())

    assert plain.rel_residual <= 1e-6 < rel64(sh.gather(plain.x, CPU))
    got = ds.posterior_mean_sharded(p, mesh)
    assert got.x.dtype == torch.float32
    assert got.iterations > plain.iterations
    assert got.rel_residual <= 1e-6
    assert got.rel_residual == pytest.approx(rel64(got.x), rel=1e-6)
    want = td.posterior_mean(p).x
    assert float((got.x - want).abs().max()) < 2e-5 * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# (vi) refusals
# ---------------------------------------------------------------------------

def test_refusals(rng):
    p = _problem(rng, Y=16, L=8)
    mh = dataclasses.replace(p, config=dataclasses.replace(p.config,
                                                           sampler="mh"))
    with pytest.raises(ValueError, match="direct"):
        ds.run_direct_sweeps_sharded(mh, tsm.init_state(p), 1, _mesh(2))
    grid = Mesh([[CPU, CPU]], ("chains", "sp"))
    with pytest.raises(ValueError, match="axis_name"):
        ds.run_direct_sweeps_sharded(p, tsm.init_state(p), 1, grid)
    with pytest.raises(ValueError, match="axis_name"):
        ds.posterior_mean_sharded(p, grid)
    with pytest.raises(ValueError, match="row blocks"):
        ds.posterior_mean_sharded(p, _mesh(17))
    cube = d3.Cube.from_data(_cube_data(rng, 8, 16, 10, 9),
                             crval=4750.0, cdelt=1.25, device="cpu")
    with pytest.raises(ValueError, match="chains × spatial"):
        d3.Run(cube, _inst(), sampler="direct", n_chains=2, fsf_size=9,
               lsf_width=5, spatial_mesh=_mesh(2), device="cpu")


# ---------------------------------------------------------------------------
# (vii) the Run routes
# ---------------------------------------------------------------------------

def _run_cube(rng, L=8, Y=24, X=10):
    data = _cube_data(rng, L, Y, X, 9)
    return d3.Cube.from_data(data, variance=np.full_like(data, 0.04),
                             crval=4750.0, cdelt=1.25, dtype=np.float64,
                             device="cpu")


def test_run_routes_spatial_direct(rng, tmp_path, caplog):
    """``Run(sampler='direct', spatial_mesh=…)`` → run → diagnostics →
    save on the sharded PCG: converged draws equal to the unsharded
    ``Run``'s at solver tolerance, no engine warning (the engine is left
    alone, as in the JAX package)."""
    cube = _run_cube(rng)
    kw = dict(max_iterations=2, sampler="direct", fsf_size=9, lsf_width=5,
              dtype=np.float64, direct_tol=1e-9, direct_maxiter=400,
              seed=3, device="cpu")
    with caplog.at_level(logging.WARNING, logger="deconv3d_tpu_torch"):
        run = d3.Run(cube, _inst(), spatial_mesh=_mesh(3), engine="torch",
                     **kw)
    assert "engine" not in caplog.text
    run.run()
    assert np.all(run.trace("accept") == 1.0)
    diag = run.diagnostics()
    assert diag["sweeps"] == 2
    run.save(str(tmp_path / "sh"))
    with open(tmp_path / "sh_stats.json") as fh:
        assert json.load(fh)["sweeps"] == 2
    assert (tmp_path / "sh_clean.fits").exists()
    ref = d3.Run(cube, _inst(), **kw).run()
    scale = float(ref.states.clean.abs().max())
    assert float((run.states.clean - ref.states.clean).abs().max()) \
        < 1e-5 * scale
    d2 = d3.Run(cube, _inst(), spatial_mesh=2, **kw).run()
    assert d2.spatial_mesh.shape == {"sp": 2}
    assert np.all(d2.trace("accept") == 1.0)


@pytest.mark.parametrize("grid", [False, True])
def test_map_estimate_routes_spatial_and_guards_positivity(rng, grid):
    """``Run(spatial_mesh=…).map_estimate()`` on a 1-D mesh and on a 2-D
    (chains, spatial) mesh (the solve shards over the last axis) equals
    the unsharded MAP; with positivity it still refuses."""
    cube = _run_cube(rng)
    kw = dict(max_iterations=2, fsf_size=9, lsf_width=5, dtype=np.float64,
              direct_tol=1e-8, direct_maxiter=400, device="cpu")
    mesh = Mesh([[CPU] * 3], ("chains", "sp")) if grid else _mesh(3)
    run = d3.Run(cube, _inst(), spatial_mesh=mesh, **kw)
    m = run.map_estimate(prior_precision="auto")
    assert run.last_map_result.rel_residual <= 1e-8
    assert run.last_map_prior_precision > 0
    ref = d3.Run(cube, _inst(), **kw).map_estimate(prior_precision="auto")
    np.testing.assert_allclose(m.data.numpy(), ref.data.numpy(), rtol=0,
                               atol=1e-6)
    pos = d3.Run(cube, _inst(), positivity=True, spatial_mesh=mesh, **kw)
    with pytest.raises(ValueError, match="positivity"):
        pos.map_estimate()


# ---------------------------------------------------------------------------
# (viii) the ragged all-to-all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[3, 3], [4, 3, 3], [2, 1, 1, 0, 0]])
def test_ragged_all_to_all_is_a_reshard(rng, sizes):
    """Rows → columns → rows of a whole tensor cut unevenly: each slot's
    result is its column block of the whole, and back is the row blocks;
    even sizes agree with the tiled ``all_to_all``."""
    D = len(sizes)
    Y = 2 * D + 1
    x = torch.tensor(rng.standard_normal((3, Y, sum(sizes))))
    row_sizes = [len(t) for t in torch.tensor_split(torch.arange(Y), D)]
    rows = list(torch.split(x, row_sizes, dim=1))
    cols = pm.all_to_all_ragged(rows, 2, 1, sizes)
    assert all(torch.equal(c, w) for c, w in zip(
        cols, torch.split(x, sizes, dim=2)))
    back = pm.all_to_all_ragged(cols, 1, 2, row_sizes)
    assert all(torch.equal(b, r) for b, r in zip(back, rows))
    if len(set(sizes)) == 1 and len(set(row_sizes)) == 1:
        assert all(torch.equal(a, b) for a, b in zip(
            cols, pm.all_to_all(rows, 2, 1)))
    with pytest.raises(ValueError, match="chunk sizes"):
        pm.all_to_all_ragged(rows, 2, 1, sizes[:-1] + [sizes[-1] + 1])


def test_ragged_all_to_all_even_matches_tiled(rng):
    x = torch.tensor(rng.standard_normal((2, 6, 4)))
    rows = list(torch.chunk(x, 2, dim=1))
    for a, b in zip(pm.all_to_all_ragged(rows, 2, 1, [2, 2]),
                    pm.all_to_all(rows, 2, 1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_sharded_draws_on_card_match_unsharded():
    """Two shards on one card (``Mesh([cuda:0] * 2)``): float32 draws
    against the unsharded ones on the same Philox normals, every solve
    converged, clean within 1e-4 of scale, χ² within 1e-5; the solve
    kernel launched once per slot and preconditioner application."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the banded solve kernel has no "
                    "CPU mode")
    rng = np.random.default_rng(8)
    data = _cube_data(rng, 40, 30, 30, 9)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.04),
                             crval=4750.0, cdelt=1.25, device="cuda")
    p = tsm.make_problem(cube, _inst(), tsm.RunConfig(**_config(
        9, dtype=np.float32, direct_tol=1e-6, prior_precision=0.3)),
        device="cuda")
    ref = td.direct_run_sweeps(p, tsm.init_state(p), 2)
    mesh = Mesh([torch.device("cuda:0")] * 2)
    iters = []
    real = td.pcg

    def counting(A, M, b, tol, maxiter, ops=td.LOCAL):
        res = real(A, M, b, tol, maxiter, ops)
        iters.append(res.iterations)
        return res

    td.pcg = counting
    try:
        bd.banded_solve.launches = 0
        got = ds.run_direct_sweeps_sharded(p, tsm.init_state(p), 2, mesh)
        launches = bd.banded_solve.launches
    finally:
        td.pcg = real
    assert launches == 2 * sum(i + 1 for i in iters)
    assert got.accept_trace.tolist() == ref.accept_trace.tolist() == [1.0] * 2
    scale = float(ref.state.clean.abs().max())
    assert float((got.state.clean - ref.state.clean).abs().max()) \
        < 1e-4 * scale
    chi2 = float(ref.state.chi2)
    assert abs(float(got.state.chi2) - chi2) <= 1e-5 * chi2
