"""The port's MH sweep segment against a JAX composition, same uniforms.

The TPU kernel (``deconv3d_tpu/ops/pallas_sweep.py``) cannot run here —
Pallas interpret mode has no PRNG on the CPU — so the reference is composed
from the JAX package's own per-color functions (``_color_slice``,
``_chunked_lin``, ``_lsf_apply_lastaxis``, ``_chunked_commit``,
``_color_update``) plus the kernel's proposal / accept / Robbins-Monro
formulas and ``_assemble``'s per-sweep Kahan χ² and keep rule.  Both sides
start from the identical problem and state (carried over as NumPy arrays
through ``deconv3d_tpu_torch.interop``) and consume the same injected
uniforms.  Tolerances: residual and clean cube atol 1e-5·max|·|, χ² rtol
1e-5 (float32 sums in another order); accept decisions equal — injected
accept uniforms within 1e-3 of their threshold are first moved off it
(``ops.sweep.untie_uniforms``), so no decision is a float32 coin flip.

Then the ring kernels' segment layout on the CPU: the weights in bfloat16,
exact for the bfloat16-valued weights ``make_problem`` makes, in rows
padded to 16 bytes, and the checks that hold each launch to it.
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
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import sweep as sw

N_SWEEPS = 3


@pytest.fixture(autouse=True)
def _f32_mode():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _jax_problem(rng):
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
    cfg = jsm.RunConfig(max_iterations=N_SWEEPS, burn_in=1, seed=1,
                        fsf_size=5, lsf_width=5, engine="pallas")
    return jsm.make_problem(cube, inst, cfg)


def _to_port(jp, js):
    d = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tcfg = tsm.RunConfig(**{
        f.name: getattr(jp.config, f.name)
        for f in dataclasses.fields(tsm.RunConfig)
        if f.name not in ("engine", "tile", "lambda_chunk",
                          "chi2_rebaseline_every", "prior_precision",
                          "direct_precond_tau")
    })
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in d.items() if k != "config"}, tcfg
    )
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}
    )
    return tp, ts


def _jax_segment(p, state, n_sweeps, u):
    """The K1 MH kernel's math from the JAX package's own functions."""
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    cfg = p.config
    bounds = jsm._slab_bounds(L, cfg)
    target = cfg.target_acceptance
    resid, clean, ls = state.resid, state.clean, state.log_scale
    chi2, chi2c = state.chi2, state.chi2_comp
    sum_clean, sum_sq, n_kept = state.sum_clean, state.sum_sq, state.n_kept
    sweep0 = int(state.sweep)
    adapt = jsm.adapt_schedule(
        sweep0 + jnp.arange(n_sweeps, dtype=jnp.int32), cfg)
    burn = cfg.resolved_burn_in()
    accepts, dchis, chi2_trace = [], [], []
    for s in range(n_sweeps):
        dchi_sweep = []
        for c in range(f * f):
            cy, cx = c // f, c % f
            valid_c = jsm._color_slice(p.valid, cy, cx, ny, nx, f)
            vm = valid_c.astype(jnp.float32)
            ls_c = jsm._color_slice(ls, cy, cx, ny, nx, f)
            uc = jnp.asarray(u[s, c].reshape(ny, nx, L + 1))
            # K1 proposal (pallas_sweep.py:222-227)
            draw = jnp.clip(jnp.tan(jnp.float32(np.pi) * (uc[..., :L] - 0.5)),
                            -1e3, 1e3)
            jumps = jnp.exp(ls_c)[..., None] * draw * vm[..., None]
            g = jsm._lsf_apply_lastaxis(jumps, p.lsf)
            quad_c = jnp.moveaxis(jsm._color_slice(p.quad, cy, cx, ny, nx, f), 0, -1)
            lin = jnp.moveaxis(jsm._chunked_lin(p, resid, cy, cx, bounds), 0, -1)
            dchi = jnp.sum(g * g * quad_c - 2.0 * g * lin, axis=-1)
            # K1 accept (pallas_sweep.py:231-235)
            accf = jnp.where((jnp.log(uc[..., L]) < -0.5 * dchi) & valid_c,
                             1.0, 0.0)
            resid = jsm._chunked_commit(p, resid, g * accf[..., None], cy, cx,
                                        bounds)
            clean_c = jsm._color_slice(clean, cy, cx, ny, nx, f)
            clean = jsm._color_update(
                clean, clean_c + jnp.moveaxis(jumps * accf[..., None], -1, 0),
                cy, cx, ny, nx, f)
            # Robbins-Monro (pallas_sweep.py:320-324)
            ls = jsm._color_update(
                ls, ls_c + adapt[s] * (accf - target) * vm, cy, cx, ny, nx, f)
            accepts.append(np.asarray(accf).reshape(-1))
            dchis.append(np.asarray(dchi).reshape(-1))
            dchi_sweep.append(np.asarray(dchi * accf, np.float64).sum())
        # _assemble: per-sweep Kahan update and keep rule
        d = jnp.float32(np.sum(dchi_sweep))
        y = d - chi2c
        t = chi2 + y
        chi2c = (t - chi2) - y
        chi2 = t
        idx = sweep0 + s
        if idx >= burn and (idx - burn) % cfg.keep_one_in == 0:
            sum_clean = sum_clean + clean
            sum_sq = sum_sq + clean * clean
            n_kept = n_kept + 1.0
        chi2_trace.append(float(chi2))
    shape = (n_sweeps, f * f, ny * nx)
    return dict(
        resid=np.asarray(resid), clean=np.asarray(clean),
        log_scale=np.asarray(ls), chi2=float(chi2), sum_clean=np.asarray(sum_clean),
        sum_sq=np.asarray(sum_sq), n_kept=float(n_kept),
        accept=np.stack(accepts).reshape(shape),
        dchi=np.stack(dchis).reshape(shape), chi2_trace=np.asarray(chi2_trace),
    )


@pytest.fixture
def pair(rng):
    jp = _jax_problem(rng)
    js = jsm.init_state(jp)
    tp, ts = _to_port(jp, js)
    u = rng.random((N_SWEEPS, jp.n_colors, jp.ny * jp.nx, jp.L + 1),
                   dtype=np.float32)
    u = np.clip(u, 2.0**-24, 1.0 - 2.0**-24)
    u, _ = sw.untie_uniforms(tp, ts, N_SWEEPS, torch.as_tensor(u))
    return jp, js, tp, ts, u.numpy()


def test_interop_starts_from_identical_state(pair):
    jp, js, tp, ts, _ = pair
    np.testing.assert_array_equal(tp.quad.numpy(), np.asarray(jp.quad))
    np.testing.assert_array_equal(ts.resid.numpy(), np.asarray(js.resid))
    assert int(ts.key) == 1          # PRNGKey(1) = [0, 1] → Philox key 1
    back = interop.state_to_numpy(ts)
    np.testing.assert_array_equal(back["log_scale"], np.asarray(js.log_scale))
    tp2 = interop.problem_from_numpy(interop.problem_to_numpy(tp), tp.config)
    assert torch.equal(tp2.w_pad, tp.w_pad) and tp2.f == tp.f


def test_segment_matches_jax_composition(pair):
    jp, js, tp, ts, u = pair
    want = _jax_segment(jp, js, N_SWEEPS, u)
    seg = sw.mh_segment_reference(tp, ts, N_SWEEPS, torch.as_tensor(u))
    got = seg.result.state
    assert want["accept"].sum() > 0, "nothing accepted; test is vacuous"
    np.testing.assert_array_equal(seg.accept.numpy(), want["accept"])
    np.testing.assert_allclose(seg.dchi.numpy(), want["dchi"], rtol=1e-4,
                               atol=1e-4)
    for name in ("resid", "clean", "sum_clean", "sum_sq"):
        w = want[name]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
    np.testing.assert_allclose(got.log_scale.numpy(), want["log_scale"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.chi2), want["chi2"], rtol=1e-5)
    np.testing.assert_allclose(seg.result.chi2_trace.numpy(),
                               want["chi2_trace"], rtol=1e-5)
    assert float(got.n_kept) == want["n_kept"] == 2.0
    assert int(got.sweep) == N_SWEEPS
    n_valid = float(jp.valid.sum())
    np.testing.assert_allclose(
        seg.result.accept_trace.numpy(),
        want["accept"].sum(axis=(1, 2)) / n_valid, rtol=1e-6)
    assert float(got.n_propose) == N_SWEEPS * n_valid


def test_wrapper_takes_plain_version_on_cpu(pair):
    _, _, tp, ts, u = pair
    before = sw.mh_segment.launches
    a = sw.mh_segment(tp, ts, N_SWEEPS, torch.as_tensor(u))
    b = sw.mh_segment_reference(tp, ts, N_SWEEPS, torch.as_tensor(u))
    assert sw.mh_segment.launches == before, "no kernel may launch on the CPU"
    assert torch.equal(a.result.state.resid, b.result.state.resid)
    assert torch.equal(a.accept, b.accept)


def test_philox_draws_are_recorded_and_keyed_by_absolute_sweep(pair):
    _, _, tp, ts, _ = pair
    one = sw.mh_segment_reference(tp, ts, 2, record_uniforms=True)
    later = dataclasses.replace(ts, sweep=ts.sweep + 1)
    two = sw.mh_segment_reference(tp, later, 1, record_uniforms=True)
    assert torch.equal(one.uniforms[1], two.uniforms[0])
    assert not torch.equal(one.uniforms[0], one.uniforms[1])


# ---------------------------------------------------------------------------
# The ring kernels' layout: the weights in bfloat16, rows padded to Ls
# ---------------------------------------------------------------------------

def _port_problem(L, sampler="mh", Y=6, X=7):
    """A small port problem made on the CPU from a variance whose inverse
    is no bfloat16 value (``make_problem`` rounds it), and its chain-stacked
    initial state."""
    from deconv3d_tpu_torch import Cube as TCube
    from deconv3d_tpu_torch import chains as tch
    from deconv3d_tpu_torch import instruments as tins

    rng = np.random.default_rng(L)
    data = rng.standard_normal((L, Y, X)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, (L, Y, X)).astype(np.float32)
    cube = TCube.from_data(data, variance=var, crval=4750.0, cdelt=1.25)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        sampler=sampler, fsf_size=5, lsf_width=5), device="cpu")
    return p, tch.stack_chains([tsm.init_state(p)])


#: the ring kernels' layouts on the CPU (their geometry only: nothing
#: launches)
RING = {"tiled": dict(tile=(1, 1)), "classic": dict(classic=True)}


@pytest.mark.parametrize("L", [600, 37, 3681])
def test_ring_weights_widen_to_the_float32_layout(L):
    """Classic K1 and the tiled kernel take the weights λ-last in bfloat16,
    rows padded to Ls = 8⌈L/8⌉ (16 bytes, a tensor map's stride) with zeros
    past L; widened, they are the float32 layout bit for bit.  The residual
    takes the same Ls; the plain sweeps keep float32 rows of L."""
    p, states = _port_problem(L)
    assert p.w_bf16
    Ls = sw.ring_row(L)
    assert Ls % 8 == 0 and L <= Ls < L + 8
    want = sw._lambda_last(p.w_pad)
    for name, kw in RING.items():
        k = sw.sweep_state(p, states, "mh", kernel=True, **kw)
        assert k.kernel == name
        assert k.w.dtype == torch.bfloat16 and k.w.is_contiguous()
        assert k.w.shape == (p.Hp, p.Wp, Ls)
        assert k.resid.dtype == torch.float32
        assert k.resid.shape == (1, p.Hp, p.Wp, Ls)
        assert torch.equal(k.w[..., :L].float(), want)
        assert torch.equal(k.w.float(), sw._lambda_last_padded(p.w_pad))
        assert not k.w[..., L:].any() and not k.resid[..., L:].any()
        assert torch.equal(k.resid[..., :L], sw._lambda_last(states.resid))
    plain = sw.sweep_state(p, states, "mh", kernel=False)
    assert plain.w.dtype == torch.float32 and torch.equal(plain.w, want)


def test_kernel_args_take_bfloat16_weights_on_ring_launches_only(
        monkeypatch):
    """``_kernel_args`` holds each launch to its kernel's weights: bfloat16
    rows of Ls on classic K1 and the tiled kernel, float32 rows of L on the
    resident kernel; a float32 ``w`` on a ring launch, or a bfloat16 one
    on a resident launch, is refused before the library loads."""
    from deconv3d_tpu_torch import _build

    class Loaded(Exception):
        pass

    def load_library():
        raise Loaded

    monkeypatch.setattr(_build, "load_library", load_library)
    p, states = _port_problem(37)
    nij = p.ny * p.nx
    outs = (torch.zeros((1, p.n_colors, nij)),
            torch.zeros((1, p.n_colors, nij)))
    for kw in RING.values():
        k = sw.sweep_state(p, states, "mh", kernel=True, **kw)
        with pytest.raises(Loaded):                 # every check held
            sw._kernel_args(k, "mh", None, *outs, None)
        f32 = dataclasses.replace(k, w=sw._lambda_last_padded(p.w_pad))
        with pytest.raises(TypeError, match="w has dtype torch.float32"):
            sw._kernel_args(f32, "mh", None, *outs, None)
    k = sw.sweep_state(p, states, "mh", kernel=True, classic=True)
    resident = dataclasses.replace(
        k, kernel="resident", plan=(1, 1), resid=sw._lambda_last(states.resid),
        w=sw._lambda_last(p.w_pad))
    with pytest.raises(Loaded):
        sw._kernel_args(resident, "mh", None, *outs, None)
    bf16 = dataclasses.replace(resident, w=resident.w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="w has dtype torch.bfloat16"):
        sw._kernel_args(bf16, "mh", None, *outs, None)


def test_ring_layout_refuses_weights_that_are_not_bfloat16_values(pair):
    """The wrapper never rounds: a problem whose weights ``make_problem``
    did not round to bfloat16 values (``Problem.w_bf16`` false: the direct
    sampler's exact weights, or an imported ``w_pad`` off the bfloat16
    grid) raises on a ring launch, and still runs the plain sweeps."""
    p, states = _port_problem(37)
    exact = dataclasses.replace(p, w_bf16=False)
    for kw in RING.values():
        with pytest.raises(ValueError, match="not bfloat16 values"):
            sw.sweep_state(exact, states, "mh", kernel=True, **kw)
    sw.sweep_state(exact, states, "mh", kernel=False)
    direct, _ = _port_problem(37, sampler="direct")
    assert not direct.w_bf16
    assert not torch.equal(direct.w_pad.to(torch.bfloat16).float(),
                           direct.w_pad)
    # a JAX kernel-engine problem carries bfloat16 weights across
    _, _, tp, _, _ = pair
    assert tp.w_bf16
    d = interop.problem_to_numpy(tp)
    d["w_pad"] = d["w_pad"] * np.float32(1 + 2**-12)
    assert not interop.problem_from_numpy(d, tp.config).w_bf16


@pytest.mark.parametrize("config_name", ["muse_subcube_30x30x600",
                                         "muse_subcube_chromatic_masked_30x30x600"])
def test_benchmark_weights_round_trip_bfloat16(config_name):
    """The weights the benchmark's configurations make, cut to 48 planes
    over the same wavelengths and 34 × 34 spaxels — unit noise; the
    chromatic cube's sky-line variance with its masked and NaN spaxels —
    are bfloat16 values after ``make_problem``, so the ring kernels'
    bfloat16 copy changes no bit."""
    import json
    from pathlib import Path

    from deconv3d_tpu_torch import Cube as TCube
    from deconv3d_tpu_torch import chains as tch
    from portbench import harness, scene

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "portbench" / "configs"
                         / f"{config_name}.json").read_text())
    L = 48
    config.update(shape=[L, 34, 34],
                  cdelt=config["cdelt"] * config["shape"][0] / L)
    data, variance, mask = scene.make_inputs(config, 2**31 + 7,
                                             torch.device("cpu"))
    cube = TCube.from_data(data, variance=variance, mask=mask,
                           crval=float(config["crval"]),
                           cdelt=float(config["cdelt"]))
    for sampler in ("mh", "gibbs"):
        p = tsm.make_problem(cube, harness.instrument_of(config), tsm.RunConfig(
            sampler=sampler, fsf_size=config["fsf_size"],
            lsf_width=config["lsf_width"]), device="cpu")
        assert p.w_bf16 and p.w_pad.dtype == torch.float32
        assert torch.equal(p.w_pad.to(torch.bfloat16).float(), p.w_pad)
        h = p.f // 2               # masked and NaN voxels weigh nothing
        inner = p.w_pad[:, h:h + p.Y, h:h + p.X]
        assert bool((inner == 0).any()) == ("mask" in config)
        k = sw.sweep_state(p, tch.stack_chains([tsm.init_state(p)]), sampler,
                           kernel=True, tile=(1, 1))
        assert torch.equal(k.w[..., :L].float(), sw._lambda_last(p.w_pad))
