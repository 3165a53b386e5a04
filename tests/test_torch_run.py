"""The torch port's sampler and ``Run`` facade on the CPU.

These mirror the JAX package's sampler tests (``tests/test_sampler.py``)
on the port's plain torch engine, plus what only the port has: the
absolute-sweep Philox counters (segmented == single run bit for bit), the
no-JAX import rule, and the CUDA path refusing to run without a card.
The test marked ``gpu`` holds the CUDA kernel against its plain version
and skips on a machine without a card.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import _build, checkpoint
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import sweep as sw


def _make_toy(rng, L=16, Y=6, X=6, noise=0.1, mask=None, dtype=np.float64):
    """Synthetic emission-line cube + instrument (as tests/test_sampler.py)."""
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
                             mask=mask, crval=4750.0, cdelt=1.25, dtype=dtype)
    return cube, inst


def _cfg(**kw):
    base = dict(fsf_size=5, lsf_width=5, dtype=np.float64)
    base.update(kw)
    return sm.RunConfig(**base)


@pytest.fixture
def toy(rng):
    return _make_toy(rng)


@pytest.mark.parametrize("dtype, atol_rel", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_incremental_matches_full_conv(rng, dtype, atol_rel):
    """After many accepted patch updates, data - resid must equal the full
    re-convolution of the clean cube (float64: to rounding; float32, the
    kernel's type: 1e-5 of the data scale after 40 sweeps)."""
    cube, inst = _make_toy(rng, dtype=dtype)
    p = sm.make_problem(cube, inst, _cfg(max_iterations=40, burn_in=10, seed=1,
                                         dtype=dtype))
    assert p.config.engine == "torch"
    state = sm.run_sweeps(p, sm.init_state(p), 40).state
    assert float(state.n_accept) > 0, "nothing accepted; test is vacuous"
    h = p.f // 2
    conv = cv.convolve_cube(state.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - state.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X].numpy()
    scale = float(p.data_pad.abs().max())
    np.testing.assert_allclose(model.numpy()[w > 0], conv.numpy()[w > 0],
                               rtol=0, atol=atol_rel * scale)
    np.testing.assert_allclose(float(state.chi2), float(sm.full_chi2(p, state)),
                               rtol=1e-5)


def test_chi2_decreases_from_zero_init(toy):
    cube, inst = toy
    p = sm.make_problem(cube, inst, _cfg(max_iterations=60, burn_in=30, seed=3))
    state = sm.init_state(p)
    chi0 = float(state.chi2)
    res = sm.run_sweeps(p, state, 60)
    assert float(res.state.chi2) < chi0
    assert bool(torch.isfinite(res.chi2_trace).all())
    tail_acc = float(res.accept_trace[-10:].mean())
    assert 0.05 < tail_acc < 0.9


def test_masked_spaxels_frozen(rng):
    mask = np.zeros((6, 6), dtype=bool)
    mask[2, 3] = True
    mask[0, 0] = True
    cube, inst = _make_toy(rng, mask=mask)
    p = sm.make_problem(cube, inst, _cfg(max_iterations=30, burn_in=10, seed=5))
    clean = sm.run_sweeps(p, sm.init_state(p), 30).state.clean.numpy()
    assert (clean[:, 2, 3] == 0).all(), "masked spaxel was updated"
    assert (clean[:, 0, 0] == 0).all()
    assert np.abs(clean[:, 3, 3]).max() > 0, "unmasked spaxels should move"
    h = p.f // 2
    assert (p.w_pad.numpy()[:, h + 2, h + 3] == 0).all()


def test_deterministic_same_seed(toy):
    cube, inst = toy
    p = sm.make_problem(cube, inst, _cfg(max_iterations=20, seed=7))
    r1 = sm.run_sweeps(p, sm.init_state(p), 20)
    r2 = sm.run_sweeps(p, sm.init_state(p), 20)
    assert torch.equal(r1.state.clean, r2.state.clean)
    assert torch.equal(r1.chi2_trace, r2.chi2_trace)
    r3 = sm.run_sweeps(p, sm.init_state(p, key=8), 20)
    assert not torch.equal(r1.state.clean, r3.state.clean)


def test_segmented_equals_single_run(toy):
    """2×15 sweeps == 30 sweeps bit for bit: Philox is keyed by the
    absolute sweep, so the split point cannot change a draw."""
    cube, inst = toy
    p = sm.make_problem(cube, inst, _cfg(max_iterations=30, burn_in=10, seed=11))
    full = sm.run_sweeps(p, sm.init_state(p), 30)
    part = sm.run_sweeps(p, sm.init_state(p), 15)
    part2 = sm.run_sweeps(p, part.state, 15)
    for name in ("clean", "resid", "sum_clean", "sum_sq", "log_scale", "chi2"):
        assert torch.equal(getattr(full.state, name),
                           getattr(part2.state, name)), name
    assert torch.equal(full.chi2_trace,
                       torch.cat([part.chi2_trace, part2.chi2_trace]))


def test_checkpoint_round_trip_resumes_bit_exact(toy, tmp_path):
    cube, inst = toy
    p = sm.make_problem(cube, inst, _cfg(max_iterations=20, burn_in=5, seed=2))
    full = sm.run_sweeps(p, sm.init_state(p), 12)
    part = sm.run_sweeps(p, sm.init_state(p), 7)
    checkpoint.save_state(str(tmp_path / "ck"), part.state, meta={"n": 7})
    state, meta = checkpoint.load_state(str(tmp_path / "ck"), part.state)
    assert meta == {"n": 7}
    rest = sm.run_sweeps(p, state, 5)
    assert torch.equal(full.state.clean, rest.state.clean)
    assert torch.equal(full.state.sum_sq, rest.state.sum_sq)


def test_run_round_trip(rng, tmp_path):
    cube, inst = _make_toy(rng, dtype=np.float32)
    run = d3.Run(cube, inst, max_iterations=20, burn_in=10, fsf_size=5,
                 lsf_width=5, seed=3, device="cpu",
                 metrics_path=str(tmp_path / "m.jsonl"))
    assert run.problem.config.engine == "torch"
    run.run()
    diag = run.diagnostics()
    assert diag["sweeps"] == 20 and diag["n_chains"] == 1
    assert run.trace("chi2").shape == (1, 20)
    assert run.trace("monitor").shape == (1, 20, 8)
    name = str(tmp_path / "out")
    run.save(name)
    clean = d3.Cube.from_fits(f"{name}_clean.fits")
    assert clean.shape == cube.shape and bool(torch.isfinite(clean.data).all())
    np.testing.assert_allclose(clean.data.numpy(),
                               run.deconvolved_cube().data.numpy(), rtol=1e-6)
    assert d3.Cube.from_fits(f"{name}_convolved.fits").shape == cube.shape
    assert d3.Cube.from_fits(f"{name}_std.fits").shape == cube.shape
    with np.load(f"{name}_traces.npz") as z:
        assert z["chi2"].shape == (1, 20)
    with open(f"{name}_stats.json") as fh:
        assert json.load(fh)["sweeps"] == 20
    with open(tmp_path / "m.jsonl") as fh:
        assert json.loads(fh.readline())["sweep"] == 20


def test_run_two_chains_diagnostics(rng):
    cube, inst = _make_toy(rng, dtype=np.float32)
    run = d3.Run(cube, inst, max_iterations=24, burn_in=8, fsf_size=5,
                 lsf_width=5, n_chains=2, device="cpu")
    run.run()
    diag = run.diagnostics()
    assert np.isfinite(diag["rhat_chi2"]) and diag["ess_chi2"] > 0
    chi2 = run.trace("chi2")
    assert chi2.shape == (2, 24) and not np.array_equal(chi2[0], chi2[1])
    assert run.rhat_cube().shape == cube.shape


def test_run_refuses_what_is_not_ported(rng):
    """``sampler='direct'`` on a spatial mesh and ``map_estimate`` there
    run (``parallel/direct_sharded.py``; they raised before it was
    ported): converged draws, and the sharded MAP equal to the unsharded
    one.  ``map_estimate`` works on an MCMC run (a converged MAP cube of
    the run's shape, no chain state built)."""
    from deconv3d_tpu_torch.parallel import Mesh

    cube, inst = _make_toy(rng, dtype=np.float32)
    kw = dict(fsf_size=5, lsf_width=5, device="cpu")
    direct = d3.Run(cube, inst, sampler="direct", max_iterations=2,
                    prior_precision="auto", spatial_mesh=Mesh(["cpu"] * 2),
                    **kw).run()
    assert np.all(direct.trace("accept") == 1.0)
    sharded = d3.Run(cube, inst, spatial_mesh=Mesh(["cpu"] * 2), **kw)
    got = sharded.map_estimate(prior_precision="auto", tol=1e-5,
                               maxiter=2000)
    assert sharded.last_map_result.rel_residual <= 1e-5
    run = d3.Run(cube, inst, **kw)
    m = run.map_estimate(prior_precision="auto", tol=1e-5, maxiter=2000)
    assert isinstance(m, d3.Cube) and tuple(m.shape) == tuple(cube.shape)
    assert np.isfinite(m.data.numpy()).all()
    assert run.last_map_result.rel_residual <= 1e-5
    assert run._states is None
    np.testing.assert_allclose(got.data.numpy(), m.data.numpy(), rtol=0,
                               atol=1e-4 * float(m.data.abs().max()))


def test_run_enables_coarse_passes_on_a_large_field():
    """As the JAX package does, ``Run`` switches global coarse passes on
    for MH on a large blurred field (100×100, MUSE f = 17), and
    ``coarse_every=0`` turns them off."""
    big = d3.Cube.from_data(np.zeros((2, 100, 100), np.float32),
                            variance=np.ones((2, 100, 100), np.float32),
                            crval=4750.0, cdelt=1.25)
    run = d3.Run(big, d3.MUSE(), device="cpu")
    assert run.config.coarse_every == 8 and run.config.coarse_mode == "global"
    assert run.problem.config.coarse_every == 8
    off = d3.Run(big, d3.MUSE(), coarse_every=0, device="cpu")
    assert off.config.coarse_every is None


def test_import_leaves_jax_out():
    code = (
        "import sys, deconv3d_tpu_torch, deconv3d_tpu_torch.run, "
        "deconv3d_tpu_torch.ops.sweep, deconv3d_tpu_torch.interop, "
        "deconv3d_tpu_torch.ops.tiled, deconv3d_tpu_torch.tile_sweep, "
        "deconv3d_tpu_torch._build, deconv3d_tpu_torch.chains, "
        "deconv3d_tpu_torch.ops.banded, deconv3d_tpu_torch.ops.philox, "
        "deconv3d_tpu_torch.ops.coarse, deconv3d_tpu_torch.ops.direct, "
        "deconv3d_tpu_torch.parallel, deconv3d_tpu_torch.parallel.mesh, "
        "deconv3d_tpu_torch.parallel.sharded, "
        "deconv3d_tpu_torch.parallel.sweep_sharded, "
        "deconv3d_tpu_torch.parallel.kernel_sharded, "
        "deconv3d_tpu_torch.parallel.direct_sharded, "
        "deconv3d_tpu_torch.parallel.multihost, "
        "deconv3d_tpu_torch.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deconv3d_tpu' or m.startswith('deconv3d_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_a_card_raises(rng, monkeypatch, tmp_path):
    cube, inst = _make_toy(rng, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sm.make_problem(cube, inst, _cfg(engine="cuda", dtype=np.float32))
    # a tensor on neither the CPU nor a CUDA device: no plain fallback
    p = sm.make_problem(cube, inst, _cfg(dtype=np.float32))
    meta = dataclasses.replace(p, data_pad=p.data_pad.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        sw.mh_segment(meta, sm.init_state(p), 1)
    # no nvcc: building the kernel raises instead of falling back
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_plain_engine_on_a_card_raises(rng):
    """On a CUDA device the sweep runs the kernel only: asking for the
    plain torch engine there is refused before any tensor moves."""
    cube, inst = _make_toy(rng, dtype=np.float32)
    with pytest.raises(RuntimeError, match="engine='torch' cannot run on cuda"):
        sm.make_problem(cube, inst, _cfg(engine="torch", dtype=np.float32),
                        device="cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """Classic K1's MH kernel (pinned: the toy fits the resident kernel,
    ``test_torch_resident.py``) against its plain version on the card, same
    injected uniforms, at the toy size (full size: chip_smoke.py).  Runs
    where JAX is absent too: ``pytest --noconftest -m gpu``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MH kernel has no CPU mode")
    cube, inst = _make_toy(np.random.default_rng(42), dtype=np.float32)
    p = sm.make_problem(cube.to("cuda"), inst, _cfg(dtype=np.float32, seed=4))
    assert p.config.engine == "cuda"
    s0 = sm.init_state(p)
    gen = np.random.default_rng(9)
    u = gen.random((3, p.n_colors, p.ny * p.nx, p.L + 1), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    u, plain = sw.untie_uniforms(p, s0, 3, u)
    kern = sw.mh_segment(p, s0, 3, u, _classic=True)
    assert float(plain.accept.sum()) > 0, "nothing accepted; test is vacuous"
    assert torch.equal(plain.accept, kern.accept)
    ref = plain.result.state.resid
    torch.testing.assert_close(kern.result.state.resid, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_gibbs_and_batched_kernels_match_plain_on_card():
    """Classic K1's gibbs kernel (one chain) and MH kernel on a batch of 3
    chains (pinned) against their plain versions on the card, same injected
    uniforms, at the toy size (full size: chip_smoke.py).  Gibbs draws have
    no accept decision to flip, so they are held to a tolerance: libm's
    logf/cosf/rsqrtf and the sums' order differ from torch's in the last
    ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    from deconv3d_tpu_torch import chains as ch

    cube, inst = _make_toy(np.random.default_rng(42), dtype=np.float32)
    gen = np.random.default_rng(9)
    p = sm.make_problem(cube.to("cuda"), inst,
                        _cfg(dtype=np.float32, seed=4, sampler="gibbs"))
    s0 = sm.init_state(p)
    u = gen.random((3, p.n_colors, p.ny * p.nx, 2, p.L), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    plain = sw.gibbs_segment_reference(p, s0, 3, u)
    n0 = sw.gibbs_segment.launches
    kern = sw.gibbs_segment(p, s0, 3, u, _classic=True)
    assert sw.gibbs_segment.launches - n0 == 3
    assert torch.equal(plain.accept, kern.accept)
    for name in ("resid", "clean"):
        ref = getattr(plain.result.state, name)
        torch.testing.assert_close(getattr(kern.result.state, name), ref,
                                   rtol=0, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)

    p = sm.make_problem(cube.to("cuda"), inst, _cfg(dtype=np.float32, seed=4))
    states = ch.init_chain_states(p, 3)
    u = gen.random((3, 3, p.n_colors, p.ny * p.nx, p.L + 1), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    u, plain = sw.untie_uniforms(p, states, 3, u)
    n0 = sw.mh_segment.launches
    kern = sw.mh_segment(p, states, 3, u, _classic=True)
    assert sw.mh_segment.launches - n0 == 3, "one launch per sweep for 3 chains"
    assert float(plain.accept.sum()) > 0, "nothing accepted; test is vacuous"
    assert torch.equal(plain.accept, kern.accept)
    ref = plain.result.state.resid
    torch.testing.assert_close(kern.result.state.resid, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    alone = sw.mh_segment(p, ch.select_chains(states, 2), 3, u[:, 2],
                          _classic=True)
    assert torch.equal(alone.accept, kern.accept[:, 2])
    assert torch.equal(alone.result.state.resid, kern.result.state.resid[2])


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_kernels_loop_warps_over_patch_rows_on_card(sampler):
    """An FSF of f = 21 rows, more than a block's 18 warps: each warp takes
    rows dy and dy + 18 (sweep_common.cuh).  Both classic K1 kernels
    (pinned) on a batch of 2 chains against their plain versions, same
    injected uniforms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    from deconv3d_tpu_torch import chains as ch

    cube, inst = _make_toy(np.random.default_rng(42), dtype=np.float32)
    p = sm.make_problem(cube.to("cuda"), inst, _cfg(
        dtype=np.float32, seed=4, fsf_size=21, sampler=sampler))
    assert p.f == 21
    states = ch.init_chain_states(p, 2)
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(9).random(
        (2, 2, p.n_colors, p.ny * p.nx, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, plain = sw.untie_uniforms(p, states, 2, u)
        kern = sw.mh_segment(p, states, 2, u, _classic=True)
    else:
        plain = sw.gibbs_segment_reference(p, states, 2, u)
        kern = sw.gibbs_segment(p, states, 2, u, _classic=True)
    assert float(plain.accept.sum()) > 0, "nothing drawn; test is vacuous"
    assert torch.equal(plain.accept, kern.accept)
    for name in ("resid", "clean"):
        ref = getattr(plain.result.state, name)
        torch.testing.assert_close(getattr(kern.result.state, name), ref,
                                   rtol=0, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("fsf_size, size, L", [(5, 20, 16), (21, 42, 16),
                                                (5, 20, 3200)])
def test_tiled_kernel_matches_plain_on_card(sampler, fsf_size, size, L):
    """The tiled kernel (``csrc/tiled_sweep.cu``) on a batch of 2 chains
    against its plain version, same injected uniforms, tiles of (1, 2)
    spaxel blocks: 8 tiles at f = 5, 2 at f = 21 (more patch rows than a
    block's row warps, one ring stage), and 8 at L = 3200 (100 λ-chunks per
    spaxel; gibbs phase (b) on several wavelength slabs per spaxel).
    Tolerances as the whole-cube kernels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kernel has no CPU mode")
    from deconv3d_tpu_torch import chains as ch
    from deconv3d_tpu_torch.ops import tiled as tl

    cube, inst = _make_toy(np.random.default_rng(42), L=L, Y=size, X=size,
                           dtype=np.float32)
    p = sm.make_problem(cube.to("cuda"), inst, _cfg(
        dtype=np.float32, seed=4, fsf_size=fsf_size, sampler=sampler,
        tile=(1, 2)))
    assert p.config.engine == "cuda_tiled" and p.f == fsf_size
    states = ch.init_chain_states(p, 2)
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(9).random(
        (2, 2, p.n_colors, p.ny * p.nx, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, plain = sw.untie_uniforms(p, states, 2, u,
                                     reference=tl.tiled_segment_reference)
    else:
        plain = tl.tiled_segment_reference(p, states, 2, u)
    counter = tl.tiled_mh if sampler == "mh" else tl.tiled_gibbs
    n0 = counter.launches
    kern = tl.tiled_segment(p, states, 2, u)
    assert counter.launches - n0 == 2, "one launch per sweep for 2 chains"
    assert float(plain.accept.sum()) > 0, "nothing drawn; test is vacuous"
    assert torch.equal(plain.accept, kern.accept)
    for name in ("resid", "clean"):
        ref = getattr(plain.result.state, name)
        torch.testing.assert_close(getattr(kern.result.state, name), ref,
                                   rtol=0, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)
