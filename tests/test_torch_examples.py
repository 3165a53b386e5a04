"""The port's example scripts (``examples/torch_*.py``) on the CPU.

Each script is the twin of a JAX package example (``examples/
basic_deconvolution.py``, ``multichain_diagnostics.py``,
``sharded_fullfield.py``).  The tests hold them against the JAX package
where the two compute the same thing: the scenes (rebuilt here through
``deconv3d_tpu``), the saved products of ``Run.save``, the multi-chain
diagnostics, R̂ map and pooled mean (the JAX package's functions on the
port's chains).  Each example runs once per module at a cut depth
(``CUT``: ``main("cpu", max_iterations=...)``, the one knob the tests
turn); the full depth and the MAP against the JAX package's are
``slow``.  The
chains themselves differ from the JAX package's (Philox streams,
bf16-valued weights), so no chain is compared draw for draw.

JAX is imported inside the tests, so the file loads where JAX is not
installed.
"""

import glob
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.parallel import Mesh

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
NAMES = ("torch_basic_deconvolution", "torch_multichain_diagnostics",
         "torch_sharded_fullfield")
#: sweeps of the tier-1 runs: the multichain R̂ map needs 2 kept sweeps a
#: chain (burn-in is half the run); the sharded example's direct draws
#: take ~4.5 s each on one CPU thread, so it runs 2
CUT = {"torch_basic_deconvolution": 4, "torch_multichain_diagnostics": 4,
       "torch_sharded_fullfield": 2}


def _load(name):
    path = os.path.join(_EXAMPLES, f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The examples' cubes are a few thousand voxels: torch's intra-op
    threads cost more than they give, and under a parallel test run they
    contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _in(directory, fn):
    """``fn()`` with ``directory`` as the working directory (the basic
    example writes its products there)."""
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _cut(name, tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out_dir = tmp_path_factory.mktemp(name)
        out = _in(out_dir,
                  lambda: _load(name).main("cpu", max_iterations=CUT[name]))
    finally:
        torch.set_num_threads(n)
    return out, out_dir


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    return _cut("torch_basic_deconvolution", tmp_path_factory)


@pytest.fixture(scope="module")
def multichain(tmp_path_factory):
    """The multichain example at the cut depth, with the batch size of
    every ``sampler.run_sweeps`` call ``run_chains`` made."""
    batches = []
    inner = sm.run_sweeps

    def counted(problem, state, *args, **kw):
        batches.append(int(state.clean.shape[0]))
        return inner(problem, state, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sm, "run_sweeps", counted)
        out, _ = _cut("torch_multichain_diagnostics", tmp_path_factory)
    return out, batches


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _cut("torch_sharded_fullfield", tmp_path_factory)[0]


# -- the scenes ---------------------------------------------------------------

def _jax_scene(name):
    """The JAX example's noisy data, variance and kernel banks (fsf, lsf at
    the sizes the example's runs use), built as the JAX script builds
    them."""
    import deconv3d_tpu as jd
    from deconv3d_tpu import instruments as jins

    if name == "torch_sharded_fullfield":
        f, L = 5, 32
        Y, X = 4 * f, 2 * f
        truth = np.zeros((L, Y, X), np.float32)
        truth[L // 2, Y // 2, X // 2] = 20.0
        inst = jins.Instrument(
            fsf=jins.GaussianFSF(fwhm=0.5), lsf=jins.GaussianLSF(fwhm=2.0),
            pixel_scale=0.2)
        rng = np.random.default_rng(2)
        cube = jd.Cube.from_data(
            (truth + rng.normal(0, 0.1, truth.shape)).astype(np.float32),
            variance=np.full(truth.shape, 0.01, np.float32),
            crval=4750.0, cdelt=1.25)
        sizes = dict(fsf_size=f, lsf_width=5)
    else:
        basic = name == "torch_basic_deconvolution"
        truth = np.zeros((32, 16, 16), np.float32)
        truth[16, 8, 8] = 100.0 if basic else 50.0
        inst = jd.MUSE()
        observed = inst.convolve(
            jd.Cube.from_data(truth, crval=4750.0, cdelt=1.25))
        rng = np.random.default_rng(0 if basic else 1)
        data = np.asarray(observed.data) + rng.normal(0, 0.05, truth.shape)
        cube = jd.Cube.from_data(
            data.astype(np.float32),
            variance=np.full(truth.shape, 0.05**2, np.float32),
            crval=4750.0, cdelt=1.25)
        sizes = {}
    fsf, lsf = inst.kernel_banks(cube, **sizes)
    return (np.asarray(cube.data), np.asarray(cube.variance),
            np.asarray(fsf), np.asarray(lsf), sizes)


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_the_jax_example(name):
    """Each example's ``scene()`` is its JAX twin's observation: the noisy
    cube within 1e-5 of its max (float32 convolution rounding, the only
    expected difference; the sharded scene has no convolution and is
    equal), the variance equal, the instrument's kernel banks at the
    example's sizes within 1e-12 (both rasterise in float64)."""
    cube, inst = _load(name).scene()
    data, var, fsf, lsf, sizes = _jax_scene(name)
    got = cube.data.numpy()
    assert got.dtype == np.float32 and got.shape == data.shape
    np.testing.assert_allclose(got, data, rtol=0,
                               atol=1e-5 * np.abs(data).max())
    np.testing.assert_array_equal(cube.variance.numpy(), var)
    gfsf, glsf = inst.kernel_banks(
        cube, sizes.get("fsf_size"), sizes.get("lsf_width"))
    np.testing.assert_allclose(gfsf, fsf, rtol=0, atol=1e-12)
    np.testing.assert_allclose(glsf, lsf, rtol=0, atol=1e-12)


# -- the basic example ----------------------------------------------------------

def test_basic_figures(basic):
    """Every printed figure finite, gibbs acceptance exactly 1, the MAP
    converged to its tol and both reconvolved peaks on the source."""
    out, _ = basic
    assert np.isfinite(out["chi2_dof"]) and out["chi2_dof"] > 0
    assert out["acceptance"] == 1.0
    diag = out["diagnostics"]
    assert diag["sweeps"] == CUT["torch_basic_deconvolution"]
    assert diag["n_chains"] == 1
    assert all(np.isfinite(v) for v in diag.values()
               if isinstance(v, float))
    assert out["map_rel_residual"] <= 2e-4
    assert out["peak"] == (16, 8, 8)
    assert out["map_peak"] == (16, 8, 8)


def _products(directory, name):
    """{suffix: shape} of a ``Run.save(name)``'s files: the FITS cubes'
    shapes, the traces' arrays, the stats' keys."""
    found = {}
    for path in sorted(glob.glob(os.path.join(directory, f"{name}_*"))):
        suffix = os.path.basename(path)[len(name):]
        if suffix.endswith(".fits"):
            found[suffix] = tuple(d3.Cube.from_fits(path).shape)
        elif suffix.endswith(".npz"):
            with np.load(path) as z:
                found[suffix] = {k: z[k].shape for k in z.files}
        else:
            with open(path) as fh:
                found[suffix] = sorted(json.load(fh))
    return found


def test_basic_save_writes_the_jax_products(basic, tmp_path):
    """``save("deconv_out")`` writes the files the JAX package's
    ``Run.save`` writes, with the same names and shapes: a JAX ``Run`` of
    the same cube, sampler and depth, saved beside it.  The port's stats
    JSON carries the JAX keys and one more, ``engine``."""
    import deconv3d_tpu as jd

    out, out_dir = basic
    cube, _ = _load("torch_basic_deconvolution").scene()
    jcube = jd.Cube.from_data(cube.data.numpy(),
                              variance=cube.variance.numpy(),
                              crval=4750.0, cdelt=1.25)
    jrun = jd.Run(jcube, jd.MUSE(),
                  max_iterations=CUT["torch_basic_deconvolution"],
                  sampler="gibbs")
    jrun.run()
    _in(tmp_path, lambda: jrun.save("deconv_out"))
    got = _products(out_dir, "deconv_out")
    want = _products(tmp_path, "deconv_out")
    assert set(got) == set(want)
    stats = "_stats.json"
    assert set(want[stats]) <= set(got[stats])
    assert set(got[stats]) - set(want[stats]) == {"engine"}
    assert {k: v for k, v in got.items() if k != stats} == {
        k: v for k, v in want.items() if k != stats}


# -- the multichain example ------------------------------------------------------

def test_multichain_is_one_batched_segment(multichain):
    """``run_chains`` runs the 8 chains as one batch: one
    ``sampler.run_sweeps`` call holding all of them."""
    out, batches = multichain
    assert batches == [8]
    assert out["chains"].n_chains == 8


def _as_jax_result(mc):
    """The JAX package's ``MultiChainResult`` over the port's chains'
    traces and accumulators (numpy)."""
    from deconv3d_tpu import chains as jch

    r = mc.result
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    return jch.MultiChainResult(result=types.SimpleNamespace(
        chi2_trace=np_(r.chi2_trace), flux_trace=np_(r.flux_trace),
        monitor_trace=np_(r.monitor_trace),
        state=types.SimpleNamespace(
            sum_clean=np_(r.state.sum_clean), sum_sq=np_(r.state.sum_sq),
            n_kept=np_(r.state.n_kept))))


def test_multichain_diagnostics_match_the_jax_package(multichain):
    """``diagnostics(discard_frac=0.5)`` has the keys and values of the JAX
    package's ``MultiChainResult.diagnostics`` on the same traces (rel
    1e-12; NaN where both are: 2 kept sweeps give no split R̂)."""
    out, _ = multichain
    want = _as_jax_result(out["chains"]).diagnostics(discard_frac=0.5)
    got = out["diagnostics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                   equal_nan=True)


def test_multichain_rhat_and_pooled_mean_match_the_jax_package(multichain):
    """``rhat_cube`` and ``posterior_mean`` have the JAX package's shapes
    and values on the same accumulators (R̂ rel 1e-12; the mean float32
    rounding, rel 1e-6), and the printed median / p99 are the map's."""
    out, _ = multichain
    problem, mc = out["problem"], out["chains"]
    jmc = _as_jax_result(mc)
    dims = types.SimpleNamespace(Y=problem.Y, X=problem.X)
    want = jmc.rhat_cube(dims)
    assert out["rhat"].shape == want.shape == (32, 16, 16)
    np.testing.assert_allclose(out["rhat"], want, rtol=1e-12)
    assert out["rhat_median"] == pytest.approx(float(np.nanmedian(want)))
    assert out["rhat_p99"] == pytest.approx(
        float(np.nanpercentile(want, 99)))
    pooled = mc.posterior_mean(problem).cpu().numpy()
    jpooled = np.asarray(jmc.posterior_mean(dims))
    assert out["posterior_mean_shape"] == pooled.shape == jpooled.shape
    np.testing.assert_allclose(pooled, jpooled, rtol=1e-6,
                               atol=1e-6 * np.abs(jpooled).max())


# -- the sharded example ---------------------------------------------------------

TOPOLOGIES = ("chains", "spatial", "chains_x_spatial", "sharded_direct")


def test_sharded_runs_every_topology(sharded):
    """All four topologies ran on meshes of CPU slots: the printed figures
    finite, the chain mesh one chain per slot, topology 3 two chains on
    the tiled engine's CPU name, topology 4 every draw converged."""
    runs = sharded["runs"]
    assert set(runs) == set(TOPOLOGIES)
    assert sharded["chains"]["n_chains"] == 2
    assert isinstance(runs["chains"].mesh, Mesh)
    for key in ("spatial", "chains_x_spatial", "sharded_direct"):
        assert np.isfinite(sharded[key]) and sharded[key] > 0
    assert sharded["chains_x_spatial_chains"] == 2
    assert runs["chains_x_spatial"].config.engine == "torch_tiled"
    assert runs["chains_x_spatial"].spatial_mesh.shape == {"chains": 2,
                                                           "sp": 2}
    direct = runs["sharded_direct"]
    cut = CUT["torch_sharded_fullfield"]
    assert direct.trace("accept").shape == (1, cut)
    assert np.all(direct.trace("accept") == 1.0)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_sharded_running_chi2_matches_from_scratch(sharded, topology):
    """Each topology's running χ² (every chain) within 1e-5 of the χ²
    recomputed from its clean cube (the smoke's bound on the card)."""
    run = sharded["runs"][topology]
    for c in range(run.n_chains):
        state = ch.select_chains(run.states, c)
        full = float(sm.full_chi2(run.problem, state))
        assert abs(float(state.chi2) - full) <= 1e-5 * full


# -- a JAX checkpoint -------------------------------------------------------------

def test_jax_checkpoint_carries_across_through_interop(tmp_path):
    """A JAX ``Run``'s NPZ checkpoint (pytree leaves, not named fields)
    loads with the port's ``resume``, and so does it by hand: the leaves
    in ``SamplerState``'s field order through ``interop.state_from_numpy``,
    equal to the JAX state and to ``resume``'s (but χ², which ``resume``
    rebaselines on the port's bf16-valued weights: the carried one is the
    JAX run's on exact weights, off by ~2e-6); the port's run continues
    from its absolute sweep with a running χ² within 1e-5 of the
    from-scratch one."""
    import dataclasses

    import deconv3d_tpu as jd
    from deconv3d_tpu import instruments as jins

    from deconv3d_tpu_torch import interop

    cube, inst = _load("torch_sharded_fullfield").scene()
    kw = dict(max_iterations=3, fsf_size=5, lsf_width=5)
    path = str(tmp_path / "jax_run")
    jrun = jd.Run(
        jd.Cube.from_data(cube.data.numpy(), variance=cube.variance.numpy(),
                          crval=4750.0, cdelt=1.25),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                        lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
        checkpoint_path=path, **kw)
    jrun.run()
    run = d3.Run(cube, inst, device="cpu", **kw)
    resumed = run.resume(path + ".npz").states
    names = [f.name for f in dataclasses.fields(d3.SamplerState)]
    with np.load(path + ".npz") as z:
        leaves = {n: z[f"leaf_{i}"][0] for i, n in enumerate(names)}
    run.states = ch.stack_chains([interop.state_from_numpy(leaves)])
    np.testing.assert_array_equal(run.states.clean[0].numpy(),
                                  np.asarray(jrun.states.clean[0]))
    for name in names:
        if name not in ("chi2", "chi2_comp"):
            assert torch.equal(getattr(resumed, name),
                               getattr(run.states, name)), name
    assert torch.equal(resumed.chi2,
                       sm.rebaseline_chi2(run.problem, run.states).chi2)
    assert run.sweeps_done == 3
    run.run(2)
    assert run.sweeps_done == 5
    state = ch.select_chains(run.states, 0)
    full = float(sm.full_chi2(run.problem, state))
    assert abs(float(state.chi2) - full) <= 1e-5 * full


# -- imports and devices ---------------------------------------------------------

@pytest.fixture(scope="module")
def imported():
    """Each example run as a module in one fresh interpreter (its top
    level, then its ``scene()``): the modules of ``jax`` and
    ``deconv3d_tpu`` in ``sys.modules`` after each, by example."""
    code = (
        "import json, runpy, sys\n"
        "bad = {}\n"
        f"for name in {NAMES!r}:\n"
        f"    ns = runpy.run_path({_EXAMPLES!r} + '/' + name + '.py')\n"
        "    ns['scene']()\n"
        "    bad[name] = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'deconv3d_tpu')]\n"
        "print(json.dumps(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(imported, name):
    """Run as a module, the example leaves ``jax`` and ``deconv3d_tpu``
    out of ``sys.modules``."""
    assert imported[name] == []


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_card_raises(name):
    """``main()`` runs on the card by default: with none it raises, naming
    ``--device cpu``, before any work — no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main() would run on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _load(name).main()


# -- full depth and the MAP against the JAX package (slow) ----------------------

@pytest.mark.slow
def test_basic_at_full_depth_within_the_jax_examples_band(tmp_path):
    """The basic example at its own depth (400 gibbs sweeps; ~9 min on one
    CPU thread): χ²/dof within ``CHI2_DOF_BAND`` of the JAX example's CPU
    figure (``JAX_CPU_FIGURES``: what ``examples/basic_deconvolution.py``
    printed on the CPU) and both reconvolved peaks at the JAX example's."""
    mod = _load("torch_basic_deconvolution")
    out = _in(tmp_path, lambda: mod.main("cpu"))
    want = mod.JAX_CPU_FIGURES
    assert abs(out["chi2_dof"] - want["chi2_dof"]) <= mod.CHI2_DOF_BAND
    assert out["acceptance"] == 1.0
    assert out["peak"] == want["peak"]
    assert out["map_peak"] == want["map_peak"]


@pytest.mark.slow
@pytest.mark.parametrize("tol, maxiter, conv_tol", [
    (2e-4, 2500, 3e-3),     # the example's call: measured 1.38e-3
    (1e-6, 5000, 4e-3),     # measured 1.86e-3; neither package converges
])
def test_basic_map_matches_the_jax_package(tol, maxiter, conv_tol):
    """``Run.map_estimate`` of the basic example's Run against the JAX
    package's on the same cube: the convolved MAPs within ``conv_tol`` of
    their max (measured on the CPU: 1.38e-3 at the example's tol 2e-4,
    1.86e-3 at 1e-6), both reconvolved peaks on the source.  The raw MAPs
    are not compared: the flat-prior operator is near-singular under the
    f = 17 blur and their blur-null modes differ by 16% of their max; the
    port's MCMC problem holds bf16-valued weights, the JAX package's jnp
    engine on the CPU exact ones.  Measured float64 residuals ‖b − A x‖ /
    ‖b‖, each package's solution on its own float64 operator: at 2e-4 the
    port's refined solution 1.99e-4 (1779 iterations), the JAX package's
    float32 recurrence stops at 1651 iterations with 7.99e-4; at 1e-6
    neither converges in 5000 (port 2.1e-3, JAX 1.39e-3)."""
    import deconv3d_tpu as jd

    cube, muse = _load("torch_basic_deconvolution").scene()
    run = d3.Run(cube, muse, sampler="gibbs", device="cpu")
    got = muse.convolve(run.map_estimate(tol=tol, maxiter=maxiter))
    got = got.data.numpy()
    jcube = jd.Cube.from_data(cube.data.numpy(),
                              variance=cube.variance.numpy(),
                              crval=4750.0, cdelt=1.25)
    jrun = jd.Run(jcube, jd.MUSE(), sampler="gibbs")
    want = np.asarray(jd.MUSE().convolve(
        jrun.map_estimate(tol=tol, maxiter=maxiter)).data)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=conv_tol * np.abs(want).max())
    for conv in (got, want):
        assert np.unravel_index(np.argmax(conv), conv.shape) == (16, 8, 8)
