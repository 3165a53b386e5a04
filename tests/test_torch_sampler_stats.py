"""The JAX package's sampler statistics checks on the port's plain engine.

Counterparts of ``tests/test_sampler.py``'s statistical tests, with its
toys, seeds, depths and bounds: the MH acceptance after burn-in near its
0.234 target, exact Gibbs mixing faster than MH under blur, and (marked
``slow``, as the JAX package marks them) the chains' moments against the
analytic Gaussian posterior of a moderately correlated toy — MH 8000
sweeps, gibbs 3000.  The port draws from its own Philox streams, so these
hold the streams, their keying, the uniform mapping, the adaptation
schedule and ``quad`` together, which parity with injected uniforms cannot.
"""

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import posterior_check as pc
from deconv3d_tpu_torch import sampler as sm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These toys are a few thousand voxels: torch's intra-op threads cost
    more than they give, and under a parallel test run they contend with
    the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_toy(rng, L=16, Y=6, X=6, fsf_size=5, lsf_width=5, noise=0.1,
              dtype=np.float64, fsf_fwhm=0.5, lsf_fwhm=2.0):
    """Synthetic emission-line cube + instrument (tests/test_sampler.py's)."""
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=fsf_fwhm),
                          lsf=ins.GaussianLSF(fwhm=lsf_fwhm), pixel_scale=0.2)
    cube0 = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25, dtype=dtype)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=fsf_size, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=lsf_width)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=dtype)
    return cube, inst


def test_steady_state_acceptance_near_target(rng):
    """Post-burn-in acceptance must hold the 0.234 target (±0.05 band)."""
    cube, inst = _make_toy(rng, noise=0.2)
    cfg = sm.RunConfig(max_iterations=500, burn_in=100, seed=11,
                       fsf_size=5, lsf_width=5, dtype=np.float64)
    p = sm.make_problem(cube, inst, cfg, device="cpu")
    res = sm.run_sweeps(p, sm.init_state(p), 500)
    acc_tail = res.accept_trace.numpy()[-200:]
    assert 0.18 < acc_tail.mean() < 0.29, acc_tail.mean()


def test_gibbs_mixes_faster_than_mh_under_blur():
    """ESS of the flux trace after a burn-in of 100: gibbs > 2 × MH on the
    strong-blur toy (the JAX package's toy, seed, burn-in and bound), one
    chain of each.

    The JAX test runs 400 sweeps.  There MH's autocorrelation time of the
    flux outlasts the 300 kept samples, the truncated ESS estimate is
    noise, and the ratio is about 1 at the median seed in either package
    (``test_single_chain_mixing_statistic_is_distributed_as_the_
    reference``, which also holds the two packages' ratios to one
    distribution at both depths).  Here 1600 sweeps."""
    ratio = mixing_ratio("port", 6, 1600)
    assert ratio > 2.0, ratio


def mixing_ratio(package, seed, n=400):
    """The JAX test's statistic in ``package`` ('jax' or 'port'): one
    chain of ``n`` sweeps of each sampler on the strong-blur toy (rng seed
    42), run seed ``seed``, the flux ESS after a burn-in of 100; gibbs's
    ESS over MH's."""
    rng = np.random.default_rng(42)
    kw = dict(max_iterations=n, burn_in=100, seed=seed, dtype=np.float64,
              fsf_size=5, lsf_width=5)
    ess = {}
    if package == "jax":
        import os
        import sys

        import deconv3d_tpu.chains as jch
        import deconv3d_tpu.sampler as jsm

        sys.path.insert(0, os.path.dirname(__file__))
        import test_sampler as ref

        cube, inst, _ = ref._make_toy(rng, L=8, noise=0.3)
        for samp in ("mh", "gibbs"):
            p = jsm.make_problem(cube, inst, jsm.RunConfig(sampler=samp,
                                                           **kw))
            flux = np.asarray(jsm.run_sweeps(p, jsm.init_state(p),
                                             n).flux_trace)
            ess[samp] = jch.effective_sample_size(flux[None, 100:])
    else:
        cube, inst = _make_toy(rng, L=8, noise=0.3)
        for samp in ("mh", "gibbs"):
            p = sm.make_problem(cube, inst, sm.RunConfig(sampler=samp, **kw),
                                device="cpu")
            flux = sm.run_sweeps(p, sm.init_state(p), n).flux_trace
            ess[samp] = ch.effective_sample_size(flux.numpy()[None, 100:])
    return ess["gibbs"] / ess["mh"]


@pytest.mark.slow
@pytest.mark.parametrize("n,seeds", [(400, range(20)), (1600, range(10))])
def test_single_chain_mixing_statistic_is_distributed_as_the_reference(
        n, seeds):
    """The JAX test's statistic (``mixing_ratio``) over run seeds in both
    packages, at the JAX test's 400 sweeps and at the 1600 of
    ``test_gibbs_mixes_faster_than_mh_under_blur``: the per-seed ratios of
    the two packages are one distribution (two-sided Mann-Whitney p ≥
    0.01), and at 1600 the port's median seed has gibbs's ESS above twice
    MH's.  At 400 the kept 300 sweeps are shorter than MH's
    autocorrelation time of the flux, and the ratio is about 1 at the
    median seed in either package."""
    from scipy.stats import mannwhitneyu

    ratios = {pkg: [mixing_ratio(pkg, s, n) for s in seeds]
              for pkg in ("jax", "port")}
    p = mannwhitneyu(ratios["jax"], ratios["port"]).pvalue
    medians = {pkg: float(np.median(r)) for pkg, r in ratios.items()}
    print({"sweeps": n, "ratios": ratios, "medians": medians,
           "mann_whitney_p": p})
    assert p >= 0.01, (p, ratios)
    if n == 1600:
        assert medians["port"] > 2.0, ratios


@pytest.mark.slow
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_posterior_matches_analytic(rng, sampler):
    """Chain moments against the analytic Gaussian posterior of the
    linear model (flat prior, max off-diagonal ρ ≈ 0.34): mean|z| < 0.2,
    max|z| < 1, median σ ratio within 0.1 of 1; MH's acceptance over the
    last 1000 sweeps in (0.15, 0.35); MH 8000 sweeps (burn-in 1000),
    gibbs 3000 (500)."""
    n_sweeps, burn_in = pc.ANALYTIC_RUNS[sampler]
    cube, inst, mean, sig = pc.analytic_toy(rng)
    cfg = sm.RunConfig(max_iterations=n_sweeps, burn_in=burn_in,
                       seed=pc.ANALYTIC_SEED, dtype=np.float64, fsf_size=3,
                       lsf_width=3, sampler=sampler)
    p = sm.make_problem(cube, inst, cfg, device="cpu")
    res = sm.run_sweeps(p, sm.init_state(p), n_sweeps)
    acc = float(res.accept_trace[-1000:].mean()) if sampler == "mh" else None
    bad, figures = pc.analytic_failures(
        mean, sig, sm.posterior_mean(p, res.state).numpy().ravel(),
        sm.posterior_std(p, res.state).numpy().ravel(), acc)
    print(figures)
    assert not bad, (bad, figures)
