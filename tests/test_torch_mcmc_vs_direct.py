"""The port's MCMC engines held to the exact Gaussian posterior.

Counterpart of ``tests/test_mcmc_vs_direct.py`` on the port's plain
engine: chains STARTED at iid exact posterior draws of a miniature field
(chromatic Moffat blur, masked spaxels, per-voxel variance), so every
chain is stationary from sweep 0 and the cross-chain standard errors are
honest at any mixing speed (``deconv3d_tpu_torch/posterior_check.py``).
The truth is the posterior the port's sweeps sample: the low-rank FSF and
the bf16-valued weights of ``make_problem``.  The MCMC rows are ``slow``,
as the JAX package marks them, with its seeds, fields, depths and bounds,
on 32 chains: its 8 keys and 24 more, the starts drawn from its start
seed's normals through one Cholesky factor (``posterior_check.N_CHAINS``
says why; ``test_rows_on_shared_starts_and_keys`` runs both packages'
rows on shared starts and keys); the direct-draw row is
``test_torch_direct.py::test_draw_moments_match_analytic_posterior``.

The first tests hold ``posterior_check``'s copies to the JAX package's
originals on the same seeded inputs (JAX imported inside the tests, so the
file loads where JAX is not installed).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from deconv3d_tpu_torch import posterior_check as pc

_HERE = os.path.dirname(__file__)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These toys are a few thousand voxels: torch's intra-op threads cost
    more than they give, and under a parallel test run they contend with
    the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    """The JAX package's ``benchmarks/mcmc_vs_direct.py`` and its tests'
    ``_dense_forward_operator`` / ``_make_truth`` / ``_monitor_truth``."""
    sys.path.insert(0, os.path.join(_HERE, "..", "benchmarks"))
    import mcmc_vs_direct as bench
    import test_mcmc_vs_direct as ref_mcmc
    import test_sampler as ref_sampler

    return bench, ref_mcmc, ref_sampler


def _traces(rng, C=8, n=200, K=12):
    """AR(1) chains around a known mean: [C, n, K]."""
    x = np.empty((C, n, K))
    x[:, 0] = rng.standard_normal((C, K))
    for t in range(1, n):
        x[:, t] = 0.9 * x[:, t - 1] + np.sqrt(1 - 0.81) * rng.standard_normal(
            (C, K))
    return x + np.linspace(-1.0, 1.0, K)


def test_statistics_match_the_reference(rng):
    """pooled_mean_z / pooled_var_z (with and without the reference's
    standard errors), pooled_var_ratio, var_dof and add_box_columns equal
    the JAX package's on the same traces."""
    bench, _, _ = _reference()
    tr = _traces(rng)
    mu0 = np.linspace(-1.0, 1.0, tr.shape[-1]) + 0.01
    var0 = np.full(tr.shape[-1], 1.1)
    se = np.full(tr.shape[-1], 0.02)
    for got, want in (
        (pc.pooled_mean_z(tr, mu0), bench.pooled_mean_z(tr, mu0)),
        (pc.pooled_mean_z(tr, mu0, se), bench.pooled_mean_z(tr, mu0, se)),
        (pc.pooled_var_z(tr, mu0, var0), bench.pooled_var_z(tr, mu0, var0)),
        (pc.pooled_var_z(tr, mu0, var0, se),
         bench.pooled_var_z(tr, mu0, var0, se)),
        (pc.pooled_var_ratio(tr, mu0, var0),
         bench.pooled_var_ratio(tr, mu0, var0)),
        (pc.var_dof(tr, mu0), bench.var_dof(tr, mu0)),
    ):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    boxes = [slice(0, 3), slice(5, 9)]
    np.testing.assert_array_equal(pc.add_box_columns(tr, boxes),
                                  bench.add_box_columns(tr, boxes))


def test_dense_forward_operator_matches_the_reference(rng):
    """The vectorised dense K against ``tests/test_sampler.py``'s column
    by column scipy one, chromatic FSF and a one-plane FSF, Y ≠ X."""
    _, _, ref_sampler = _reference()
    L, Y, X, f = 5, 4, 6, 3
    lsf = rng.random((L, 3))
    lsf /= lsf.sum(axis=1, keepdims=True)
    for fsf in (rng.random((L, f, f)), rng.random((1, 5, 5))):
        got = pc.dense_forward_operator(L, Y, X, fsf, lsf)
        want = ref_sampler._dense_forward_operator(L, Y, X, fsf, lsf)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


#: the fields' float64 agreement of two exact posteriors computed two ways
#: (the JAX test's explicit inverse, the port's one Cholesky factor):
#: cond(A)·ε — 2.8e10 × 2.2e-16 on the heavy field, 1.1e6 × 2.2e-16 on the
#: mild one, where 1e-10 holds
TRUTH_RTOL = {"heavy": 1e-5, "mild": 1e-10}


@pytest.mark.parametrize("field", ["heavy", "mild"])
def test_field_monitors_and_truth_match_the_reference(field):
    """build_field's cube, monitor_for's voxels and boxes, exact_posterior's
    mean and covariance, and monitor_truth's moments against the JAX
    package's on both exact-start fields.  Given the JAX problem's
    operator, weights and data, the exact posterior agrees to float64
    rounding (``TRUTH_RTOL``); the chain starts are mean + R⁻ᵀz for
    A = RRᵀ and the seed's z; the port's own truth (its low-rank FSF,
    bf16-valued weights) stays within 1e-4 of the JAX one."""
    import scipy.linalg as sla

    import deconv3d_tpu.sampler as jsm

    bench, ref_mcmc, ref_sampler = _reference()
    fwhm = pc.FWHM[field]
    F = pc.FIELD
    args = (F["L"], F["Y"], F["X"], F["fsf_size"])
    cube, _, sources = pc.build_field(*args, noise=pc.NOISE, fwhm=fwhm)
    jcube, jinst, jsources = bench.build_field(*args, noise=pc.NOISE,
                                               fwhm=fwhm)
    assert sources == jsources
    np.testing.assert_array_equal(cube.mask.numpy(), np.asarray(jcube.mask))
    np.testing.assert_array_equal(cube.variance.numpy(),
                                  np.asarray(jcube.variance))
    scale = float(np.abs(np.asarray(jcube.data)).max())
    np.testing.assert_allclose(cube.data.numpy(), np.asarray(jcube.data),
                               rtol=0, atol=1e-6 * scale)

    want = ref_mcmc._make_truth(fwhm)
    jp = jsm.make_problem(jcube, jinst, jsm.RunConfig(
        max_iterations=1, seed=0, fsf_size=F["fsf_size"], dtype=np.float64))
    L, Y, X = F["L"], F["Y"], F["X"]
    # the reference's own K: at cond ≈ 3e10 an operator equal to rounding
    # (test_dense_forward_operator_matches_the_reference) moves the mean by
    # ~1e-4 of its scale
    K = ref_sampler._dense_forward_operator(L, Y, X, np.asarray(jp.fsf),
                                            np.asarray(jp.lsf))
    h = jp.f // 2
    w = np.asarray(jp.w_pad[:, h:h + Y, h:h + X]).ravel()
    d = np.asarray(jp.data_pad[:, h:h + Y, h:h + X]).ravel()
    got = pc.exact_posterior(K, w, d, np.asarray(jp.valid)[:Y, :X], L,
                             pc.REFERENCE_CHAINS)
    np.testing.assert_array_equal(got["free"], want["free"])
    for name in ("mean", "cov"):
        np.testing.assert_allclose(
            got[name], want[name], rtol=0,
            atol=TRUTH_RTOL[field] * np.abs(want[name]).max())
    # the starts: iid exact draws from the seed's normals
    Kf = K[:, got["free"]]
    R = np.linalg.cholesky(Kf.T @ (w[:, None] * Kf))
    z = np.random.default_rng(pc.START_SEED).standard_normal(
        (pc.REFERENCE_CHAINS, R.shape[0]))
    draws = got["mean"] + sla.solve_triangular(R.T, z.T, lower=False).T
    starts = got["starts"].reshape(pc.REFERENCE_CHAINS, -1)
    np.testing.assert_allclose(starts[:, got["free"]], draws, rtol=0,
                               atol=1e-6 * np.abs(draws).max())
    assert not starts[:, ~got["free"]].any()

    # the port's own truth, on its own problem
    dt = pc.make_truth(fwhm)
    assert np.abs(dt["mean"] - want["mean"]).max() \
        < 1e-4 * np.abs(want["mean"]).max()

    # monitors and their exact moments, on the two packages' problems
    cfg = dict(max_iterations=8, burn_in=0, seed=300, sampler="mh",
               fsf_size=F["fsf_size"], initial="data")
    from deconv3d_tpu_torch import sampler as sm

    p, boxes = pc.with_monitors(dt["cube"], dt["inst"], sm.RunConfig(**cfg),
                                dt["sources"], device="cpu", extra=6)
    jp, jboxes = bench.with_monitors(jcube, jinst, jsm.RunConfig(**cfg),
                                     jsources, extra=6)
    np.testing.assert_array_equal(p.monitor_idx.numpy(),
                                  np.asarray(jp.monitor_idx))
    assert boxes == jboxes
    for a, b in zip(pc.monitor_truth(want, p, p.monitor_idx.numpy(), boxes),
                    ref_mcmc._monitor_truth(want, jp, jp.monitor_idx,
                                            jboxes)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def dense_truth():
    """Heavy blur: cond(KᵀWK) ≈ 3e10 — the bias (mean) test field."""
    return pc.make_truth(pc.HEAVY_FWHM)


@pytest.fixture(scope="module")
def dense_truth_mild():
    """Moderate blur: the variance test field."""
    return pc.make_truth(pc.MILD_FWHM)


def _run(dt, sampler, n_sweeps, coarse_every=None):
    with torch.inference_mode():
        return pc.chain_traces(dt, sampler, n_sweeps,
                               coarse_every=coarse_every, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("sampler,n_sweeps,coarse_every", [
    ("gibbs", 300, None),
    ("mh", 600, None),
    ("mh", 300, 8),     # the coarse passes must preserve the posterior too
])
def test_mcmc_means_match_exact_posterior_heavy_blur(dense_truth, sampler,
                                                     n_sweeps, coarse_every):
    """Bias test on the near-singular field: max|z_mean| < 7, q95 < 4, the
    variance ratio in (0.08, 8)."""
    tr, p, boxes, _ = _run(dense_truth, sampler, n_sweeps, coarse_every)
    z_mean, ratio, _, _ = pc.exact_start_stats(dense_truth, tr, p, boxes)
    print(pc.summarize(z_mean, ratio=ratio))
    assert not pc.mean_failures(z_mean, ratio), pc.summarize(z_mean,
                                                             ratio=ratio)


@pytest.mark.slow
@pytest.mark.parametrize("sampler,n_sweeps,min_sharp_frac", [
    ("gibbs", 400, 0.5),
    ("mh", 1200, 0.03),
])
def test_mcmc_moments_match_exact_posterior_mild_blur(dense_truth_mild,
                                                      sampler, n_sweeps,
                                                      min_sharp_frac):
    """Sharp mean and variance test where within-chain evidence is real:
    the mean bounds, the ratio guard, and on the functionals with ≥ 64
    dof of squared series max|z_var| < 7, q95 < 4.5."""
    tr, p, boxes, _ = _run(dense_truth_mild, sampler, n_sweeps)
    z_mean, ratio, z_var, sharp = pc.exact_start_stats(
        dense_truth_mild, tr, p, boxes, sharp=True)
    summary = pc.summarize(z_mean, z_var, ratio, sharp)
    print(summary)
    assert not pc.mean_failures(z_mean, ratio), summary
    assert not pc.variance_failures(z_var, sharp, min_sharp_frac), summary


def _padded_to_full(dt, problem, midx):
    """Flat indices into a [L, Y, X] cube of the monitored voxels
    ``midx`` (flat indices into ``problem``'s padded clean cube)."""
    lam, rest = np.divmod(np.asarray(midx), problem.Yc * problem.Xc)
    y, x = np.divmod(rest, problem.Xc)
    return (lam * dt["Y"] + y) * dt["X"] + x


def shared_start_rows(repeat, rows=tuple(pc.ROWS), n_chains=pc.N_CHAINS,
                      chain_counts=(pc.REFERENCE_CHAINS, pc.N_CHAINS)):
    """Both packages' exact-start rows on shared random inputs: repetition
    ``repeat`` draws the start normals z with ``START_SEED + repeat`` (each
    package maps the same z through its own exact posterior; 0: the rows'
    own starts) and keys chain c ``SEED0 + 1000·repeat + c``.  The figures
    of the first ``k`` chains for each k of ``chain_counts`` (the first k
    chains of a batch are the k-chain row: the same keys and starts),
    with the signed z_var of the sharp functionals.  JSON-ready dicts, one
    per (package, row, k)."""
    import jax

    import deconv3d_tpu.sampler as jsm

    bench, ref_mcmc, _ = _reference()
    F = pc.FIELD
    L, Y, X = F["L"], F["Y"], F["X"]
    seed0 = pc.SEED0 + 1000 * repeat
    start_seed = pc.START_SEED + repeat
    truths = {}
    for field in {pc.ROWS[r][0] for r in rows}:
        port = pc.make_truth(pc.FWHM[field], n_chains, start_seed=start_seed)
        cube, inst, sources = bench.build_field(
            L, Y, X, F["fsf_size"], noise=pc.NOISE, fwhm=pc.FWHM[field])
        jp = jsm.make_problem(cube, inst, jsm.RunConfig(
            max_iterations=1, seed=0, fsf_size=F["fsf_size"],
            dtype=np.float64))
        h = jp.f // 2
        jdt = pc.exact_posterior(
            pc.dense_forward_operator(L, Y, X, np.asarray(jp.fsf),
                                      np.asarray(jp.lsf)),
            np.asarray(jp.w_pad[:, h:h + Y, h:h + X]).ravel(),
            np.asarray(jp.data_pad[:, h:h + Y, h:h + X]).ravel(),
            np.asarray(jp.valid)[:Y, :X], L, n_chains, start_seed)
        jdt.update(cube=cube, inst=inst, sources=sources,
                   fsf_size=F["fsf_size"], L=L, Y=Y, X=X)
        truths[field] = {"port": port, "jax": jdt}
    out = []
    for row in rows:
        field, sampler, n, every, min_sharp = pc.ROWS[row]
        moments = {}
        for pkg, dt in truths[field].items():
            if pkg == "port":
                with torch.inference_mode():
                    tr, p, boxes, _ = pc.chain_traces(
                        dt, sampler, n, coarse_every=every, seed0=seed0,
                        device="cpu")
                midx = p.monitor_idx.numpy()
            else:
                tr, p, boxes = ref_mcmc._chain_traces(
                    dt, sampler, n, coarse_every=every, seed0=seed0)
                midx = np.asarray(p.monitor_idx)
                # one compiled program per chain (its seed is static): a
                # long-lived process that keeps them all crashes in XLA
                jax.clear_caches()
            mu0, var0 = pc.monitor_truth(dt, p, midx, boxes)
            # each chain's time averages of f and of (f − μ₀)², [C, K]
            moments[pkg] = (tr.mean(axis=1), ((tr - mu0) ** 2).mean(axis=1))
            # the starts alone, as a trace of one sweep
            st = pc.add_box_columns(dt["starts"].reshape(
                n_chains, 1, -1)[..., _padded_to_full(dt, p, midx)], boxes)
            for k in chain_counts:
                t = tr[:k]
                z_mean = pc.pooled_mean_z(t, mu0)
                ratio = pc.pooled_var_ratio(t, mu0, var0)
                failures = pc.mean_failures(z_mean, ratio)
                rec = {"package": pkg, "row": row, "repeat": repeat,
                       "chains": k, **pc.summarize(z_mean, ratio=ratio),
                       "argmin_ratio": int(ratio.argmin()),
                       "starts_ratio_min": float(pc.pooled_var_ratio(
                           st[:k], mu0, var0).min())}
                if min_sharp is not None:
                    z_var = pc.pooled_var_z(t, mu0, var0)
                    sharp = pc.var_dof(t, mu0) >= pc.SHARP_DOF
                    failures += pc.variance_failures(z_var, sharp, min_sharp)
                    rec.update(pc.summarize(z_mean, z_var, ratio, sharp))
                    rec["z_var_sharp"] = [float(v) for v in z_var[sharp]]
                rec["failures"] = failures
                out.append(rec)
        for k in chain_counts:
            rec = {"package": "paired", "row": row, "repeat": repeat,
                   "chains": k}
            for i, name in enumerate(("mean", "var")):
                t = paired_t(moments["port"][i][:k], moments["jax"][i][:k])
                rec[f"max_abs_t_{name}"] = float(np.abs(t).max())
                rec[f"mean_t_{name}"] = float(t.mean())
            out.append(rec)
    return out


def paired_t(port, jax):
    """t-statistics [K] of the chain-by-chain differences ``port − jax``
    ([C, K], chain c of both started at the same draw): under the
    hypothesis that the two packages' samplers are the same Markov chain,
    each difference is symmetric about 0 (the start cancels), so t is
    close to Student's t with C − 1 dof."""
    d = port - jax
    return d.mean(axis=0) / np.maximum(
        d.std(axis=0, ddof=1) / np.sqrt(d.shape[0]), 1e-300)


#: repetitions of the rows on shared starts and keys (repetition 0: the
#: rows' own), and the bound on the paired t-statistics over a row's
#: functionals (Student's t with 31 dof: P(|t| > 6.5) ≈ 3e-7 each)
SHARED_REPEATS, PAIRED_T_MAX = 12, 6.5


@pytest.mark.slow
@pytest.mark.parametrize("repeat", range(SHARED_REPEATS))
def test_rows_on_shared_starts_and_keys(repeat):
    """The five exact-start rows in both packages on the same start
    normals and chain keys (``shared_start_rows``).  Chain c of the two
    packages starts at the same exact draw, so the chain-by-chain
    differences of the time averages of f and of (f − μ₀)² test that the
    port runs the JAX package's Markov chain, with the start's offset
    cancelled: at 32 chains every functional's paired |t| < 6.5.  Printed
    beside them, for each package, the rows' figures and failures at the
    JAX package's 8 chains (chains 0–7 of the same runs) and at 32: the
    rows' failure rates under the null, measured and not held."""
    records = shared_start_rows(repeat)
    for rec in records:
        print(json.dumps(rec))
    paired = [r for r in records
              if r["package"] == "paired" and r["chains"] == pc.N_CHAINS]
    assert len(paired) == len(pc.ROWS)
    for r in paired:
        assert r["max_abs_t_mean"] < PAIRED_T_MAX, r
        assert r["max_abs_t_var"] < PAIRED_T_MAX, r
