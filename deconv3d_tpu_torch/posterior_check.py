"""MCMC chains held to the exact Gaussian posterior (numpy / torch only).

The flat-prior posterior of the linear model is Gaussian, N(A⁻¹KᵀWd, A⁻¹)
with A = KᵀWK over the free voxels, and at toy scale its dense form is
computable.  The checks run chains STARTED at iid exact posterior draws
(the exact-start stationarity test): under the hypothesis that a sampler
targets this posterior every chain is stationary from sweep 0, so

* each chain's time-average of a functional is unbiased whatever the
  mixing speed, and the C chain-averages give honest cross-chain standard
  errors (:func:`pooled_mean_z`);
* each chain's time-average of (f − μ₀)² estimates Var f without the
  slow-mixing bias of a sample variance (:func:`pooled_var_z`,
  :func:`pooled_var_ratio`, gated by :func:`var_dof`).

A sampler with a wrong stationary distribution (acceptance algebra,
conditional precision, correlated or colliding random streams, a coarse
pass that breaks detailed balance) drifts off the exact moments; slow
mixing alone cannot fail the test.

These are the port's own copies of the JAX package's statistics helpers
(``benchmarks/mcmc_vs_direct.py``), of its dense forward operator
(``tests/test_sampler.py``) and of its exact posterior and chain starts
(``tests/test_mcmc_vs_direct.py``), with two changes of substance: the
truth is the posterior the port's sweeps sample — the low-rank FSF
Σ_s spec_s ⊗ img_s and the bf16-valued weights of
:func:`deconv3d_tpu_torch.sampler.make_problem`, read from the problem —
and the mean, the covariance and the starts all come from one Cholesky
factor A = RRᵀ (the JAX test inverts A and factors the inverse, whose
rounding at cond(A) ≈ 3e10 need not be positive definite): the starts are
exact draws from the seed's normals, but not the JAX test's draws.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import chains as chn
from . import convolve as cv
from . import instruments as ins
from . import sampler as sm
from .cube import Cube

#: the exact-start test fields: 24×10×10, f = 5, noise 0.3
FIELD = dict(L=24, Y=10, X=10, fsf_size=5)
#: the JAX package's chains per row, and the port's: chains 0–7 of the
#: port's rows are an 8-chain row (keys SEED0 + c, the first 8 starts).
#: With 8, the rows fail under the null in either package: the heavy rows'
#: chains barely move, so their verdict is that of 8 start draws, and the
#: mild gibbs row's sharp fraction sits near its 50% gate; on shared
#: starts and keys the JAX package's own 8-chain rows fail as the port's
#: do (``tests/test_torch_mcmc_vs_direct.py::
#: test_rows_on_shared_starts_and_keys``, PERF.md §6).  32 chains hold the
#: same bounds with twice the power.
REFERENCE_CHAINS, N_CHAINS = 8, 32
NOISE = 0.3
#: Moffat FWHM of the heavy-blur (bias) and mild-blur (variance) fields
HEAVY_FWHM, MILD_FWHM = 0.7, 0.3
#: chain c is keyed ``SEED0 + c``; the chain starts are drawn with START_SEED
SEED0, START_SEED = 300, 99


# ---------------------------------------------------------------------------
# Exact-start pooled z-statistics
# ---------------------------------------------------------------------------

def pooled_mean_z(chain_traces, mu0, mu0_se=None):
    """z-scores of the pooled chain mean against the exact mean ``mu0``
    [K]: ``chain_traces`` [C, n, K], each chain started at an iid exact
    draw; cross-chain standard error (``mu0_se``: the reference's own, or
    None for an analytic truth)."""
    cm = np.asarray(chain_traces).mean(axis=1)            # [C, K]
    C = cm.shape[0]
    pooled = cm.mean(axis=0)
    se = cm.std(axis=0, ddof=1) / np.sqrt(C)
    if mu0_se is not None:
        se = np.sqrt(se**2 + np.asarray(mu0_se) ** 2)
    return (pooled - mu0) / np.maximum(se, 1e-30)


def pooled_var_z(chain_traces, mu0, var0, var0_se=None):
    """z-scores of the pooled second moment about ``mu0`` against ``var0``.

    For a functional the chain barely moves, each chain's average of
    (f − μ₀)² is about one χ²₁ draw and the t-statistic is heavy-tailed:
    assert on it only where :func:`var_dof` shows within-chain evidence."""
    v = ((np.asarray(chain_traces) - mu0) ** 2).mean(axis=1)   # [C, K]
    C = v.shape[0]
    pooled = v.mean(axis=0)
    se = v.std(axis=0, ddof=1) / np.sqrt(C)
    if var0_se is not None:
        se = np.sqrt(se**2 + np.asarray(var0_se) ** 2)
    return (pooled - var0) / np.maximum(se, 1e-30)


def pooled_var_ratio(chain_traces, mu0, var0):
    """Pooled second moment about ``mu0`` over ``var0`` [K]: the
    gross-scale variance guard, valid for arbitrarily slow functionals
    (worst case v̄ ~ χ²_C / C)."""
    v = ((np.asarray(chain_traces) - mu0) ** 2).mean(axis=1).mean(axis=0)
    return v / np.maximum(var0, 1e-30)


def var_dof(chain_traces, mu0):
    """Total within-chain ESS of the squared series per functional [K]:
    the gate for sharp variance assertions (≥ ~64 ⇒ near-normal)."""
    sq = (np.asarray(chain_traces) - mu0) ** 2            # [C, n, K]
    C, _, K = sq.shape
    return np.asarray([
        sum(max(chn.effective_sample_size(sq[c, :, k]), 1.0)
            for c in range(C))
        for k in range(K)
    ])


def summarize(z_mean, z_var=None, ratio=None, sharp=None) -> dict:
    """The figures a check reads, unrounded: max and 95% quantile of
    |z_mean|, the ratio's range, and where ``z_var`` is given the sharp
    functionals' count, fraction and |z_var| max and q95."""
    out = {"max_abs_z_mean": float(np.max(np.abs(z_mean))),
           "q95_abs_z_mean": float(np.quantile(np.abs(z_mean), 0.95))}
    if ratio is not None:
        out["var_ratio_range"] = [float(ratio.min()), float(ratio.max())]
    if z_var is not None and sharp is not None:
        out["n_var_sharp"] = int(sharp.sum())
        out["sharp_fraction"] = float(sharp.mean())
        if sharp.any():
            zs = np.abs(z_var[sharp])
            out["max_abs_z_var_sharp"] = float(zs.max())
            out["q95_abs_z_var_sharp"] = float(np.quantile(zs, 0.95))
    return out


#: the JAX package's bounds (``tests/test_mcmc_vs_direct.py``, where 8
#: chains give ~7 dof per functional, so max |t₇| < 7 w.p. ≫ 99.9% under H0)
MAX_Z_MEAN, Q95_Z_MEAN = 7.0, 4.0
RATIO_RANGE = (0.08, 8.0)
MAX_Z_VAR, Q95_Z_VAR, SHARP_DOF = 7.0, 4.5, 64.0


def mean_failures(z_mean, ratio) -> list:
    """What of the mean test and the ratio guard fails (empty: passes)."""
    bad = []
    if not np.abs(z_mean).max() < MAX_Z_MEAN:
        bad.append(f"max|z_mean| {np.abs(z_mean).max():.3f} >= {MAX_Z_MEAN}")
    if not np.quantile(np.abs(z_mean), 0.95) < Q95_Z_MEAN:
        bad.append(f"q95|z_mean| {np.quantile(np.abs(z_mean), 0.95):.3f} "
                   f">= {Q95_Z_MEAN}")
    if not (ratio.min() > RATIO_RANGE[0] and ratio.max() < RATIO_RANGE[1]):
        bad.append(f"variance ratio [{ratio.min():.4f}, {ratio.max():.4f}] "
                   f"outside {RATIO_RANGE}")
    return bad


def variance_failures(z_var, sharp, min_sharp_frac) -> list:
    """What of the sharp variance test fails (empty: passes)."""
    if not sharp.mean() >= min_sharp_frac:
        return [f"sharp fraction {sharp.mean():.3f} < {min_sharp_frac}"]
    zs = np.abs(z_var[sharp])
    bad = []
    if not zs.max() < MAX_Z_VAR:
        bad.append(f"max|z_var| {zs.max():.3f} >= {MAX_Z_VAR}")
    if not np.quantile(zs, 0.95) < Q95_Z_VAR:
        bad.append(f"q95|z_var| {np.quantile(zs, 0.95):.3f} >= {Q95_Z_VAR}")
    return bad


# ---------------------------------------------------------------------------
# Problem construction
# ---------------------------------------------------------------------------

def build_field(L, Y, X, fsf_size, seed=0, noise=1.0, fwhm=0.5,
                fwhm_slope=-3e-5, gaussian=False, device="cpu"):
    """Chromatic-blur field with a mask, per-voxel variance and two
    sources: ``(cube, instrument, sources)``.  The noiseless cube is the
    instrument's full kernel banks applied to the truth in float32."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((L, Y, X), np.float32)
    s1 = (L // 3, Y // 3, X // 3)
    s2 = (2 * L // 3, 2 * Y // 3, 2 * X // 3)
    truth[s1] = 60.0
    truth[s2] = 40.0
    # per-voxel variance: a smooth ×2 spatial gradient
    sig = noise * (1.0 + np.linspace(0, 1, X, dtype=np.float32))[None, None]
    var = np.broadcast_to(sig**2, truth.shape).astype(np.float32).copy()
    # mask a corner block and a stripe
    mask = np.zeros((Y, X), bool)
    mask[: Y // 8, : X // 8] = True
    mask[Y // 2, :] = True
    if gaussian:
        fsf = ins.GaussianFSF(fwhm=fwhm)
    else:
        fsf = ins.MoffatFSF(fwhm=fwhm, beta=2.5, fwhm_slope=fwhm_slope,
                            lambda_ref=4750.0 + 1.25 * L / 2)
    inst = ins.Instrument(fsf=fsf, lsf=ins.MUSELSF(), pixel_scale=0.2)
    lam = 4750.0 + 1.25 * np.arange(L)
    obs = cv.convolve_cube(
        torch.as_tensor(truth),
        inst.fsf.bank(lam, size=fsf_size, pixel_scale=inst.pixel_scale),
        inst.lsf.bank(lam, cdelt=1.25)).numpy()
    data = obs + np.sqrt(var) * rng.standard_normal(truth.shape).astype(
        np.float32)
    cube = Cube.from_data(data, variance=var, mask=mask, crval=4750.0,
                          cdelt=1.25, device=device)
    return cube, inst, (s1, s2)


def monitor_for(problem, sources, half=1, lhalf=1, extra=8):
    """Monitor indices into the padded clean cube: a box around each
    source and ``extra`` scattered valid voxels; ``(idx, boxes)`` with the
    column slice of each box (for the box-flux sums)."""
    p = problem
    valid = p.valid.cpu().numpy()
    idx, boxes = [], []
    for (l0, y0, x0) in sources:
        start = len(idx)
        for dl in range(-lhalf, lhalf + 1):
            for dy in range(-half, half + 1):
                for dx in range(-half, half + 1):
                    y, x = y0 + dy, x0 + dx
                    if 0 <= y < p.Y and 0 <= x < p.X and valid[y, x]:
                        idx.append(((l0 + dl) % p.L) * p.Yc * p.Xc
                                   + y * p.Xc + x)
        boxes.append(slice(start, len(idx)))
    rng = np.random.default_rng(11)
    vy, vx = np.nonzero(valid[: p.Y, : p.X])
    pick = rng.choice(len(vy), size=extra, replace=False)
    for j in pick:
        idx.append(int(rng.integers(0, p.L)) * p.Yc * p.Xc
                   + vy[j] * p.Xc + vx[j])
    return torch.as_tensor(np.asarray(idx, np.int64), device=p.device), boxes


def with_monitors(cube, inst, cfg, sources, device=None, **kw):
    """``make_problem`` with the monitors of :func:`monitor_for`."""
    p = sm.make_problem(cube, inst, cfg, device=device)
    midx, boxes = monitor_for(p, sources, **kw)
    return dataclasses.replace(p, monitor_idx=midx), boxes


def add_box_columns(trace, boxes):
    """The ``[..., n, K]`` trace with each box's flux sum appended."""
    cols = [trace] + [trace[..., b].sum(axis=-1, keepdims=True)
                      for b in boxes]
    return np.concatenate(cols, axis=-1)


def dense_forward_operator(L, Y, X, fsf, lsf):
    """Dense K ``[L·Y·X, L·Y·X]`` of the separable forward model: the LSF
    matrix of ``lsf`` [L, lw] over λ, then per output plane the 'same'
    convolution with ``fsf`` [L or 1, f, f] (small dims only)."""
    fsf = np.asarray(fsf, np.float64)
    M = cv.lsf_matrix(np.asarray(lsf, np.float64))         # [L, L]
    f = fsf.shape[-1]
    h = f // 2
    y, x = np.arange(Y), np.arange(X)
    dy = y[:, None] - y[None, :] + h                       # [Y, Y']
    dx = x[:, None] - x[None, :] + h                       # [X, X']
    inside = (((dy >= 0) & (dy < f))[:, None, :, None]
              & ((dx >= 0) & (dx < f))[None, :, None, :])  # [Y, X, Y', X']
    kern = np.broadcast_to(fsf, (L, f, f)) if fsf.shape[0] == 1 else fsf
    S = kern[:, np.clip(dy, 0, f - 1)[:, None, :, None],
             np.clip(dx, 0, f - 1)[None, :, None, :]] * inside
    S = S.reshape(L, Y * X, Y * X)
    return (S[:, :, None, :] * M[:, None, :, None]).reshape(
        L * Y * X, L * Y * X)


def sweep_fsf(problem) -> np.ndarray:
    """The FSF the sweeps apply, float64: Σ_s spec_s ⊗ img_s of the
    problem's factors (``make_problem``), not the rasterised bank."""
    return np.einsum("sl,sab->lab",
                     problem.fsf_spec.double().cpu().numpy(),
                     problem.fsf_imgs.double().cpu().numpy())


def exact_posterior(K, w, d, valid, L, n_chains=N_CHAINS, seed=START_SEED):
    """The exact posterior over the free voxels (valid spaxels × every λ)
    of data ``d`` with weights ``w`` under ``K``, and ``n_chains`` iid
    exact draws scattered into full cubes (frozen voxels at 0):
    ``dict(free, mean, cov, starts)``, ``starts`` [C, L, Y, X] float32."""
    Y, X = valid.shape
    free = np.repeat(valid.ravel()[None], L, axis=0).ravel()
    Kf = torch.tensor(K[:, free], dtype=torch.float64)
    w = torch.tensor(w, dtype=torch.float64)
    d = torch.tensor(d, dtype=torch.float64)
    # everything from ONE factor A = RRᵀ: mean = A⁻¹KᵀWd, cov = R⁻ᵀR⁻¹ and
    # the draws x = mean + R⁻ᵀz (cond(A) ≈ 3e10 on the heavy field, where
    # an explicit inverse's rounding need not be positive definite)
    R = torch.linalg.cholesky(Kf.T @ (w[:, None] * Kf))
    mean = torch.cholesky_solve((Kf.T @ (w * d))[:, None], R)[:, 0]
    Rinv = torch.linalg.solve_triangular(
        R, torch.eye(R.shape[0], dtype=torch.float64), upper=False)
    z = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n_chains, mean.numel())))
    draws = mean + torch.linalg.solve_triangular(R.T, z.T, upper=True).T
    starts = np.zeros((n_chains, L * Y * X), np.float64)
    starts[:, free] = draws.numpy()
    return dict(free=free, mean=mean.numpy(), cov=(Rinv.T @ Rinv).numpy(),
                starts=starts.reshape(n_chains, L, Y, X).astype(np.float32))


def make_truth(fwhm, n_chains=N_CHAINS, noise=NOISE, start_seed=START_SEED):
    """The exact-start field of ``fwhm`` (:data:`FIELD`), its exact
    posterior under the sweeps' own forward model and weights, and
    ``n_chains`` exact chain starts drawn with ``start_seed`` (built on the
    CPU in float64)."""
    L, Y, X, fsf_size = (FIELD[k] for k in ("L", "Y", "X", "fsf_size"))
    cube, inst, sources = build_field(L, Y, X, fsf_size, noise=noise,
                                      fwhm=fwhm)
    p = sm.make_problem(cube, inst, sm.RunConfig(
        max_iterations=1, seed=0, fsf_size=fsf_size, dtype=np.float64),
        device="cpu")
    K = dense_forward_operator(L, Y, X, sweep_fsf(p), p.lsf.numpy())
    h = p.f // 2
    w = p.w_pad[:, h:h + Y, h:h + X].numpy().ravel()
    d = p.data_pad[:, h:h + Y, h:h + X].numpy().ravel()
    valid = p.valid.numpy()[:Y, :X]
    truth = exact_posterior(K, w, d, valid, L, n_chains, start_seed)
    truth.update(cube=cube, inst=inst, sources=sources, fsf_size=fsf_size,
                 L=L, Y=Y, X=X)
    return truth


def monitor_truth(dt, problem, midx, boxes):
    """Exact mean and variance of the monitored voxels ``midx`` (flat
    indices into ``problem``'s padded clean cube) and of the box sums."""
    p = problem
    midx = np.asarray(midx)
    lam = midx // (p.Yc * p.Xc)
    rest = midx % (p.Yc * p.Xc)
    y, x = rest // p.Xc, rest % p.Xc
    full_flat = lam * (dt["Y"] * dt["X"]) + y * dt["X"] + x
    pos_of_full = -np.ones(dt["free"].size, np.int64)
    pos_of_full[np.nonzero(dt["free"])[0]] = np.arange(dt["free"].sum())
    pos = pos_of_full[full_flat]
    if not (pos >= 0).all():
        raise ValueError("a monitor touches a frozen voxel")
    mu = list(dt["mean"][pos])
    var = list(np.diag(dt["cov"])[pos])
    for b in boxes:
        sel = pos[b]
        mu.append(dt["mean"][sel].sum())
        var.append(float(dt["cov"][np.ix_(sel, sel)].sum()))
    return np.asarray(mu), np.asarray(var)


def analytic_toy(rng, dtype=np.float64, device="cpu"):
    """The analytic-posterior toy of the JAX package's
    ``tests/test_sampler.py``: 8×4×4, one line (4.0 at (4, 2, 2)), Gaussian
    FSF 3×3 (FWHM 0.25″) and LSF 3 (FWHM 1 Å), noise 0.5 from ``rng``;
    ``(cube, instrument, mean, σ)`` with the exact flat-prior posterior of
    the rasterised banks (max off-diagonal ρ ≈ 0.34: moderately
    correlated, so chain moments test correctness, not mixing)."""
    L, Y, X, noise = 8, 4, 4, 0.5
    truth = np.zeros((L, Y, X))
    truth[4, 2, 2] = 4.0
    lam = 4750.0 + 1.25 * np.arange(L)
    fsf = ins.GaussianFSF(fwhm=0.25).bank(lam, size=3, pixel_scale=0.2)
    lsf = ins.GaussianLSF(fwhm=1.0).bank(lam, cdelt=1.25, width=3)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    cube = Cube.from_data(data, variance=np.full_like(data, noise**2),
                          crval=4750.0, cdelt=1.25, dtype=dtype,
                          device=device)
    K = dense_forward_operator(L, Y, X, fsf, lsf)
    cov = np.linalg.inv(K.T @ K / noise**2)
    mean = cov @ K.T @ data.ravel() / noise**2
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.25),
                          lsf=ins.GaussianLSF(fwhm=1.0), pixel_scale=0.2)
    return cube, inst, mean, np.sqrt(np.diag(cov))


#: the analytic toys' runs (``tests/test_sampler.py``): sweeps, burn-in
ANALYTIC_RUNS = {"mh": (8000, 1000), "gibbs": (3000, 500)}
ANALYTIC_SEED = 13


def analytic_failures(mean, sig, post_mean, post_std, acceptance=None):
    """What of the analytic bounds fails: mean|z| < 0.2, max|z| < 1, the
    median σ ratio within 0.1 of 1, MH's tail acceptance in (0.15, 0.35);
    and the figures: ``(failures, dict)``."""
    z = (post_mean - mean) / sig
    med = float(np.median(post_std / sig))
    out = {"mean_abs_z": float(np.abs(z).mean()),
           "max_abs_z": float(np.abs(z).max()), "median_sigma_ratio": med}
    bad = []
    if not out["mean_abs_z"] < 0.2:
        bad.append(f"mean|z| {out['mean_abs_z']:.4f} >= 0.2")
    if not out["max_abs_z"] < 1.0:
        bad.append(f"max|z| {out['max_abs_z']:.4f} >= 1")
    if not abs(med - 1.0) < 0.1:
        bad.append(f"median sigma ratio {med:.4f} not within 0.1 of 1")
    if acceptance is not None:
        out["tail_acceptance"] = acceptance
        if not 0.15 < acceptance < 0.35:
            bad.append(f"tail acceptance {acceptance:.4f} not in (0.15, 0.35)")
    return bad, out


# ---------------------------------------------------------------------------
# Exact-start chains
# ---------------------------------------------------------------------------

def chain_traces(dt, sampler, n_sweeps, coarse_every=None, seed0=SEED0,
                 device="cuda", segment: Optional[Callable] = None, **config):
    """``[C, n, K]`` traces of the monitored voxels and box sums of C
    chains started at ``dt['starts']``, run as ONE chain batch on
    ``device``; chain c keyed ``seed0 + c`` (the JAX package's per-chain
    seeds).  ``segment(problem, states, n)`` replaces ``run_sweeps`` (a
    pinned kernel); ``config``: more ``RunConfig`` fields (engine, tile).
    Returns ``(traces, problem, boxes, result)``."""
    cfg = sm.RunConfig(max_iterations=n_sweeps, burn_in=0, seed=seed0,
                       sampler=sampler, fsf_size=dt["fsf_size"],
                       initial="data", coarse_every=coarse_every,
                       coarse_mode="global", **config)
    cube = dt["cube"].to(device)
    problem, boxes = with_monitors(cube, dt["inst"], cfg, dt["sources"],
                                   device=device, extra=6)
    states = chn.stack_chains([
        sm.init_state(problem, Cube.from_data(start, crval=4750.0,
                                              cdelt=1.25, device=device),
                      key=seed0 + c)
        for c, start in enumerate(dt["starts"])])
    run = segment or sm.run_sweeps
    r = run(problem, states, n_sweeps)
    traces = add_box_columns(r.monitor_trace.double().cpu().numpy(), boxes)
    return traces, problem, boxes, r


#: the exact-start rows of the JAX package's ``tests/test_mcmc_vs_direct.py``:
#: name → (field, sampler, sweeps, coarse_every, least sharp fraction; None:
#: the heavy field's mean test and ratio guard only)
ROWS = {"heavy-gibbs": ("heavy", "gibbs", 300, None, None),
        "heavy-mh": ("heavy", "mh", 600, None, None),
        "heavy-mh-coarse8": ("heavy", "mh", 300, 8, None),
        "mild-gibbs": ("mild", "gibbs", 400, None, 0.5),
        "mild-mh": ("mild", "mh", 1200, None, 0.03)}
FWHM = {"heavy": HEAVY_FWHM, "mild": MILD_FWHM}


def row_failures(dt, row, traces, problem, boxes):
    """The figures (:func:`summarize`) of one exact-start row's traces and
    what of its bounds fails (empty: the row passes)."""
    min_sharp = ROWS[row][4]
    z_mean, ratio, z_var, sharp = exact_start_stats(
        dt, traces, problem, boxes, sharp=min_sharp is not None)
    failures = mean_failures(z_mean, ratio)
    if min_sharp is not None:
        failures += variance_failures(z_var, sharp, min_sharp)
    return summarize(z_mean, z_var, ratio, sharp), failures


def exact_start_stats(dt, traces, problem, boxes, sharp=False):
    """(z_mean, ratio, z_var, sharp) of ``traces`` against the exact
    posterior; z_var and sharp None unless ``sharp``."""
    mu0, var0 = monitor_truth(dt, problem, problem.monitor_idx.cpu().numpy(),
                              boxes)
    z_mean = pooled_mean_z(traces, mu0)
    ratio = pooled_var_ratio(traces, mu0, var0)
    if not sharp:
        return z_mean, ratio, None, None
    z_var = pooled_var_z(traces, mu0, var0)
    return z_mean, ratio, z_var, var_dof(traces, mu0) >= SHARP_DOF
