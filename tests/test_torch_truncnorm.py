"""``ops/truncnorm.py``: the port's truncated-normal transform against the
JAX package's on the same uniforms, and the port's mirror of
``tests/test_truncnorm.py`` (moments and quantiles at every depth).

Tolerances.  float64: 1e-6 relative (measured: 5e-13; the two evaluate the
tail's hazard by different but equal formulas).  float32: |Δz| ≤ 1e-4 ·
max(1, |z|); the inverse CDF near p = 1 amplifies the float32 rounding of
p by 1/φ(z), so both packages sit up to ~1e-5 from the float64 draw.
"""

import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp

from deconv3d_tpu.ops.truncnorm import transform_uniforms as jax_transform
from deconv3d_tpu_torch.ops import truncnorm as tn


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield


def _draws(rng, n=4000):
    alpha = np.concatenate([np.linspace(-5.0, 10.0, n // 2),
                            np.geomspace(10.0, 1e4, n // 2)])
    u1, u2 = (rng.uniform(1e-12, 1.0, n) for _ in range(2))
    return alpha, u1, u2


@pytest.mark.parametrize("dtype, rel", [(np.float64, 1e-6),
                                        (np.float32, 1e-4)])
def test_transform_matches_jax(rng, dtype, rel):
    alpha, u1, u2 = (a.astype(dtype) for a in _draws(rng))
    want = np.asarray(jax_transform(jnp.asarray(alpha), jnp.asarray(u1),
                                    jnp.asarray(u2)), np.float64)
    got = tn.transform_uniforms(torch.as_tensor(alpha), torch.as_tensor(u1),
                                torch.as_tensor(u2))
    assert got.dtype == torch.as_tensor(u1).dtype
    got = got.double().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= rel, (err.max(), alpha[err.argmax()])
    # both regions are exercised, and every draw lies in [α, ∞)
    assert (alpha > tn.TAIL_SWITCH).any() and (alpha <= tn.TAIL_SWITCH).any()
    ulp = np.finfo(dtype).eps * np.maximum(1.0, np.abs(alpha))
    assert (got >= alpha - 64 * ulp).all()


def test_float32_tail_has_no_cancellation():
    """At α = 1e4 the float32 draw agrees with the float64 one to float32's
    resolution there: the erfcx form of the hazard does not cancel."""
    alpha = torch.full((64,), 1e4)
    u = torch.linspace(0.01, 0.99, 64)
    z32 = tn.transform_uniforms(alpha, u, u).double()
    z64 = tn.transform_uniforms(alpha.double(), u.double(), u.double())
    assert float((z32 - z64).abs().max()) < 4e-3     # 4 ulp of 1e4


def test_log_sf_matches_log_ndtr():
    z = torch.linspace(0.0, 50.0, 501, dtype=torch.float64)
    np.testing.assert_allclose(tn.log_sf(z).numpy(),
                               torch.special.log_ndtr(-z).numpy(), rtol=1e-13)


@pytest.mark.parametrize("alpha", [-3.0, -0.5, 0.0, 1.5, 3.0, 8.0, 50.0,
                                   300.0, 1e4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_moments_match_analytic(alpha, dtype):
    """Mirror of tests/test_truncnorm.py: sampled mean / std of TN[α, ∞)
    against the analytic ones, where probability-space inversion saturates
    too (α ≳ 6 in float32, ≳ 8 in float64)."""
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    z = tn.truncated_standard_normal(gen, alpha, (n,), dtype).double().numpy()
    assert np.isfinite(z).all()
    assert z.min() >= alpha - 1e-3 * max(1.0, abs(alpha))
    if alpha < 30:
        lam = float(norm.pdf(alpha) / norm.sf(alpha))
        mean_true, var_true = lam, 1.0 + alpha * lam - lam * lam
    else:
        # 1 + αλ − λ² cancels in float64 at large α: the asymptotic moments
        mean_true = alpha + 1.0 / alpha - 2.0 / alpha**3
        var_true = 1.0 / alpha**2
    tol = 6.0 * np.sqrt(var_true / n) + (
        2e-4 * abs(alpha) if dtype == torch.float32 else 0.0)
    assert abs(z.mean() - mean_true) < tol, (z.mean(), mean_true)
    ulp = torch.finfo(dtype).eps * max(1.0, abs(alpha))
    if np.sqrt(var_true) > 4 * ulp:
        np.testing.assert_allclose(z.std(), np.sqrt(var_true), rtol=0.05)


def test_quantiles_match_scipy():
    """Mirror of tests/test_truncnorm.py: the whole distribution at α = 12
    (float64) through the true CDF must be U(0, 1)."""
    alpha, n = 12.0, 100_000
    gen = torch.Generator().manual_seed(1)
    z = tn.truncated_standard_normal(gen, alpha, (n,)).numpy()
    u = 1.0 - np.exp(norm.logsf(z) - norm.logsf(alpha))
    grid = np.linspace(0.05, 0.95, 19)
    np.testing.assert_allclose(np.quantile(u, grid), grid, atol=0.01)
