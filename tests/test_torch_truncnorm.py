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


def _tail_corners(dtype):
    """α just above the switch, at the middle and at 1e4, against u_tail
    from the dtype's smallest normal up to its last step below 1 (the
    corners where a short tail iteration fails first: the start is
    farthest from the root just above α = 2, and u → 0 puts the root far
    out; u → 1 puts it at α)."""
    fin = np.finfo(dtype)
    alpha = np.concatenate([2.0 + np.geomspace(float(fin.eps), 0.5, 40),
                            np.geomspace(3.0, 1e4, 40)])
    u = np.concatenate([np.geomspace(float(fin.tiny), 1e-6, 24),
                        np.geomspace(1e-6, 0.5, 24),
                        1.0 - np.geomspace(float(fin.epsneg), 0.5, 24)])
    a, u = (x.ravel().astype(dtype) for x in np.meshgrid(alpha, u))
    return a, u


@pytest.mark.parametrize("dtype, rel", [(np.float64, 1e-6),
                                        (np.float32, 1e-4)])
def test_tail_corners_match_jax(dtype, rel):
    """The tail's start and its NEWTON_STEPS steps against the JAX
    package's transform (its own start and 4 steps) over the tail's hard
    corners: α from just above 2 to 1e4 against u_tail from the smallest
    normal float to 1 − ulp; the excess d = z − α is ≥ 0 and finite."""
    alpha, u_tail = _tail_corners(dtype)
    u_body = np.full_like(u_tail, 0.5)
    want = np.asarray(jax_transform(jnp.asarray(alpha), jnp.asarray(u_body),
                                    jnp.asarray(u_tail)), np.float64)
    got = tn.transform_uniforms(torch.as_tensor(alpha),
                                torch.as_tensor(u_body),
                                torch.as_tensor(u_tail)).double().numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= rel, (err.max(), alpha[err.argmax()],
                              u_tail[err.argmax()])
    d = tn.tail_excess(torch.as_tensor(alpha),
                       torch.log(torch.as_tensor(u_tail)))
    assert torch.isfinite(d).all() and float(d.min()) >= 0.0


def test_tail_steps_converge_in_float64():
    """Two Newton steps from the start reach the root to ~1e-7 in float64
    over the corners, one does not (1e-4 near α = 2): the step count is
    the least that holds the JAX tolerance; three reach float64's
    rounding."""
    alpha, u_tail = (torch.as_tensor(x) for x in _tail_corners(np.float64))
    log_u = torch.log(u_tail)

    def rel_err(steps):
        saved = tn.NEWTON_STEPS
        tn.NEWTON_STEPS = steps
        try:
            z = alpha + tn.tail_excess(alpha, log_u)
        finally:
            tn.NEWTON_STEPS = saved
        return z

    root = rel_err(8)
    errs = [float(((rel_err(s) - root).abs() / root).max()) for s in (1, 2, 3)]
    assert errs[0] > 1e-5 and errs[1] < 1e-6 and errs[2] < 1e-12, errs
    assert tn.NEWTON_STEPS == 2



def test_trunc_normal_wrapper_dispatch():
    """``trunc_normal`` is the plain transform on CPU tensors (no launch)
    and takes CUDA tensors only otherwise: a tensor elsewhere raises before
    any build (the card's test is ``test_torch_resident.py::
    test_trunc_normal_kernel_matches_plain_on_card``)."""
    a = torch.linspace(-5.0, 50.0, 101)
    u = torch.linspace(0.01, 0.99, 101)
    n0 = tn.trunc_normal.launches
    assert torch.equal(tn.trunc_normal(a, u, u.flip(0)),
                       tn.transform_uniforms(a, u, u.flip(0)))
    assert tn.trunc_normal.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        tn.trunc_normal(a.to("meta"), u.to("meta"), u.to("meta"))
